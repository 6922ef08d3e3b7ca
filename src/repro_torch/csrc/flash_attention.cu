// Flash-attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/flash_attention.py:_flash_kernel (launched by flash_attention):
//   out = softmax(mask(softcap(q k^T * scale))) v
// with an online max and sum over k tiles, f32 accumulators and row
// statistics, and the result written in q's dtype.  The function is the
// JAX model's (models/attention.py _qchunk_attention): the scores in f32,
// c * tanh(s / c) when a softcap c is given, the mask, the softmax in f32
// and P rounded to q's type before P V.  (The JAX einsum also rounds the
// products q k^T to q's type before its f32 scale; the kernel keeps them
// in f32, as the oracle does: a second rounding of each score would let
// two f32 sums of another order round apart, one bf16 step of a score.)
//
// Layout: q (B,H,Sq,dh), k/v (B,KV,Sk,dh), o (B,H,Sq,dh), each given by its
// (batch, head, seq) strides with a unit stride on dh, so the caller may
// pass transposed views without a copy.  Query head h reads KV head
// h / (H / KV) (native GQA; KV == H is the Pallas kernel's case).
//
// Mask: the causal mask is bottom-right aligned like the oracle
// (kernels/ref.py attention_ref, tril(k = Sk - Sq)): key j is visible to
// query i iff j <= i + d, d = Sk - Sq; a sliding window w (gemma2's local
// layers) also requires j > i + d - w, the JAX model's _mask on absolute
// positions.  Non-causal attention (encoders, cross attention) masks
// nothing and has no window.  Masked scores are NEG_INF (-1e30), as in the
// oracle, so a fully masked row averages v uniformly there too; keys past
// Sk (the ragged tail of the last tile) are -inf and add nothing.  When
// every row of a q tile sees a key (i + d >= 0), the k tiles wholly above
// its diagonal and, under a window, wholly left of its band are skipped:
// their probabilities are exactly 0.  That skip is what makes a window
// cheap: a q tile reads about w / 64 + 2 k tiles, not all of them.
// Head dims 16, 32, 64, 80 (zamba2), 112 (kimi-k2), 128 and 256 (gemma2).
//
// Bound on an H100 at phi4-mini prefill shapes (B=1, H=24, KV=8, S=512,
// dh=128, bf16): q, k, v and o are 8.4 MB and the causal work 1.6 GFLOP,
// so the card's floor is the 2.5 us of memory traffic, not the 1.6 us of
// tensor-core math.  At 512 tokens what the kernel takes beyond that is
// latency: one q tile's chain of k tiles (8 at the last tile), each a
// product, a softmax step and a second product, plus the launch.  At
// gemma2's 5120 tokens (dh 256) the work is 0.2 ms of tensor-core math and
// the rate of the products is what counts.
//
// f16/bf16: flash_fwd_wgmma, FlashAttention-3's structure on Hopper's own
// instructions (hopper.cuh):
//  * TMA.  q, k and v are each read through a tensor map over (dh, seq,
//    heads, batch) with the view's own byte strides (encoded on the host
//    at each launch from the strides the entry point takes,
//    encode_operand), in boxes one swizzle span wide (16, 32 or 64
//    columns: 32-, 64- and 128-byte swizzles) that land in shared memory
//    in the layout wgmma reads.  TMA's zero fill
//    covers the ragged rows past Sq and Sk, and the columns past dh: dh 80
//    and 112 run as 128, two 64-column boxes whose columns past dh load as
//    zeros (1.6x and 1.14x the products' work, one code path, no mixed
//    swizzles; measured in PERF.md).
//  * A producer warp (warp 4) issues the loads: Q once, then K and V of
//    each k tile into a ring of three stages, each completed on its own
//    full mbarrier (K's and V's apart, so S can start before V lands) and
//    freed by the consumers' arrivals on its empty mbarrier once P V is
//    done.  (Two stages left each load's latency in every step; freeing
//    K's slot apart from V's, at S, moved no shape by more than 3 %.)
//  * One consumer warpgroup (warps 0-3) owns 64 query rows.  S = Q K^T is
//    wgmma m64nBNk16 with Q and K both K-major in shared memory; the online
//    max and sum run on the accumulators (a row's four lanes share a
//    quad); P is rounded to q's type in registers (as the JAX model rounds
//    its probabilities) and is the register A operand of O += P V, whose V
//    is the MN-major (transposed) B operand in shared memory.  Row
//    statistics and O stay in f32 registers.
//  * Overlap: S of tile t is issued together with P V of tile t - 1, and
//    t's softmax step runs while that P V is in flight; O is rescaled
//    after it completes (3-9 % faster than a softmax step that waits for
//    both; PERF.md).
//  * Masks are compiled in (Mode): CAUSAL (no window, no softcap: the
//    decoder families), FULL (non-causal, no softcap: encoders and cross
//    attention) and GENERAL (window and softcap as runtime fields: gemma2).
//    Per-score tests run only on the tiles that cross the ragged tail, the
//    diagonal or the window's left edge.
//  * Registers come from the launch bounds, so a block is 160 threads: two
//    blocks an SM at 168 registers a thread for dh <= 128 (ten warps,
//    three on one SM sub-partition's 16K registers), one at 255 for dh
//    256, whose O alone is 128 accumulators.  No instantiation spills.  A
//    producer warpgroup handing its registers to the consumers by
//    setmaxnreg (which works once the mbarrier wait has no trap; see
//    hopper.cuh) allows two consumer warpgroups of 232 registers sharing
//    each K/V tile with 128-key tiles: it measured within 3 % of this
//    design where it won and slower at B=4 and gemma2's 512 tokens, with
//    twice the build (PERF.md), so it is not used.
//  * Blocks take (batch, head, 64-row q tile) items from the heaviest
//    causal tile to the lightest, so the longest k chains start first; at
//    phi4's 512 tokens that is 192 items for 132 SMs, two blocks an SM.
//    (Packing a KV group's query heads into one block would load each K/V
//    tile once for g heads but leave phi4 64 items: fewer than the SMs.)
//
// f32: flash_fwd, the CUDA-core kernel of the first port (one block of 256
// threads per 64-row q tile, Q, K and V staged as f32 in shared memory,
// f32 FMA); TF32 products would not hold f32's 2e-5 tolerance.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"
#include "mma_sm80.cuh"

namespace {

constexpr int BQ = 64;                 // f32: query rows per block
constexpr int BK = 64;                 // f32: key rows per tile
constexpr int NT = 256;                // threads per block
constexpr int WARPS = NT / 32;
constexpr int ROWS = BQ / WARPS;       // query rows per warp (softmax, PV)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

static_assert(BK == 64, "the softmax step gives each lane two columns");
static_assert(BQ == 64 && NT == 256, "S micro-tiles are 4x4 on a 16x16 grid");

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KV, Sq, Sk, dh;
  long long qs[3], ks[3], vs[3], os[3];  // (batch, head, seq) strides
  // score in log2 units: x = s * qk_scale, then x = cap_log2 * tanh(x)
  // when cap_log2 > 0 (softcap c: qk_scale = scale / c, cap_log2 =
  // c log2(e); none: qk_scale = scale log2(e))
  float qk_scale, cap_log2;
  int causal;
  int window;                             // 0: none; only when causal
};

__device__ __forceinline__ float score_log2(float s, const Args& a) {
  const float x = s * a.qk_scale;
  return a.cap_log2 > 0.f ? a.cap_log2 * tanhf(x) : x;
}

// Whether causal masking hides key j from query i (d = Sk - Sq).
__device__ __forceinline__ bool hidden(bool causal, int window, int i, int j,
                                       int d) {
  return causal && (j > i + d || (window > 0 && j <= i + d - window));
}

// The k tiles [first, end) a q tile of `rows` rows from q0 must read: when
// every one of its rows sees a key, the tiles above its diagonal and left
// of its window band are skipped; otherwise a fully masked row must still
// average all of v.
__device__ __forceinline__ void k_tiles(int Sq, int Sk, bool causal,
                                        int window, int q0, int rows,
                                        int tile, int& first, int& end) {
  const int d = Sk - Sq;
  int lo = 0, hi = Sk;
  if (causal && q0 + d >= 0) {
    hi = min(Sk, q0 + rows + d);
    if (window > 0) lo = max(0, q0 + d - window + 1);
  }
  first = lo / tile;
  end = (hi + tile - 1) / tile;
}

// ---------------------------------------------------------------- f32,
// CUDA cores (the first port's kernel).  256 threads: for S = Q K^T each
// thread owns a 4x4 micro-tile; for the softmax and for P V each warp owns
// 8 query rows, and lane owns the output columns lane + 32 c.  Scores are
// taken to log2 units (score_log2), and exp2 replaces exp.  At dh 256 the
// staging is 209 KB of the 227 KB a block may opt into.

template <int DH>
constexpr int smem_floats() {
  return BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1);
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) flash_fwd(Args a) {
  extern __shared__ float smem[];
  constexpr int QP = DH + 1;            // padded rows: no bank conflicts
  constexpr int SP = BK + 1;
  constexpr int NC = (DH + 31) / 32;    // output columns per lane
  float* sQ = smem;                     // [BQ][QP]
  float* sK = sQ + BQ * QP;             // [BK][QP]
  float* sV = sK + BK * QP;             // [BK][DH]
  float* sS = sV + BK * DH;             // [BQ][SP] scores, then probabilities

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const T* qp = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T* kp = static_cast<const T*>(a.k) + b * a.ks[0] + kvh * a.ks[1];
  const T* vp = static_cast<const T*>(a.v) + b * a.vs[0] + kvh * a.vs[1];
  T* op = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[1];
  const int diag = a.Sk - a.Sq;         // j visible to i iff j <= i + diag

  for (int idx = tid; idx < BQ * DH; idx += NT) {
    const int r = idx / DH, d = idx % DH, i = q0 + r;
    sQ[r * QP + d] = i < a.Sq ? to_f(qp[i * a.qs[2] + d]) : 0.f;
  }

  int t_first, t_end;
  k_tiles(a.Sq, a.Sk, a.causal, a.window, q0, BQ, BK, t_first, t_end);

  const int r0 = warp * ROWS;           // this warp's rows (softmax, PV)
  const int tr = tid >> 4, tc = tid & 15;   // S micro-tile coordinates
  float m[ROWS], l[ROWS], acc[ROWS][NC];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[rr][c] = 0.f;
  }

  for (int t = t_first; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();                    // last tile's sK/sV/sS reads done
    for (int idx = tid; idx < BK * DH; idx += NT) {
      const int r = idx / DH, d = idx % DH, j = k0 + r;
      const bool in = j < a.Sk;
      sK[r * QP + d] = in ? to_f(kp[j * a.ks[2] + d]) : 0.f;
      sV[r * DH + d] = in ? to_f(vp[j * a.vs[2] + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = sQ[(tr * 4 + r) * QP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = sK[(tc + 16 * c) * QP + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + tr * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tc + 16 * c;
        float x = score_log2(s[r][c], a);
        if (j >= a.Sk)
          x = -INFINITY;
        else if (hidden(a.causal, a.window, i, j, diag))
          x = NEG_INF;
        sS[(tr * 4 + r) * SP + tc + 16 * c] = x;
      }
    }
    __syncthreads();

    // Online softmax over this tile; each lane owns columns lane, lane+32.
    float alpha[ROWS];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      float* row = sS + (r0 + rr) * SP;
      const float x0 = row[lane], x1 = row[lane + 32];
      const float m_new = fmaxf(m[rr], warp_max(fmaxf(x0, x1)));
      alpha[rr] = exp2f(m[rr] - m_new);
      const float p0 = exp2f(x0 - m_new), p1 = exp2f(x1 - m_new);
      l[rr] = l[rr] * alpha[rr] + warp_sum(p0 + p1);
      m[rr] = m_new;
      row[lane] = p0;
      row[lane + 32] = p1;
    }
    __syncwarp();

    // acc = alpha * acc + P V over this warp's rows.
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[rr][c] *= alpha[rr];
    for (int j = 0; j < BK; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < DH ? sV[j * DH + d] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const float p = sS[(r0 + rr) * SP + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[rr][c] = fmaf(p, vv[c], acc[rr][c]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int i = q0 + r0 + rr;
    if (i >= a.Sq) continue;
    const float den = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < DH) op[i * a.os[2] + d] = from_f<T>(acc[rr][c] / den);
    }
  }
}

// ---------------------------------------------------------------- f16/bf16,
// Hopper: TMA, wgmma and a warp-specialized pipeline

// What a block masks, compiled in: CAUSAL (no window, no softcap: the
// decoder families), FULL (non-causal, no softcap: encoders and cross
// attention) and GENERAL (the window and the softcap as runtime fields,
// causal or not: gemma2).
enum Mode { CAUSAL = 0, FULL = 1, GENERAL = 2 };

// The tiles of a padded head dim DHP (dh 80 and 112 run as 128, their
// columns past dh zero-filled by TMA): column blocks one swizzle span wide
// (16, 32 or 64 elements), one consumer warpgroup of 64 query rows (warps
// 0-3) and a producer warp (warp 4), K/V tiles of BN keys (128 at dh 16,
// 32 and 64; 64 from padded dh 128 on, where 128 keys would not leave
// two blocks' three stages in an SM's shared memory) in STAGES stages
// (three: with two, the load of tile t + 1 could start only when tile
// t - 1 was released, at the end of step t, and its latency showed in
// every step).  Registers come from the launch bounds: two blocks an
// SM (ten warps, three on one SM sub-partition's 16K registers) give a
// thread 168; at dh 256 one block an SM gives 255, which O's 128
// accumulators need (its shared memory allows one anyway).
template <int DHP>
struct Tiles {
  static constexpr int SPAN = DHP < 64 ? DHP : 64;
  static constexpr int CB = DHP / SPAN;
  static constexpr int BN = DHP < 128 ? 128 : 64;
  static constexpr int STAGES = 3;
  static constexpr int ROWS = 64;                 // query rows a block
  static constexpr int THREADS = 160;
  static constexpr int MIN_BLOCKS = DHP < 256 ? 2 : 1;
  static constexpr int Q_BYTES = ROWS * DHP * 2;
  static constexpr int KV_BYTES = BN * DHP * 2;   // one K or V tile
  static constexpr int TILE_BYTES = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int BAR_BYTES = 8 * (1 + 3 * STAGES);
  // the tiles from the first 1024-byte boundary, the barriers before it
  // when they fit there and after the tiles when not: 1024 bytes of slack
  // cover both (at dh 128 two blocks of three stages fill an SM's 228 KB)
  static constexpr int SMEM = 1024 + TILE_BYTES;
  static_assert(BAR_BYTES <= 512, "barriers fit the slack");
  static_assert(BN == 64 || BN == 128, "the wgmma_ss widths");
};

// A thread's scores in log2 units (softcapped with CAP); with EDGE, keys
// past Sk are -inf and hidden keys NEG_INF.  mx: the row maxima.
template <int MODE, bool EDGE, bool CAP, int N>
__device__ __forceinline__ void scores_log2(float (&sc)[N], const Args& a,
                                            bool causal, int window, int k0,
                                            int i0, int qd, float (&mx)[2]) {
  const int diag = a.Sk - a.Sq;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float x = sc[4 * j + r] * a.qk_scale;
      if (CAP) x = a.cap_log2 * tanhf(x);
      if (EDGE) {
        const int key = k0 + 8 * j + 2 * qd + (r & 1);
        if (key >= a.Sk)
          x = -INFINITY;
        else if (MODE != FULL &&
                 hidden(causal, window, i0 + (r >> 1) * 8, key, diag))
          x = NEG_INF;
      }
      sc[4 * j + r] = x;
      mx[r >> 1] = fmaxf(mx[r >> 1], x);
    }
  }
}

// One k tile's online-softmax step for a consumer warpgroup's 64 rows
// (from qc; this thread's rows i0 and i0 + 8): the scores to log2 units,
// masked only on a tile that crosses an edge (the ragged tail, the
// diagonal or the window's left edge), the running max and sum updated;
// sc becomes P in f32 (l sums it unrounded).  alpha: the factor that
// rescales the rows' earlier output.
template <int MODE, int N>
__device__ __forceinline__ void softmax_step(float (&sc)[N], const Args& a,
                                             bool causal, int window, int k0,
                                             int qc, int i0, int qd,
                                             float (&m_row)[2],
                                             float (&l_row)[2],
                                             float (&alpha)[2]) {
  const int diag = a.Sk - a.Sq, keys = 2 * N;
  bool edge = k0 + keys > a.Sk;
  if (MODE != FULL)
    edge = edge || (causal && (k0 + keys - 1 > qc + diag ||
                               (window > 0 && k0 <= qc + 63 + diag - window)));
  float mx[2] = {-INFINITY, -INFINITY};
  // uniform branches, each to a loop without per-score tests
  if (MODE == GENERAL && a.cap_log2 > 0.f) {
    if (edge)
      scores_log2<MODE, true, true>(sc, a, causal, window, k0, i0, qd, mx);
    else
      scores_log2<MODE, false, true>(sc, a, causal, window, k0, i0, qd, mx);
  } else {
    if (edge)
      scores_log2<MODE, true, false>(sc, a, causal, window, k0, i0, qd, mx);
    else
      scores_log2<MODE, false, false>(sc, a, causal, window, k0, i0, qd, mx);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {     // a row's four lanes share a quad
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    const float m_new = fmaxf(m_row[hh], mx[hh]);
    alpha[hh] = exp2f(m_row[hh] - m_new);
    m_row[hh] = m_new;
    l_row[hh] *= alpha[hh];
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float p = exp2f(sc[n] - m_row[(n >> 1) & 1]);
    l_row[(n >> 1) & 1] += p;
    sc[n] = p;
  }
}

// P rounded to q's type as the A operand of P V: the n8 blocks 2 kk and
// 2 kk + 1 of S are k16 step kk.
template <typename T, int N>
__device__ __forceinline__ void pack_p(const float (&p)[N],
                                       uint32_t (&pa)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[kk][e] = tc::pack2<T>(p[8 * kk + 2 * e], p[8 * kk + 2 * e + 1]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) o[n] *= alpha[(n >> 1) & 1];
}

// Issues (and commits) S = Q K^T over the K tile in stage s: Q and K both
// K-major in shared memory, one k16 step a wgmma.
template <typename T, int DHP>
__device__ __forceinline__ void issue_qk(float (&sc)[Tiles<DHP>::BN / 2],
                                         uint64_t dq, uint64_t dk, int s) {
  using C = Tiles<DHP>;
#pragma unroll
  for (int kb = 0; kb < DHP / 16; ++kb) {
    const int cb = kb * 16 / C::SPAN, kin = kb * 16 % C::SPAN;
    hopper::wgmma_ss<T, C::BN, 0>(
        sc, dq + ((cb * C::ROWS * C::SPAN + kin) * 2 >> 4),
        dk + ((s * C::BN * DHP + cb * C::BN * C::SPAN + kin) * 2 >> 4),
        kb > 0);
  }
  hopper::wgmma_commit();
}

// Issues (and commits) O += P V over the V tile in stage s: P from
// registers, V MN-major in shared memory (trans-b), n = DHP.
template <typename T, int DHP>
__device__ __forceinline__ void issue_pv(
    float (&o)[DHP / 2], const uint32_t (&pa)[Tiles<DHP>::BN / 16][4],
    uint64_t dv, int s) {
  using C = Tiles<DHP>;
#pragma unroll
  for (int kk = 0; kk < C::BN / 16; ++kk)
    hopper::wgmma_rs<T, DHP, 1>(
        o, pa[kk], dv + ((s * C::BN * DHP + kk * 16 * C::SPAN) * 2 >> 4), 1);
  hopper::wgmma_commit();
}

template <typename T, int DHP, int MODE>
__global__ void __launch_bounds__(Tiles<DHP>::THREADS, Tiles<DHP>::MIN_BLOCKS)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Args a,
                    int q_tiles, int first_wave) {
  using C = Tiles<DHP>;
  constexpr int SPAN = C::SPAN, CB = C::CB, BN = C::BN, ST = C::STAGES;
  constexpr int ROWS = C::ROWS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // column blocks start on 1024 bytes (the 128-byte swizzle's period)
  const uint32_t pad = (1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023;
  T* sQ = reinterpret_cast<T*>(smem_raw + pad);   // [CB][ROWS][SPAN]
  T* sK = sQ + ROWS * DHP;                  // [ST][CB][BN][SPAN]
  T* sV = sK + ST * BN * DHP;               // [ST][CB][BN][SPAN]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      pad >= C::BAR_BYTES ? smem_raw : smem_raw + pad + C::TILE_BYTES);
  uint64_t* k_full = q_full + 1;            // [ST]
  uint64_t* v_full = k_full + ST;           // [ST]
  uint64_t* empty = v_full + ST;            // [ST]

  // Blocks take (batch, head, q tile) items from the heaviest (the last q
  // tile of every head) to the lightest; the blocks past the first wave
  // take the lightest first, so an SM's second block pairs light with
  // heavy.
  int item = blockIdx.x;
  if (item >= first_wave) item = gridDim.x - 1 - (item - first_wave);
  const int BH = a.B * a.H;
  const int h = item % a.H, b = (item / a.H) % a.B;
  const int q0 = (q_tiles - 1 - item / BH) * ROWS;
  const int kvh = h / (a.H / a.KV);
  const bool causal = MODE == CAUSAL || (MODE == GENERAL && a.causal);
  const int window = MODE == GENERAL ? a.window : 0;
  int t_first, t_end;                       // the k tiles it reads
  k_tiles(a.Sq, a.Sk, causal, window, q0, ROWS, BN, t_first, t_end);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(k_full + s, 1);
      hopper::mbar_init(v_full + s, 1);
      hopper::mbar_init(empty + s, 4);       // each consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // a tile's stage and the parity of its fill
  auto stage = [&](int t) { return (t - t_first) % ST; };
  auto parity = [&](int t) {
    return static_cast<uint32_t>(((t - t_first) / ST) & 1);
  };

  // the warp, broadcast from lane 0 so the compiler sees it uniform
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x & 31;
  if (warp == 4) {
    // Producer warp: one thread keeps TMA loads of the K and V tiles in
    // flight, STAGES ahead of the consumers.
    if (lane == 0) {
      hopper::prefetch_map(&tq);
      hopper::prefetch_map(&tk);
      hopper::prefetch_map(&tv);
      hopper::mbar_arrive_expect_tx(q_full, C::Q_BYTES);
      for (int cb = 0; cb < CB; ++cb)
        hopper::tma_load(sQ + cb * ROWS * SPAN, &tq, q_full, cb * SPAN, q0,
                         h, b);
      for (int t = t_first; t < t_end; ++t) {
        const int s = stage(t);
        hopper::mbar_wait(empty + s, parity(t) ^ 1);
        hopper::mbar_arrive_expect_tx(k_full + s, C::KV_BYTES);
        for (int cb = 0; cb < CB; ++cb)
          hopper::tma_load(sK + (s * CB + cb) * BN * SPAN, &tk, k_full + s,
                           cb * SPAN, t * BN, kvh, b);
        hopper::mbar_arrive_expect_tx(v_full + s, C::KV_BYTES);
        for (int cb = 0; cb < CB; ++cb)
          hopper::tma_load(sV + (s * CB + cb) * BN * SPAN, &tv, v_full + s,
                           cb * SPAN, t * BN, kvh, b);
      }
    }
    return;
  }

  // The consumer warpgroup: query rows q0 .. q0 + 63, this thread's i0 and
  // i0 + 8.
  const int qd = lane & 3;
  const int i0 = q0 + 16 * warp + (lane >> 2);
  auto release = [&](int t) {         // this warp is done with tile t
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + stage(t));
  };
  constexpr uint32_t SBO = 8 * SPAN * 2;        // 8 rows of one span
  const uint64_t dq = hopper::smem_desc(sQ, 0, SBO, SPAN * 2);
  const uint64_t dk = hopper::smem_desc(sK, 0, SBO, SPAN * 2);
  const uint64_t dv = hopper::smem_desc(sV, BN * SPAN * 2, SBO, SPAN * 2);
  float o[DHP / 2];
#pragma unroll
  for (int n = 0; n < DHP / 2; ++n) o[n] = 0.f;
  float m_row[2] = {NEG_INF, NEG_INF}, l_row[2] = {0.f, 0.f}, alpha[2];
  uint32_t pa[BN / 16][4];
  hopper::mbar_wait(q_full, 0);

  {   // the first tile: S, its softmax step, P (O is still 0)
    float sc[BN / 2];
    hopper::mbar_wait(k_full + stage(t_first), parity(t_first));
    __syncwarp();
    hopper::wgmma_fence();
    issue_qk<T, DHP>(sc, dq, dk, stage(t_first));
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    softmax_step<MODE>(sc, a, causal, window, t_first * BN, q0, i0, qd,
                       m_row, l_row, alpha);
    pack_p<T>(sc, pa);
  }
  // Each later tile: S of tile t is issued beside P V of tile t - 1, and
  // t's softmax step runs while that P V does (FlashAttention-3's overlap
  // within a warpgroup); O is rescaled once P V is done.
  for (int t = t_first + 1; t < t_end; ++t) {
    float sc[BN / 2];
    hopper::mbar_wait(k_full + stage(t), parity(t));
    hopper::mbar_wait(v_full + stage(t - 1), parity(t - 1));
    __syncwarp();
    hopper::wgmma_fence();
    issue_qk<T, DHP>(sc, dq, dk, stage(t));
    issue_pv<T, DHP>(o, pa, dv, stage(t - 1));
    hopper::wgmma_wait<1>();                      // S of tile t
    hopper::fence_regs(sc);
    softmax_step<MODE>(sc, a, causal, window, t * BN, q0, i0, qd, m_row,
                       l_row, alpha);
    hopper::wgmma_wait<0>();                      // P V of tile t - 1
    hopper::fence_regs(o);
    release(t - 1);
    rescale(o, alpha);
    pack_p<T>(sc, pa);
  }
  hopper::mbar_wait(v_full + stage(t_end - 1), parity(t_end - 1));
  __syncwarp();
  hopper::wgmma_fence();
  issue_pv<T, DHP>(o, pa, dv, stage(t_end - 1));
  hopper::wgmma_wait<0>();
  hopper::fence_regs(o);

  T* op = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[1];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_row[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float den = fmaxf(l, 1e-30f);
    const int i = i0 + hh * 8;
    if (i >= a.Sq) continue;
    T* row = op + i * a.os[2];
#pragma unroll
    for (int n = 0; n < DHP / 8; ++n)
      if (8 * n < a.dh)
        *reinterpret_cast<uint32_t*>(row + 8 * n + 2 * qd) = tc::pack2<T>(
            o[4 * n + 2 * hh] / den, o[4 * n + 2 * hh + 1] / den);
  }
}

// The tensor map of q, k or v: dims (dh, seq, heads, batch), innermost
// first, with the view's own byte strides of seq, heads and batch (element
// strides st: batch, head, seq).  An axis of size 1 is never stepped, so
// it takes a row's bytes whatever the view says.  A stride TMA cannot
// take (not a positive multiple of 16 bytes below 2^40) is refused;
// kernels/flash_attention.py tensor_map_geometry computes the same and
// names it.
inline cudaError_t encode_operand(CUtensorMap* map, bool bf16,
                                  const void* ptr, int dh, int seq,
                                  int heads, int B, const long long* st,
                                  const uint32_t* box) {
  const uint64_t dims[4] = {static_cast<uint64_t>(dh),
                            static_cast<uint64_t>(seq),
                            static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(B)};
  const long long steps[3] = {st[2], st[1], st[0]};
  uint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    const long long bytes = steps[i] * 2;
    if (dims[i + 1] == 1)
      strides[i] = 2ull * dh;
    else if (bytes <= 0 || bytes % 16 || bytes >= (1ll << 40))
      return cudaErrorInvalidValue;
    else
      strides[i] = static_cast<uint64_t>(bytes);
  }
  return hopper::encode_map16(map, bf16, 4, ptr, dims, strides, box);
}

template <typename T, int DHP, int MODE>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  using C = Tiles<DHP>;
  auto kernel = flash_fwd_wgmma<T, DHP, MODE>;
  static unsigned long long smem_set = 0;
  cudaError_t e = tc::allow_smem(kernel, C::SMEM, smem_set);
  if (e != cudaSuccess) return e;
  const bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  const uint32_t q_box[4] = {C::SPAN, C::ROWS, 1, 1};
  const uint32_t kv_box[4] = {C::SPAN, C::BN, 1, 1};
  CUtensorMap maps[3];
  e = encode_operand(&maps[0], bf16, a.q, a.dh, a.Sq, a.H, a.B, a.qs, q_box);
  if (e == cudaSuccess)
    e = encode_operand(&maps[1], bf16, a.k, a.dh, a.Sk, a.KV, a.B, a.ks,
                       kv_box);
  if (e == cudaSuccess)
    e = encode_operand(&maps[2], bf16, a.v, a.dh, a.Sk, a.KV, a.B, a.vs,
                       kv_box);
  if (e != cudaSuccess) return e;
  int sms = 0;
  e = tc::sm_count(&sms);
  if (e != cudaSuccess) return e;
  const int q_tiles = (a.Sq + C::ROWS - 1) / C::ROWS;
  const long long blocks = (long long)q_tiles * a.B * a.H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), C::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], a, q_tiles, sms);
  return cudaGetLastError();
}

template <typename T, int DHP>
cudaError_t launch_mode(const Args& a, cudaStream_t stream) {
  if (a.cap_log2 == 0.f && a.window == 0)
    return a.causal ? launch_wgmma<T, DHP, CAUSAL>(a, stream)
                    : launch_wgmma<T, DHP, FULL>(a, stream);
  return launch_wgmma<T, DHP, GENERAL>(a, stream);
}

template <typename T>
cudaError_t launch_wgmma_dh(const Args& a, cudaStream_t stream) {
  switch (a.dh) {
    case 16: return launch_mode<T, 16>(a, stream);
    case 32: return launch_mode<T, 32>(a, stream);
    case 64: return launch_mode<T, 64>(a, stream);
    case 80:                                   // zamba2's shared attention
    case 112:                                  // kimi-k2
    case 128: return launch_mode<T, 128>(a, stream);
    case 256: return launch_mode<T, 256>(a, stream);   // gemma2
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- f32
// launch

template <typename T, int DH>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int smem = smem_floats<DH>() * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, B);
  flash_fwd<T, DH><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const Args& a, int B, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16>(a, B, stream);
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 80: return launch<T, 80>(a, B, stream);    // zamba2's shared attention
    case 112: return launch<T, 112>(a, B, stream);  // kimi-k2
    case 128: return launch<T, 128>(a, B, stream);
    case 256: return launch<T, 256>(a, B, stream);    // 209 KB of staging
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (q, k, v and o alike).
// strides: 12 element strides, (batch, head, seq) of q, k, v, then o.
// window: 0 for none, else the sliding window (used only when causal);
// softcap: 0 for none, else c > 0.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int dtype,
                                         int B, int H, int KV, int Sq, int Sk,
                                         int dh, const long long* strides,
                                         float scale, int causal, int window,
                                         float softcap, void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1 || window < 0 ||
      !(softcap >= 0.f))
    return cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.Sq = Sq;
  a.Sk = Sk;
  a.dh = dh;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.qk_scale = softcap > 0.f ? scale / softcap : scale * LOG2E;
  a.cap_log2 = softcap > 0.f ? softcap * LOG2E : 0.f;
  a.causal = causal;
  a.window = causal ? window : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dh<float>(a, B, dh, s);
  if (dtype != 1 && dtype != 2) return cudaErrorInvalidValue;
  return dtype == 1 ? launch_wgmma_dh<__half>(a, s)
                    : launch_wgmma_dh<__nv_bfloat16>(a, s);
}
