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
// (batch, head, seq) strides in elements with a unit stride on dh, so the
// caller may pass transposed views without a copy.  Query head h reads KV
// head h / (H / KV) (native GQA; KV == H is the Pallas kernel's case).  For
// f16/bf16 the base pointers and strides must be 16-byte aligned (the
// wrapper checks): every copy is 16 bytes.
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
// Head dims 16, 32, 64, 80 (zamba2), 112 (kimi-k2), 128 and 256 (gemma2)
// are instantiated.
//
// Bound on an H100 at phi4-mini prefill shapes (B=1, H=24, KV=8, S=512,
// dh=128, bf16): q, k, v and o are 8.4 MB and the causal work 1.6 GFLOP,
// so the card's floor is the 2.5 us of memory traffic, not the 1.6 us of
// tensor-core math; a kernel near it keeps scores out of device memory,
// reads k and v once per q tile from L2 and keeps the tensor cores fed.
//
// f16/bf16: flash_fwd_mma, FlashAttention-2 style.  One block of 4 warps
// owns one (batch, head, 64-row q tile); each warp owns 16 query rows, and
// its Q fragments are loaded once and held in registers over the k loop.
// K and V tiles of 64 keys (32 at dh 256) are double-buffered in shared
// memory by 16-byte cp.async copies (rows padded by 16 bytes, so ldmatrix
// hits all 32 banks; rows past Sq and Sk are zero-filled), the next tile
// in flight while this one is multiplied.  S = Q K^T is mma.sync m16n8k16
// with f32 accumulators (K fragments through ldmatrix); the online max and
// sum run on the accumulator fragments, with two quad shuffles for a row's
// max and one reduction of its sum at the end; P is rounded to q's type in
// registers (as the JAX model rounds its probabilities to v's dtype before
// P V) and fed straight back as the A operand of P V, whose V fragments
// come through ldmatrix.trans.  dh 80 is five k16 steps, dh 112 seven
// (seven n16 pairs of P V): 14 16-byte chunks a row, 7 a thread for a
// 64-row tile; the padded row is 120 elements (240 bytes, 60 words), so the
// eight rows an ldmatrix reads start on words 0, 28, 24, ..., 4 mod 32 and
// hit all 32 banks once; Q and two K/V stages take 77 KB.  Q and two K/V
// stages take 87 KB of shared memory at dh 128 (two blocks an SM).  The
// grid walks the q tiles from the last, so the causal tiles with the most
// k tiles start first, one an SM; the blocks past the first SM-count take
// the lightest tiles first, so an SM's second block pairs light with
// heavy.  At phi4's prefill shape this is about 9x the byte
// bound and 1.7x PyTorch's SDPA (PERF.md); wgmma with TMA and warp
// specialization (FlashAttention-3's design) is the next step.
// dh 256 (gemma2): a warp's O accumulator alone is 128 f32 registers a
// thread, so Q is not held in registers there but reloaded from shared
// memory by ldmatrix for each k tile (64 registers fewer, one ldmatrix
// more per k16 step), and the K/V tiles hold 32 keys (an S tile of 16
// registers instead of 32): Q and two K/V stages take 99 KB, two blocks
// an SM.
//
// f32: flash_fwd, the CUDA-core kernel of the first port (one block of 256
// threads per 64-row q tile, Q, K and V staged as f32 in shared memory,
// f32 FMA); TF32 products would not hold f32's 2e-5 tolerance.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

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
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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
  int B, H, KV, Sq, Sk;
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
__device__ __forceinline__ bool hidden(const Args& a, int i, int j, int d) {
  return a.causal && (j > i + d || (a.window > 0 && j <= i + d - a.window));
}

// The k tiles [first, end) a q tile of `rows` rows from q0 must read: when
// every one of its rows sees a key, the tiles above its diagonal and left
// of its window band are skipped; otherwise a fully masked row must still
// average all of v.
__device__ __forceinline__ void k_tiles(const Args& a, int q0, int rows,
                                        int tile, int& first, int& end) {
  const int d = a.Sk - a.Sq;
  int lo = 0, hi = a.Sk;
  if (a.causal && q0 + d >= 0) {
    hi = min(a.Sk, q0 + rows + d);
    if (a.window > 0) lo = max(0, q0 + d - a.window + 1);
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
  k_tiles(a, q0, BQ, BK, t_first, t_end);

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
        else if (hidden(a, i, j, diag))
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
// tensor cores

constexpr int MQ = 64;                 // query rows per block, 16 a warp
constexpr int MNT = 128;               // 4 warps
// Keys per tile: 64, and 32 at dh 256, where a warp's O accumulator is
// already 128 registers a thread: the smaller S tile keeps it from
// spilling, and Q plus two K/V stages (99 KB) let two blocks share an SM.
#define KEYS_PER_TILE(DH) ((DH) > 128 ? 32 : 64)

template <int DH>
constexpr int mma_smem_bytes() {       // Q, then K and V in two stages
  return (MQ + 4 * KEYS_PER_TILE(DH)) * (DH + 8) * 2;
}

// Copies rows [row0, row0 + ROWS) of a (rows, DH) matrix with row stride
// `stride` into a padded tile, zero from row `limit` on.
template <typename T, int DH, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long stride, int row0,
                                          int limit, int tid) {
  constexpr int CH = DH / 8;           // 16-byte chunks a row
  static_assert(ROWS * CH % MNT == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * CH / MNT; ++i) {
    const int c = tid + i * MNT;
    const int r = c / CH, col = (c % CH) * 8;
    const bool in = row0 + r < limit;
    tc::cp_async16(dst + r * (DH + 8) + col,
                   in ? src + (row0 + r) * stride + col : src, in ? 16 : 0);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(MNT) flash_fwd_mma(Args a, int q_tiles,
                                                     int first_wave) {
  constexpr int LD = DH + 8;           // padded row, elements
  constexpr int KS = DH / 16;          // k16 steps of Q K^T, n16 pairs of P V
  constexpr int MK = KEYS_PER_TILE(DH);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);   // [MQ][LD]
  T* sK = sQ + MQ * LD;                     // [2][MK][LD]
  T* sV = sK + 2 * MK * LD;                 // [2][MK][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // Work items run from the heaviest (the last q tile of every head) to
  // the lightest.  The first block an SM takes the heaviest ones; the
  // blocks after them take the lightest first, so an SM that holds two
  // blocks pairs a heavy item with a light one.
  int item = blockIdx.x;
  if (item >= first_wave)
    item = gridDim.x - 1 - (item - first_wave);
  const int BH = a.B * a.H;
  const int h = item % a.H, b = (item / a.H) % a.B;
  const int q0 = (q_tiles - 1 - item / BH) * MQ;
  const int kvh = h / (a.H / a.KV);
  const T* qp = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T* kp = static_cast<const T*>(a.k) + b * a.ks[0] + kvh * a.ks[1];
  const T* vp = static_cast<const T*>(a.v) + b * a.vs[0] + kvh * a.vs[1];
  T* op = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[1];
  const int diag = a.Sk - a.Sq;         // j visible to i iff j <= i + diag

  int t_first, t_end;
  k_tiles(a, q0, MQ, MK, t_first, t_end);

  load_rows<T, DH, MQ>(sQ, qp, a.qs[2], q0, a.Sq, tid);
  tc::cp_async_commit();
  load_rows<T, DH, MK>(sK, kp, a.ks[2], t_first * MK, a.Sk, tid);
  load_rows<T, DH, MK>(sV, vp, a.vs[2], t_first * MK, a.Sk, tid);
  tc::cp_async_commit();

  // ldmatrix lane offsets.  A fragments (Q) and V (transposed): rows
  // (l % 8) + 8 ((l / 8) % 2), columns 8 (l / 16).  K: keys (l % 8) +
  // 8 (l / 16), columns 8 ((l / 8) % 2).
  const int ar = (lane & 7) + ((lane >> 3) & 1) * 8, ac = (lane >> 4) * 8;
  const int kr = (lane & 7) + (lane >> 4) * 8, kc = ((lane >> 3) & 1) * 8;
  const int g = lane >> 2, qd = lane & 3;
  const int i0 = q0 + warp * 16 + g;    // this lane's rows: i0 and i0 + 8

  // Q fragments, held in registers over the whole k loop up to dh 128
  constexpr bool QREG = DH <= 128;     // dh 256: O alone is 128 registers
  tc::cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[QREG ? KS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      tc::ldmatrix_x4(qf[ks], sQ + (warp * 16 + ar) * LD + ks * 16 + ac);
  }

  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[n][r] = 0.f;
  float m_row[2] = {NEG_INF, NEG_INF}, l_row[2] = {0.f, 0.f};

  for (int t = t_first; t < t_end; ++t) {
    const int buf = (t - t_first) & 1;
    if (t + 1 < t_end) {
      load_rows<T, DH, MK>(sK + (buf ^ 1) * MK * LD, kp, a.ks[2],
                           (t + 1) * MK, a.Sk, tid);
      load_rows<T, DH, MK>(sV + (buf ^ 1) * MK * LD, vp, a.vs[2],
                           (t + 1) * MK, a.Sk, tid);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();                    // tile t landed
    const T* kb = sK + buf * MK * LD;
    const T* vb = sV + buf * MK * LD;

    float s[MK / 8][4];
#pragma unroll
    for (int j = 0; j < MK / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qk[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qk[e] = qf[ks][e];
      } else {
        tc::ldmatrix_x4(qk, sQ + (warp * 16 + ar) * LD + ks * 16 + ac);
      }
#pragma unroll
      for (int np = 0; np < MK / 16; ++np) {
        uint32_t bk[4];
        tc::ldmatrix_x4(bk, kb + (np * 16 + kr) * LD + ks * 16 + kc);
        tc::mma16816<T>(s[2 * np], qk, bk[0], bk[1]);
        tc::mma16816<T>(s[2 * np + 1], qk, bk[2], bk[3]);
      }
    }

    // Scores in log2 units (softcapped); mask only the tiles that cross an
    // edge: the ragged tail, the diagonal or the window's left edge.
    const int k0 = t * MK;
    const bool edge =
        k0 + MK > a.Sk ||
        (a.causal && (k0 + MK - 1 > q0 + diag ||
                      (a.window > 0 && k0 <= q0 + MQ - 1 + diag - a.window)));
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < MK / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = score_log2(s[j][r], a);
        if (edge) {
          const int key = k0 + j * 8 + 2 * qd + (r & 1);
          if (key >= a.Sk)
            x = -INFINITY;
          else if (hidden(a, i0 + (r >> 1) * 8, key, diag))
            x = NEG_INF;
        }
        s[j][r] = x;
        mx[r >> 1] = fmaxf(mx[r >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {   // a row's four lanes share a quad
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m_row[hh], mx[hh]);
      alpha[hh] = exp2f(m_row[hh] - m_new);
      m_row[hh] = m_new;
      l_row[hh] *= alpha[hh];
    }
#pragma unroll
    for (int j = 0; j < MK / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = exp2f(s[j][r] - m_row[r >> 1]);
        s[j][r] = p;
        l_row[r >> 1] += p;             // this lane's part, in f32
      }
    }
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: two n8 tiles of S are one k16 A fragment of P.
#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
      const uint32_t pa[4] = {tc::pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                              tc::pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                              tc::pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              tc::pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        uint32_t bv[4];
        tc::ldmatrix_x4_trans(bv, vb + (kk * 16 + ar) * LD + dp * 16 + ac);
        tc::mma16816<T>(o[2 * dp], pa, bv[0], bv[1]);
        tc::mma16816<T>(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();                    // buffer buf is free for tile t + 2
  }
  tc::cp_async_wait<0>();

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
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * qd) =
          tc::pack2<T>(o[n][2 * hh] / den, o[n][2 * hh + 1] / den);
  }
}

template <typename T, int DH>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<DH>();
  static unsigned long long smem_set = 0;
  const cudaError_t e = tc::allow_smem(flash_fwd_mma<T, DH>, smem, smem_set);
  if (e != cudaSuccess) return e;
  int sms = 0;
  const cudaError_t e2 = tc::sm_count(&sms);
  if (e2 != cudaSuccess) return e2;
  const int q_tiles = (a.Sq + MQ - 1) / MQ;
  const long long blocks = (long long)q_tiles * a.B * a.H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_mma<T, DH><<<static_cast<unsigned>(blocks), MNT, smem, stream>>>(
      a, q_tiles, sms);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mma_dh(const Args& a, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch_mma<T, 16>(a, stream);
    case 32: return launch_mma<T, 32>(a, stream);
    case 64: return launch_mma<T, 64>(a, stream);
    case 80: return launch_mma<T, 80>(a, stream);   // zamba2's shared attention
    case 112: return launch_mma<T, 112>(a, stream);  // kimi-k2
    case 128: return launch_mma<T, 128>(a, stream);
    case 256: return launch_mma<T, 256>(a, stream);  // gemma2
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
  switch (dtype) {
    case 0: return launch_dh<float>(a, B, dh, s);
    case 1: return launch_mma_dh<__half>(a, dh, s);
    case 2: return launch_mma_dh<__nv_bfloat16>(a, dh, s);
    default: return cudaErrorInvalidValue;
  }
}
