// Chunked RWKV6 WKV scan for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the JAX package's Pallas TPU kernel kernels/wkv6.py:_wkv_kernel
// (launched by wkv6).  Per (batch b, head h), with the (hd_k, hd_v) state
// S, per-channel decays w_t = exp(logw_t) (logw < 0) and the bonus u:
//   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),    S_t = diag(w_t) S_{t-1} + k_t^T v_t
// computed chunk by chunk.  Inside a chunk, with cum_t[i] the running sum
// of logw over the chunk's rows s <= t and cum_{t-1} = cum_t - logw_t:
//   y_t  = sum_{s<t} att(t,s) v_s + (sum_i r_t[i] u[i] k_t[i]) v_t
//        + (r_t * exp(cum_{t-1})) S                   (the carried state)
//   att(t,s) = sum_i r_t[i] k_s[i] exp(cum_{t-1}[i] - cum_s[i])
//   S'   = diag(exp(cum_end)) S + sum_s (k_s * exp(cum_end - cum_s))^T v_s
// In the CUDA-core kernel every decay is one exp of a difference of
// cumulative logs over rows s < t (or s <= end), so no exponent is
// positive; pairs with s >= t are never computed.  The Hopper kernel takes
// the same decays as products of w (below).
//
// Layout: r, k, v (B,S,H,hd) in f32/f16/bf16 and logw (B,S,H,hd) f32, each
// given by its (batch, seq, head) strides in elements with a unit stride
// on hd, so the model's projections are read in place.  u (H,hd) f32.
// s0 (B,H,hd,hd) f32 or null (zeros).  Outputs y (B,S,H,hd) f32 and
// s_last (B,H,hd_k,hd_v) f32, contiguous: the decode cache's layout.  The
// Pallas grid is (batch*heads, chunks) with the chunk axis sequential and
// the state in VMEM scratch; on Hopper nothing carries over between
// blocks unless they share a cluster, so the two paths below differ in
// what walks the chunks.
//
// Bound on an H100 at rwkv6's prefill (B=1, S=512, H=32, hd=64, bf16
// r/k/v): about 15.2 MB in and out, 4.5 us at 3.35 TB/s; the recurrence's
// 5 hd^2 operations a token and head (3 hd^2 for diag(w) S + k^T v, 2 hd^2
// for r S; the bonus is O(hd)) are 0.34 GFLOP, 0.34 us on the tensor cores
// (5.0 us at f32's 67 TFLOP/s on the CUDA cores).  So the bytes bound it.
// At its train forward (B=2, S=1024) 59.8 MB, 17.8 us.
//
// bf16 with hd a multiple of 16 up to 128: wkv_fwd_walk, one launch a
// call.  Its decays are products, not exps of differences: with w =
// exp(logw) (one ex2 an element of logw: 4,096 a chunk and head at hd 64,
// 1.05 M a prefill call, 0.28 us at the card's SFU rate of 16 a clock an
// SM at about 1.75 GHz, beside the 4.5 us byte bound), every factor
// prod_{a<=m<b} w_m lies in (0, 1], so no exponent is positive, no mask
// comes before an exp, and where a product flushes to 0 the true term is
// smaller still.  (The cumulative-sum form took one exp a pair and
// channel on the diagonal: 7.86 M a prefill call, about 2.1 us.)  Per
// 64-row chunk, in 16-row blocks beta and their 8-row halves (P_t, Q_t:
// the products of w over t's block before and after t; P8, Q8 the same
// over its half; W_beta over block beta):
//   q_t  = r_t P_t W_0..W_{beta(t)-1}    kd_s = k_s Q_s W_{beta(s)+1}..W_3
//   e_end = W_0 W_1 W_2 W_3
//   att(t, s), s's block J before t's: (r_t P_t W_{J+1}..W_{beta(t)-1}) .
//     (k_s Q_s), factored about the last row of s's block
//   att(t, s), s in the left half and t in the right of one block:
//     (r_t P8_t) . (k_s Q8_s), about the left half's last row
//   att(t, s), one half: r_t k_s prod_{s<m<t} w_m; att(t, t) = r_t u k_t
//   y = att v + q S_in,    S_out = diag(e_end) S_in + kd^T v.
//   Work.  An item is one (batch, head), walked by a thread block cluster
// of P blocks: block rho owns chunks rho, rho + P, ...  Everything the
// state does not enter is done once a (batch, head, chunk), by the block
// that owns the chunk, in parallel with the other blocks' chunks; the state
// goes from block to block through distributed shared memory, so the
// serial chain is one short hop a chunk and the state never leaves the
// chip.  P (kernels/wkv6.py walk_geometry, checked here) is the largest,
// at most 8 and at most the chunks, whose clusters all fit on the card at
// once, asked of the card (cudaOccupancyMaxActiveClusters; an H100 takes
// 66 clusters of 2, 30 of 4): rwkv6's prefill runs 32 clusters of 3 (96
// blocks), its train forward 64 of 2.  Past hd 64 a block's tiles are
// twice as wide and P is 1.
//   A block: two att warpgroups (one past hd 64) and a consumer warpgroup
// a 64 columns of v, 384 threads.  Att warp a owns the 8-row half-block
// a (two warpgroups; halves 2a and 2a + 1 with one), lanes on channel
// pairs: w (in registers; with one warpgroup in place of logw) and each
// half's product Wh; the half's 28
// pairs and 8 bonus terms summed over the lane's channels in registers,
// then over the warp by a reduce-scatter of shuffles; q and kd (hi + lo,
// the consumer's), r P8 (f32), k~ = k Q (hi + lo, in place of r and k)
// and k~8 = k Q8 (the left halves, gathered).  Then the tensor cores take
// the rest of att, four wgmma products with A = r~ from registers: the
// off-diagonal column blocks J = 0, 1, 2 (m64n16 over the channels, B =
// k~ block J) and the pairs across halves (m64n32, B = k~8); the first
// warpgroup issues J = 0 and 2, the second J = 1 and the halves' (one
// warpgroup issues all four, one after another).  Its
// thread 0 issues the TMA boxes: r, k and logw in 64 x 64 boxes into
// `stages_in` input stages, v into the consumer stage when it is free;
// TMA zero-fills rows past S and channels past hd, so a ragged last chunk,
// S < 16 and hd < 64 take no other path (a zero logw is a decay of 1, zero
// r and k add nothing).  The consumer keeps its 64 columns j of the state
// transposed, S^T (j x i), in its accumulators: per chunk it issues y^T =
// v^T att^T and dS^T = v^T kd (v an M-major A; att K-major, kd MN-major
// B), which the state does not enter, then waits for S_in^T, forms S_out^T
// = S_in^T diag(e_end) + dS^T, sends it to the block of the next chunk
// (st.async into its inbox, completing on an mbarrier whose byte count
// the receiver arms itself) and only then adds S_in^T q^T to y^T (S_in^T
// from registers, q a K-major B).  Past hd 64 the block walks every chunk,
// the state staying in the accumulators.  The stages complete on
// mbarriers (input: TMA bytes; consumer: v's bytes and the att warps;
// empty: the consumer warps), so the att warps build the next chunk while
// the consumer runs this one.  r, k and v are exact bf16 operands; q, kd,
// att, r~, k~, k~8 and S_in are f32, and rounding them to bf16 (2^-8) or
// TF32 (2^-11) would break the 1e-4 tolerance, so each goes in as a hi +
// lo pair of bf16 (two products against an exact operand, three between
// two split ones; about 2^-17 of the value; tc::split_bf2).
//   Shared memory: two input and two consumer stages at hd <= 64 (228,408
// bytes in a cluster, one block an SM), one of each past hd 64.  Why this
// shape (measured at rwkv6's shapes on an H100, PERF.md): one block a
// (batch, head), its 32 blocks walking 8 chunks each, took several times
// the parent's time, its chain of chunks serial on one SM; clusters that
// do not all fit at once (32 of 4 where 30 fit) run in two waves; one att
// warpgroup (a 16-row block a warp, all its 120 pairs on the CUDA cores)
// was slower than two with the pairs across halves on wgmma; and code
// unrolled for each column block stalls on instruction fetch, so the
// products run their J in a loop where two slices leave no registers to
// issue them together.

// f32, f16, and widths the path does not take: wkv_fwd, the CUDA-core
// kernel of the first port.  One block owns one (batch, head, slice of
// DS = 16 value columns): y[:, j] and S[:, j] depend on column j of v
// alone, so the block keeps its (hd, DS) slice of the state in shared
// memory and walks the chunks in order.  Per chunk of L = 32 rows it
// stages r, k, logw and its v columns as f32, takes the per-channel sums
// serially, then att(t,s) for the L(L-1)/2 pairs s < t (one exp a pair
// and channel), y, and the state update, all in f32 FMA.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"
#include "mma_sm80.cuh"

namespace {

constexpr int L = 32;      // chunk rows
constexpr int DS = 16;     // value columns per block
constexpr int NT = 256;    // threads per block
constexpr int AP = L + 1;  // padded row of att
constexpr int PAIRS = L * (L - 1) / 2;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;  // may be null
  float* y;
  float* s_last;
  int S, H, hd;
  long long rs[3], ks[3], vs[3], ws[3];  // (batch, seq, head) strides
};

int smem_floats(int K) {
  const int KP = K + 1;
  return 6 * L * KP + L * DS + L * AP + K * DS + L + 2 * K;
}

template <typename T>
__global__ void __launch_bounds__(NT) wkv_fwd(Args a) {
  extern __shared__ float smem[];
  const int K = a.hd, KP = K + 1;
  float* sR = smem;             // [L][KP] r_t
  float* sK = sR + L * KP;      // [L][KP] k_s
  float* sCum = sK + L * KP;    // [L][KP] cum_t
  float* sCp = sCum + L * KP;   // [L][KP] logw_t, then cum_{t-1}
  float* sQ = sCp + L * KP;     // [L][KP] r_t exp(cum_{t-1})
  float* sKd = sQ + L * KP;     // [L][KP] k_s exp(cum_end - cum_s)
  float* sV = sKd + L * KP;     // [L][DS] this block's v columns
  float* sA = sV + L * DS;      // [L][AP] att(t, s) for s < t
  float* sS = sA + L * AP;      // [K][DS] this block's state columns
  float* sBonus = sS + K * DS;  // [L] sum_i r_t u k_t
  float* sU = sBonus + L;       // [K]
  float* sEnd = sU + K;         // [K] exp(cum_end)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * DS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nd = min(DS, K - j0);
  const T* rp = static_cast<const T*>(a.r) + b * a.rs[0] + h * a.rs[2];
  const T* kp = static_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[2];
  const T* vp = static_cast<const T*>(a.v) + b * a.vs[0] + h * a.vs[2] + j0;
  const float* wp = a.w + b * a.ws[0] + h * a.ws[2];
  const long long y_row = static_cast<long long>(a.H) * K;
  float* yp = a.y + static_cast<long long>(b) * a.S * y_row +
              static_cast<long long>(h) * K + j0;
  const long long s_off = (static_cast<long long>(b) * a.H + h) * K;

  for (int idx = tid; idx < K * DS; idx += NT) {
    const int i = idx / DS, j = idx % DS;
    sS[idx] = (a.s0 != nullptr && j < nd) ? a.s0[(s_off + i) * K + j0 + j]
                                          : 0.f;
  }
  for (int i = tid; i < K; i += NT) sU[i] = a.u[h * K + i];

  for (int t0 = 0; t0 < a.S; t0 += L) {
    const int lc = min(L, a.S - t0);
    __syncthreads();  // the last chunk's reads are done
    for (int idx = tid; idx < L * K; idx += NT) {
      const int r = idx / K, i = idx % K;
      const bool in = r < lc;
      sR[r * KP + i] = in ? to_f(rp[(t0 + r) * a.rs[1] + i]) : 0.f;
      sK[r * KP + i] = in ? to_f(kp[(t0 + r) * a.ks[1] + i]) : 0.f;
      sCp[r * KP + i] = in ? wp[(t0 + r) * a.ws[1] + i] : 0.f;
    }
    for (int idx = tid; idx < L * DS; idx += NT) {
      const int r = idx / DS, j = idx % DS;
      sV[idx] = (r < lc && j < nd) ? to_f(vp[(t0 + r) * a.vs[1] + j]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < K; i += NT) {  // serial over t, per channel
      float c = 0.f;
      for (int r = 0; r < L; ++r) {
        const float lw = sCp[r * KP + i];
        c += lw;
        sCum[r * KP + i] = c;
        sCp[r * KP + i] = c - lw;
      }
      sEnd[i] = expf(c);  // rows past lc add 0, so c is cum_end
    }
    __syncthreads();
    for (int idx = tid; idx < L * K; idx += NT) {
      const int r = idx / K, i = idx % K;
      sQ[r * KP + i] = sR[r * KP + i] * expf(sCp[r * KP + i]);
      sKd[r * KP + i] =
          r < lc ? sK[r * KP + i] *
                       expf(sCum[(lc - 1) * KP + i] - sCum[r * KP + i])
                 : 0.f;
    }
    for (int t = warp; t < L; t += NT / 32) {  // one warp per row
      float acc = 0.f;
      for (int i = lane; i < K; i += 32)
        acc = fmaf(sR[t * KP + i] * sU[i], sK[t * KP + i], acc);
      acc = warp_sum(acc);
      if (lane == 0) sBonus[t] = acc;
    }
    // att(t,s) over the pairs s < t, numbered row by row: pair p is
    // (t, s) with t (t - 1) / 2 <= p < t (t + 1) / 2 and s = p - t (t - 1) / 2.
    for (int p = tid; p < PAIRS; p += NT) {
      int t = static_cast<int>((1.f + sqrtf(1.f + 8.f * p)) * 0.5f);
      if (t * (t - 1) / 2 > p) --t;
      if (t * (t + 1) / 2 <= p) ++t;
      const int s = p - t * (t - 1) / 2;
      float acc = 0.f;
      if (t < lc) {
        for (int i = 0; i < K; ++i)
          acc = fmaf(sR[t * KP + i] * sK[s * KP + i],
                     expf(sCp[t * KP + i] - sCum[s * KP + i]), acc);
      }
      sA[t * AP + s] = acc;
    }
    __syncthreads();

    // y_t[j] = sum_{s<t} att(t,s) v_s[j] + bonus_t v_t[j] + sum_i q_t[i] S[i][j]
    {
      const int j = tid % DS;
      for (int t = tid / DS; t < lc; t += NT / DS) {
        float acc = 0.f;
        for (int s = 0; s < t; ++s) acc = fmaf(sA[t * AP + s], sV[s * DS + j], acc);
        acc = fmaf(sBonus[t], sV[t * DS + j], acc);
        for (int i = 0; i < K; ++i) acc = fmaf(sQ[t * KP + i], sS[i * DS + j], acc);
        if (j < nd) yp[(t0 + t) * y_row + j] = acc;
      }
    }
    __syncthreads();  // every read of the old state is done

    // S[i][j] = exp(cum_end[i]) S[i][j] + sum_s kd_s[i] v_s[j]
    for (int idx = tid; idx < K * DS; idx += NT) {
      const int i = idx / DS, j = idx % DS;
      float acc = 0.f;
      for (int s = 0; s < lc; ++s) acc = fmaf(sKd[s * KP + i], sV[s * DS + j], acc);
      sS[idx] = fmaf(sEnd[i], sS[idx], acc);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < K * DS; idx += NT) {
    const int i = idx / DS, j = idx % DS;
    if (j < nd) a.s_last[(s_off + i) * K + j0 + j] = sS[idx];
  }
}

template <typename T>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int smem = smem_floats(a.hd) * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      wkv_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.hd + DS - 1) / DS, a.H, B);
  wkv_fwd<T><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}


// ----------------------------------------------------------- bf16, Hopper:
// a cluster a (batch, head) walks the chunks with the state on chip (see
// the header)

namespace walk {

using bf16 = __nv_bfloat16;
constexpr int L = 64;                 // chunk rows: wgmma's m64
constexpr int SUB = 16;               // a factoring block: a warp's rows
constexpr int HALF = 8;               // its halves, the CUDA cores' unit
constexpr int TILE = L * 64 * 2;      // a bf16 box: 64 rows of 64 channels
constexpr int WTILE = L * 64 * 4;     // an f32 box of logw, then w
constexpr int WG = 128;               // a warpgroup's threads
constexpr int SMEM_MAX = 232448;      // a block's largest opt-in, 227 KB
constexpr unsigned FULL = 0xffffffffu;

// The att warpgroups at `mt` slices: two at one, one at two (whose
// consumers take the other warpgroup's registers).
__host__ __device__ constexpr int att_groups(int mt) { return mt == 1 ? 2 : 1; }

// Shared memory of one block from the first 1024-byte boundary:
//   `sin` input stages (the att warpgroups'): r's and k's boxes (64
//     channels each, 128-byte swizzle; k~ hi and lo overwrite them), then
//     logw's boxes (f32, unswizzled; w overwrites it);
//   `sc` consumer stages: v's boxes, q hi, q lo, kd hi, kd lo (a box per 64
//     channels each), att hi, att lo (one box each), e_end (f32);
//   rP (64 rows of 64 mt + 8 f32), Wh (8 x 64 mt f32), k~8 hi and lo (32
//     rows, a 4 KB box per 64 channels), in a cluster the inbox of the
//     state entering a chunk (64 x 64 f32), then the barriers: input full,
//     consumer full, consumer empty, state in.
// kernels/wkv6.py walk_smem_bytes computes the same total, which the entry
// point checks.
struct Layout {
  int in_bytes, c_bytes, rp_stride, rp, wh, kt8, inbox, bars, total;
  __host__ __device__ Layout(int mt, int sin, int sc, int cluster)
      : in_bytes(mt * (2 * TILE + WTILE)),
        c_bytes((5 * mt * TILE + 2 * TILE + 256 * mt + 1023) / 1024 * 1024),
        rp_stride(64 * mt + 8),
        rp(sin * in_bytes + sc * c_bytes),
        wh(rp + L * rp_stride * 4),
        kt8(wh + 8 * 64 * mt * 4),
        inbox(kt8 + 2 * 4096 * mt),
        bars(inbox + (cluster > 1 ? 64 * 64 * 4 : 0)),
        total(1024 + bars + (sin + 2 * sc + 1) * 8) {}
};

struct Args {
  const float* u;
  const float* s0;   // may be null
  float* y;
  float* s_last;
  int S, H, hd, nc, sin, sc, P;   // P: the cluster's blocks
};

// The byte offset of (row t, channel c) in a bf16 tile of 64-channel boxes
// of 128-byte rows, as the 128-byte swizzle stores it (the 16-byte chunk
// index XOR the row's low three bits): the layout TMA writes and wgmma
// reads.
__device__ __forceinline__ int at16(int t, int c) {
  const int o = t * 128 + (c & 63) * 2;
  return (c >> 6) * TILE + (o ^ ((t & 7) << 4));
}

// The same in an f32 tile of 64-channel boxes, unswizzled.
__device__ __forceinline__ int at32(int t, int c) {
  return (c >> 6) * WTILE + t * 256 + (c & 63) * 4;
}

// The k~8 tile: 32 gathered rows of 128 bytes, a 4 KB box per 64 channels.
__device__ __forceinline__ int at8(int n, int c) {
  const int o = n * 128 + (c & 63) * 2;
  return (c >> 6) * 4096 + (o ^ ((n & 7) << 4));
}

// exp(y) as ex2.approx.ftz of y log2(e): to about 2^-22 of the value plus
// the argument's rounding, |y| 2^-24; results below f32's normal range
// flush to 0.  Only w = exp(logw) goes through it, one per element.
__device__ __forceinline__ float exp_ftz(float y) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y * 1.4426950408889634f));
  return r;
}

// The k16 step kk of a K-major operand in boxes of `box` bytes (64
// channels each): 32 bytes a step inside a box, the next box every four.
__device__ __forceinline__ uint64_t kstep(uint64_t desc, int kk,
                                          int box = TILE) {
  return desc + ((((kk >> 2) * box) + (kk & 3) * 32) >> 4);
}

__device__ __forceinline__ float2 bf2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ float2 mul2(float2 a, float2 b) {
  return make_float2(a.x * b.x, a.y * b.y);
}

// One halving of a reduce-scatter over the warp: N values a lane become
// N / 2, lanes O apart exchanging the halves they do not keep.
template <int N, int O, int A>
__device__ __forceinline__ void halve(float (&acc)[A], int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const float lo = acc[j], hi = acc[j + N / 2];
    acc[j] = (up ? hi : lo) + __shfl_xor_sync(FULL, up ? lo : hi, O);
  }
}

// Byte offsets in a consumer stage.
template <int MT>
struct CStage {
  static constexpr int V = 0, QHI = MT * TILE, QLO = 2 * MT * TILE,
                       KDHI = 3 * MT * TILE, KDLO = 4 * MT * TILE,
                       AHI = 5 * MT * TILE, ALO = AHI + TILE,
                       EEND = ALO + TILE;
};

// What the att warps read and write for a chunk.
struct Chunk {
  unsigned char* rt;    // r, then k~ hi (input stage)
  unsigned char* kt;    // k, then k~ lo
  unsigned char* wt;    // logw, then w (f32)
  unsigned char* cp;    // the consumer stage
  unsigned char* kt8;   // k~8 hi, then lo: the halves' left rows, gathered
  float* rp;            // r P8 (f32, rows of rps)
  float* wh;            // Wh[8][64 mt]: each 8-row half's product of w
  const float* u;       // u of the head
  int rps, hd, lane;
};

// w = exp(logw) in place over half-block hb's rows (8 hb .. 8 hb + 7),
// lanes on channel pairs, and Wh[hb], its product over the rows in order.
template <int MT>
__device__ __forceinline__ void half_w(const Chunk& ch, int hb) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int c0 = 64 * m + 2 * ch.lane;
    if (c0 < ch.hd) {
      float2 p = make_float2(1.f, 1.f);
#pragma unroll
      for (int t = 0; t < HALF; ++t) {
        float2* x = reinterpret_cast<float2*>(ch.wt + at32(HALF * hb + t, c0));
        const float2 lw = *x;
        const float2 e = make_float2(exp_ftz(lw.x), exp_ftz(lw.y));
        *x = e;
        p = mul2(p, e);
      }
      *reinterpret_cast<float2*>(ch.wh + hb * 64 * MT + c0) = p;
    }
  }
}

// Half-block hb (rows 8 hb .. 8 hb + 7, half h = hb % 2 of 16-row block
// beta = hb / 2) on the CUDA cores, lanes on channel pairs (2 l, 2 l + 1)
// + 64 m: its 28 pairs, r_t k_s prod_{s<m<t} w_m (the decay as a running
// product: every factor at most 1, so no exponent is positive and no mask
// is needed), and its 8 bonus terms r_t u k_t, each summed over the lane's
// channels, then over the warp (a reduce-scatter by shuffles), hi + lo
// into the att tile.  (Pairs across halves and blocks go to the tensor
// cores.)  It also writes, for its channels and rows: q = r P Apre and
// kd = k Q Asuf (hi + lo, the consumers'), r P8 (f32), k~ = k Q (hi + lo,
// over r and k, which this lane alone reads there) and, in a left half,
// k~8 = k Q8 (hi + lo, gathered); P and Q are the products of w over t's
// 16-row block before and after t, P8 and Q8 the same over its half, Apre
// and Asuf those of the blocks' W = Wh Wh before and after beta.  Half 0
// also writes e_end = W_0 W_1 W_2 W_3.
//   With `fused` (one channel pair a lane: hd <= 64) the pass also makes
// w itself, exp(logw) into registers, and publishes Wh[hb]; `meet` then
// runs once the pairs are summed, before the writes that read the other
// halves' Wh or the consumer stage.  Without, half_w has run.
template <int MT, bool FUSED, typename Meet>
__device__ __forceinline__ void half_pass(const Chunk& ch, int hb,
                                          Meet&& meet) {
  using CS = CStage<MT>;
  static_assert(!FUSED || MT == 1, "one channel pair a lane");
  const int beta = hb >> 1, h = hb & 1;
  float acc[32];   // 28 pairs, then the bonus of rows 0 .. 3
  float bon[4];    // the bonus of rows 4 .. 7
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) bon[i] = 0.f;
#pragma unroll 1
  for (int m = 0; m < MT; ++m) {
    const int c0 = 64 * m + 2 * ch.lane;
    const bool on = c0 < ch.hd;
    float2 w[HALF];
    uint32_t r[HALF], k[HALF];   // bf16 pairs, widened where used
    if (on) {
#pragma unroll
      for (int t = 0; t < HALF; ++t) {
        const int row = HALF * hb + t;
        r[t] = *reinterpret_cast<const uint32_t*>(ch.rt + at16(row, c0));
        k[t] = *reinterpret_cast<const uint32_t*>(ch.kt + at16(row, c0));
        w[t] = *reinterpret_cast<const float2*>(ch.wt + at32(row, c0));
      }
      if (FUSED) {
        float2 p = make_float2(1.f, 1.f);
#pragma unroll
        for (int t = 0; t < HALF; ++t) {
          w[t] = make_float2(exp_ftz(w[t].x), exp_ftz(w[t].y));
          p = mul2(p, w[t]);
        }
        *reinterpret_cast<float2*>(ch.wh + hb * 64 * MT + c0) = p;
      }
      int slot = 0;
#pragma unroll
      for (int s = 0; s < HALF - 1; ++s) {
        const float2 ks = bf2(k[s]);
        float dx = 1.f, dy = 1.f;
#pragma unroll
        for (int t = s + 1; t < HALF; ++t) {
          const float2 rt = bf2(r[t]);
          acc[slot] = fmaf(rt.x * dx, ks.x, acc[slot]);
          acc[slot] = fmaf(rt.y * dy, ks.y, acc[slot]);
          ++slot;
          dx *= w[t].x;
          dy *= w[t].y;
        }
      }
      const float ux = ch.u[c0], uy = ch.u[c0 + 1];
#pragma unroll
      for (int t = 0; t < HALF; ++t) {
        const float2 kt = bf2(k[t]), rt = bf2(r[t]);
        float& b = t < 4 ? acc[28 + t] : bon[t & 3];
        b = fmaf(rt.x * ux, kt.x, b);
        b = fmaf(rt.y * uy, kt.y, b);
      }
    }
    if (FUSED) meet();
    if (on) {
      float2 apre = make_float2(1.f, 1.f), asuf = apre, eall = apre;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const float2 wb = mul2(
            *reinterpret_cast<const float2*>(ch.wh + 2 * bb * 64 * MT + c0),
            *reinterpret_cast<const float2*>(ch.wh + (2 * bb + 1) * 64 * MT +
                                             c0));
        if (bb < beta) apre = mul2(apre, wb);
        if (bb > beta) asuf = mul2(asuf, wb);
        eall = mul2(eall, wb);
      }
      if (hb == 0)
        *reinterpret_cast<float2*>(ch.cp + CS::EEND + 4 * c0) = eall;
      // the other half of the block: P = WL P8 in the right, Q = Q8 WR in
      // the left
      const float2 other = *reinterpret_cast<const float2*>(
          ch.wh + (hb ^ 1) * 64 * MT + c0);
      const float2 pin = h ? other : make_float2(1.f, 1.f);
      const float2 qin = h ? make_float2(1.f, 1.f) : other;
      float2 p8 = make_float2(1.f, 1.f);
#pragma unroll
      for (int t = 0; t < HALF; ++t) {
        const int row = HALF * hb + t, o = at16(row, c0);
        const float2 rp8 = mul2(bf2(r[t]), p8);
        *reinterpret_cast<float2*>(ch.rp + row * ch.rps + c0) = rp8;
        const float2 q = mul2(mul2(rp8, pin), apre);
        uint32_t hi, lo;
        tc::split_bf2(q.x, q.y, hi, lo);
        *reinterpret_cast<uint32_t*>(ch.cp + CS::QHI + o) = hi;
        *reinterpret_cast<uint32_t*>(ch.cp + CS::QLO + o) = lo;
        p8 = mul2(p8, w[t]);
      }
      float2 q8 = make_float2(1.f, 1.f);
#pragma unroll
      for (int t = HALF - 1; t >= 0; --t) {
        const int row = HALF * hb + t, o = at16(row, c0);
        const float2 kq8 = mul2(bf2(k[t]), q8);
        const float2 kq = mul2(kq8, qin);
        const float2 kd = mul2(kq, asuf);
        uint32_t hi, lo;
        tc::split_bf2(kd.x, kd.y, hi, lo);
        *reinterpret_cast<uint32_t*>(ch.cp + CS::KDHI + o) = hi;
        *reinterpret_cast<uint32_t*>(ch.cp + CS::KDLO + o) = lo;
        tc::split_bf2(kq.x, kq.y, hi, lo);
        *reinterpret_cast<uint32_t*>(ch.rt + o) = hi;
        *reinterpret_cast<uint32_t*>(ch.kt + o) = lo;
        if (h == 0) {
          const int o8 = at8(HALF * beta + t, c0);
          tc::split_bf2(kq8.x, kq8.y, hi, lo);
          *reinterpret_cast<uint32_t*>(ch.kt8 + o8) = hi;
          *reinterpret_cast<uint32_t*>(ch.kt8 + 4096 * MT + o8) = lo;
        }
        q8 = mul2(q8, w[t]);
      }
    }
  }
  halve<32, 16>(acc, ch.lane);
  halve<16, 8>(acc, ch.lane);
  halve<8, 4>(acc, ch.lane);
  halve<4, 2>(acc, ch.lane);
  halve<2, 1>(acc, ch.lane);   // lane l: slot l
  halve<4, 16>(bon, ch.lane);
  halve<2, 8>(bon, ch.lane);   // lane l: row 4 + l / 8, a quarter of it
  bon[0] += __shfl_xor_sync(FULL, bon[0], 4);
  bon[0] += __shfl_xor_sync(FULL, bon[0], 2);
  bon[0] += __shfl_xor_sync(FULL, bon[0], 1);
  // the lane, opaque here: addresses made from it are computed where they
  // are used, not hoisted out of the chunk loop to spill across the pass
  int lane = ch.lane;
  asm volatile("" : "+r"(lane));
  auto put = [&](int t, int s, float v) {
    const bf16 hi = __float2bfloat16_rn(v);
    const bf16 lo = __float2bfloat16_rn(v - __bfloat162float(hi));
    const int o = at16(HALF * hb + t, HALF * hb + s);
    *reinterpret_cast<bf16*>(ch.cp + CS::AHI + o) = hi;
    *reinterpret_cast<bf16*>(ch.cp + CS::ALO + o) = lo;
  };
  int k = lane;
  if (k < 28) {   // slot k: pairs numbered s-major
    int s = 0;
    while (k >= HALF - 1 - s) {
      k -= HALF - 1 - s;
      ++s;
    }
    put(s + 1 + k, s, acc[0]);
  } else {
    put(k - 28, k - 28, acc[0]);
  }
  if ((lane & 7) == 0) put(4 + (lane >> 3), 4 + (lane >> 3), bon[0]);
}

// The A fragments, in warp w's rows (16 w + g and + 8), of the products
// that build att on the tensor cores, split hi + lo:
//   J = 0, 1, 2: column block J, rows of the blocks after it: r~ = r P G
//     (P = P8, times WL in the right half; G the product of W over the
//     blocks between), zero in warps w <= J, against B = k~ (K-major,
//     block J's 16 rows), factored about the last row of s's block;
//   J = 3: the pairs across the halves of each diagonal block, t in the
//     right, s in the left, factored about the left half's last row:
//     r P8 in the right rows, zero in the left, against B = k~8 (the left
//     halves' rows gathered: column 8 blk + (s - 16 blk)).
template <int MT>
__device__ __forceinline__ void prod_a(const Chunk& ch, int J, int w,
                                       uint32_t (&ahi)[4 * MT][4],
                                       uint32_t (&alo)[4 * MT][4]) {
  const int g = ch.lane >> 2, q = ch.lane & 3;
  const float* rp0 = ch.rp + (SUB * w + g) * ch.rps;   // row 16 w + g
  const float* rp1 = rp0 + 8 * ch.rps;                 // and + 8
  const bool on = J == 3 || w > J;
#pragma unroll
  for (int kk = 0; kk < 4 * MT; ++kk)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {   // channels c, c + 1 of rows 0, 1
      const int c = 16 * kk + 2 * q + 8 * e2;
      float2 v0 = make_float2(0.f, 0.f), v1 = v0;
      if (on) {
        v1 = *reinterpret_cast<const float2*>(rp1 + c);
        if (J < 3) {
          // G: the blocks between J and w, then WL in the right half
          float2 gf = make_float2(1.f, 1.f);
#pragma unroll
          for (int bb = 1; bb < 3; ++bb)
            if (bb > J && bb < w)
              gf = mul2(mul2(gf, *reinterpret_cast<const float2*>(
                                     ch.wh + 2 * bb * 64 * MT + c)),
                        *reinterpret_cast<const float2*>(
                            ch.wh + (2 * bb + 1) * 64 * MT + c));
          v0 = mul2(*reinterpret_cast<const float2*>(rp0 + c), gf);
          v1 = mul2(v1, mul2(gf, *reinterpret_cast<const float2*>(
                                     ch.wh + 2 * w * 64 * MT + c)));
        }
      }
      tc::split_bf2(v0.x, v0.y, ahi[kk][2 * e2], alo[kk][2 * e2]);
      tc::split_bf2(v1.x, v1.y, ahi[kk][2 * e2 + 1], alo[kk][2 * e2 + 1]);
    }
}

// Product J into acc (m64n16 for J < 3, m64n32 for J = 3), hi + lo (three
// products a k16 step), issued, not committed; the first one overwrites
// acc (its contents are not read).
template <int MT, int N>
__device__ __forceinline__ void prod_mma(const Chunk& ch, int J,
                                         float (&acc)[N / 2],
                                         const uint32_t (&ahi)[4 * MT][4],
                                         const uint32_t (&alo)[4 * MT][4]) {
  const bool half = N == 32;
  const int box = half ? 4096 : TILE;
  const uint64_t dh = hopper::smem_desc(half ? ch.kt8 : ch.rt + 2048 * J, 0,
                                        1024, 128);
  const uint64_t dl = hopper::smem_desc(
      half ? ch.kt8 + 4096 * MT : ch.kt + 2048 * J, 0, 1024, 128);
#pragma unroll
  for (int kk = 0; kk < 4 * MT; ++kk) {
    hopper::wgmma_rs<bf16, N, 0>(acc, ahi[kk], kstep(dh, kk, box), kk > 0);
    hopper::wgmma_rs<bf16, N, 0>(acc, ahi[kk], kstep(dl, kk, box), 1);
    hopper::wgmma_rs<bf16, N, 0>(acc, alo[kk], kstep(dh, kk, box), 1);
  }
}

// Product J's att in warp w's rows, hi + lo into the att tile.
template <int MT, int N>
__device__ __forceinline__ void prod_store(const Chunk& ch, int J, int w,
                                           const float (&acc)[N / 2]) {
  using CS = CStage<MT>;
  const int g = ch.lane >> 2, q = ch.lane & 3;
  auto put = [&](int t, int s, float v0, float v1) {
    const int o = at16(t, s);
    uint32_t hi, lo;
    tc::split_bf2(v0, v1, hi, lo);
    *reinterpret_cast<uint32_t*>(ch.cp + CS::AHI + o) = hi;
    *reinterpret_cast<uint32_t*>(ch.cp + CS::ALO + o) = lo;
  };
  if constexpr (N == 32) {   // the n8 block of columns 8 w .. 8 w + 7
    float v0 = acc[2], v1 = acc[3];
#pragma unroll
    for (int n = 1; n < 4; ++n)
      if (n == w) {
        v0 = acc[4 * n + 2];
        v1 = acc[4 * n + 3];
      }
    put(SUB * w + g + 8, SUB * w + 2 * q, v0, v1);
  } else if (w > J) {
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1)
        put(SUB * w + g + 8 * e1, SUB * J + 8 * nn + 2 * q,
            acc[4 * nn + 2 * e1], acc[4 * nn + 2 * e1 + 1]);
  }
}

// One att warpgroup's products: with two (one slice), the first takes
// column blocks 0 and 2, the second 1 and the halves' pairs, each issued
// together; with one (two slices, twice the fragments) all four, one
// after another.  w: this warp's place in its warpgroup.
template <int MT>
__device__ __forceinline__ void products(const Chunk& ch, int group, int w) {
  if constexpr (MT == 1) {
    uint32_t ahi[2][4][4], alo[2][4][4];
    float a16[8], b16[8], a32[16];
    const int J0 = group == 0 ? 0 : 1, J1 = group == 0 ? 2 : 3;
    prod_a<MT>(ch, J0, w, ahi[0], alo[0]);
    prod_a<MT>(ch, J1, w, ahi[1], alo[1]);
    hopper::wgmma_fence();
    prod_mma<MT, 16>(ch, J0, a16, ahi[0], alo[0]);
    if (group == 0)
      prod_mma<MT, 16>(ch, J1, b16, ahi[1], alo[1]);
    else
      prod_mma<MT, 32>(ch, J1, a32, ahi[1], alo[1]);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(a16);
    hopper::fence_regs(b16);
    hopper::fence_regs(a32);
    prod_store<MT, 16>(ch, J0, w, a16);
    if (group == 0)
      prod_store<MT, 16>(ch, J1, w, b16);
    else
      prod_store<MT, 32>(ch, J1, w, a32);
  } else {
#pragma unroll 1
    for (int J = 0; J < 4; ++J) {
      uint32_t ahi[4 * MT][4], alo[4 * MT][4];
      float a16[8], a32[16];
      prod_a<MT>(ch, J, w, ahi, alo);
      hopper::wgmma_fence();
      if (J < 3)
        prod_mma<MT, 16>(ch, J, a16, ahi, alo);
      else
        prod_mma<MT, 32>(ch, J, a32, ahi, alo);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(a16);
      hopper::fence_regs(a32);
      if (J < 3)
        prod_store<MT, 16>(ch, J, w, a16);
      else
        prod_store<MT, 32>(ch, J, w, a32);
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(WG * (att_groups(MT) + MT), 1)
    wkv_fwd_walk(const __grid_constant__ CUtensorMap tr,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tw, const Args a) {
  using CS = CStage<MT>;
  constexpr int NA = att_groups(MT), ATT = WG * NA;
  const Layout lay(MT, a.sin, a.sc, a.P);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // tiles start on 1024 bytes (the 128-byte swizzle's period)
  const uint32_t pad = (1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023;
  unsigned char* base = smem_raw + pad;
  unsigned char* cs0 = base + a.sin * lay.in_bytes;
  float* inbox = reinterpret_cast<float*>(base + lay.inbox);
  uint64_t* in_full = reinterpret_cast<uint64_t*>(base + lay.bars);
  uint64_t* c_full = in_full + a.sin;     // v's bytes + the att warps
  uint64_t* c_empty = c_full + a.sc;      // the consumer warps
  uint64_t* in_state = c_empty + a.sc;    // the state's bytes
  auto ist = [&](int s) { return base + s * lay.in_bytes; };
  auto cst = [&](int s) { return cs0 + s * lay.c_bytes; };

  // the cluster of P blocks walks one (batch, head); block rho owns
  // chunks rho, rho + P, ..., and the state goes from block to block
  const int rho = a.P > 1 ? static_cast<int>(hopper::cluster_ctarank()) : 0;
  const int item = blockIdx.x / a.P;
  const int b = item / a.H, h = item % a.H;
  const int nk = (a.nc - rho + a.P - 1) / a.P;   // chunks of this block
  const int tid = threadIdx.x, lane = tid & 31;
  // the warp, broadcast from lane 0 so the compiler sees it uniform
  const int warp = __shfl_sync(FULL, tid / 32, 0);

  auto issue_in = [&](int s, int k) {
    unsigned char* p = ist(s);
    const int row = (rho + k * a.P) * L;
    hopper::mbar_arrive_expect_tx(in_full + s, MT * (2 * TILE + WTILE));
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      hopper::tma_load(p + m * TILE, &tr, in_full + s, 64 * m, h, row, b);
      hopper::tma_load(p + (MT + m) * TILE, &tk, in_full + s, 64 * m, h,
                       row, b);
      hopper::tma_load(p + 2 * MT * TILE + m * WTILE, &tw, in_full + s,
                       64 * m, h, row, b);
    }
  };

  // Zero the consumer stages, rP, Wh and k~8: channels past hd and the att
  // tiles' upper triangle are never written after this.
  {
    uint4* z = reinterpret_cast<uint4*>(cs0);
    const int n = (lay.inbox - a.sin * lay.in_bytes) / 16;
    for (int i = tid; i < n; i += blockDim.x) z[i] = make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) {
    for (int s = 0; s < a.sin; ++s) hopper::mbar_init(in_full + s, 1);
    for (int s = 0; s < a.sc; ++s) {
      hopper::mbar_init(c_full + s, 1 + 4 * NA);
      hopper::mbar_init(c_empty + s, 4 * MT);
    }
    hopper::mbar_init(in_state, 1);   // this block's own expect_tx
    // the first state this block receives: its first chunk's, or block
    // 0's second
    if (a.P > 1 && (rho > 0 || nk > 1))
      hopper::mbar_arrive_expect_tx(in_state, WG * 32 * 4);
    hopper::fence_barrier_init();
  }
  hopper::fence_proxy_async();
  // every block's barriers are set before any other block arrives on them
  if (a.P > 1)
    hopper::cluster_sync();
  else
    __syncthreads();
  if (tid == 0)
    for (int s = 0; s < a.sin && s < nk; ++s) issue_in(s, s);

  if (warp < 4 * NA) {
    // The att warpgroups: warp a owns the half-blocks of rows 8 hb ..
    // 8 hb + 7 for hb = a (two warpgroups) or 2 a, 2 a + 1 (one); thread 0
    // also issues the TMA boxes.
    Chunk ch;
    ch.rp = reinterpret_cast<float*>(base + lay.rp);
    ch.wh = reinterpret_cast<float*>(base + lay.wh);
    ch.kt8 = base + lay.kt8;
    ch.u = a.u + static_cast<long long>(h) * a.hd;
    ch.rps = lay.rp_stride;
    ch.hd = a.hd;
    ch.lane = lane;
    constexpr int HB = 2 / NA;   // half-blocks a warp
    for (int c = 0; c < nk; ++c) {    // c: this block's chunk count
      const int si = c % a.sin, sc = c % a.sc;
      hopper::mbar_wait(in_full + si, (c / a.sin) & 1);
      ch.rt = ist(si);
      ch.kt = ch.rt + MT * TILE;
      ch.wt = ch.rt + 2 * MT * TILE;
      // every half's Wh is in (the writes read the other halves'), and the
      // consumer stage is free: thread 0 loads v into it
      auto meet = [&] {
        hopper::named_barrier_sync(1, ATT);
        hopper::mbar_wait(c_empty + sc, ((c / a.sc) & 1) ^ 1u);
        ch.cp = cst(sc);
        if (tid == 0) {
          hopper::mbar_arrive_expect_tx(c_full + sc, MT * TILE);
#pragma unroll
          for (int m = 0; m < MT; ++m)
            hopper::tma_load(ch.cp + CS::V + m * TILE, &tv, c_full + sc,
                             64 * m, h, (rho + c * a.P) * L, b);
        }
      };
      if constexpr (NA == 2) {   // one half a warp: w made in the pass
        half_pass<MT, true>(ch, warp, meet);
      } else {
#pragma unroll
        for (int i = 0; i < HB; ++i) half_w<MT>(ch, HB * warp + i);
        meet();
#pragma unroll 1
        for (int i = 0; i < HB; ++i)
          half_pass<MT, false>(ch, HB * warp + i, [] {});
      }
      hopper::fence_proxy_async();
      hopper::named_barrier_sync(1, ATT);
      products<MT>(ch, warp >> 2, warp & 3);
      hopper::fence_proxy_async();
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(c_full + sc);
      // every read of this input stage is done: refill it
      hopper::named_barrier_sync(1, ATT);
      if (tid == 0 && c + a.sin < nk) issue_in(si, c + a.sin);
    }
  } else {
    // A consumer warpgroup: columns j = 64 cw .. 64 cw + 63 of the state and
    // of y, both transposed in its accumulators.  This thread's rows j =
    // 64 cw + 16 w4 + g (+ 8), its columns 8 n + 2 q (+ 1): S^T over i, y^T
    // over t.
    const int cw = (warp - 4 * NA) >> 2, w4 = warp & 3;
    const int g = lane >> 2, q = lane & 3, ct = tid - ATT;
    const long long srow = (static_cast<long long>(b) * a.H + h) * a.hd;
    const long long yrow = static_cast<long long>(a.H) * a.hd;
    float* ybase = a.y + static_cast<long long>(b) * a.S * yrow +
                   static_cast<long long>(h) * a.hd;
    // this thread's S[i][j] at (i0 + 8 n + (e & 1), j0 + 8 (e >> 1)) of
    // the (B, H, hd, hd) layout of s0 and s_last
    const int i0 = 2 * q, j0 = 64 * cw + 16 * w4 + g;
    const long long sbase = (srow + i0) * a.hd + j0;
    auto s_at = [&](int n, int e) {
      return (8 * n + (e & 1)) * a.hd + 8 * (e >> 1);
    };
    auto s_in = [&](int n, int e) {
      return i0 + 8 * n + (e & 1) < a.hd && j0 + 8 * (e >> 1) < a.hd;
    };
    float sT[32 * MT];   // S^T entering the chunk, then leaving it
    const float* s0 = a.s0 != nullptr && rho == 0 ? a.s0 + sbase : nullptr;
#pragma unroll
    for (int n = 0; n < 8 * MT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sT[4 * n + e] = s0 != nullptr && s_in(n, e) ? s0[s_at(n, e)] : 0.f;
      // a few loads in flight at a time: all of them at once would hold an
      // address each and spill
      asm volatile("" ::: "memory");
    }
    for (int k = 0; k < nk; ++k) {
      const int c = rho + k * a.P;
      const int sc = k % a.sc;
      hopper::mbar_wait(c_full + sc, (k / a.sc) & 1);
      unsigned char* cp = cst(sc);
      // the stage's descriptors: K-major (q, att) and M- or MN-major (v,
      // kd) from two bases, the tiles' offsets added to the start address
      const uint64_t dk = hopper::smem_desc(cp, 0, 1024, 128);
      const uint64_t dm = hopper::smem_desc(cp, TILE, 1024, 128);
      const uint64_t dv = dm + ((CS::V + cw * TILE) >> 4);   // v^T: A
      const uint64_t dqh = dk + (CS::QHI >> 4), dql = dk + (CS::QLO >> 4);
      const uint64_t dah = dk + (CS::AHI >> 4), dal = dk + (CS::ALO >> 4);
      const uint64_t dkh = dm + (CS::KDHI >> 4), dkl = dm + (CS::KDLO >> 4);
      const float* ee = reinterpret_cast<const float*>(cp + CS::EEND);
      float yT[32];   // the first product of each chain overwrites it
      if constexpr (MT == 1) {
        // y^T = v^T att^T and dS^T = v^T kd need no state: issued first
        float dS[32];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hopper::wgmma_ss<bf16, 64, 0, 1>(yT, dv + kk * 128,
                                           kstep(dah, kk), kk > 0);
          hopper::wgmma_ss<bf16, 64, 0, 1>(yT, dv + kk * 128,
                                           kstep(dal, kk), 1);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hopper::wgmma_ss<bf16, 64, 1, 1>(dS, dv + kk * 128, dkh + kk * 128,
                                           kk > 0);
          hopper::wgmma_ss<bf16, 64, 1, 1>(dS, dv + kk * 128, dkl + kk * 128,
                                           1);
        }
        hopper::wgmma_commit();
        if (a.P > 1 && c > 0) {   // the state from the block of chunk c - 1
          hopper::mbar_wait_cluster(in_state, (rho == 0 ? k - 1 : k) & 1);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 v = *reinterpret_cast<const float4*>(
                inbox + 4 * (i * WG + ct));
            sT[4 * i] = v.x;
            sT[4 * i + 1] = v.y;
            sT[4 * i + 2] = v.z;
            sT[4 * i + 3] = v.w;
          }
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dS);
        hopper::fence_regs(yT);
        // S_out^T = S_in^T diag(e_end) + dS^T, into dS; then on to the
        // block of chunk c + 1 before anything else, the chain's one hop
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 e = *reinterpret_cast<const float2*>(ee + 8 * n + 2 * q);
          dS[4 * n] = fmaf(sT[4 * n], e.x, dS[4 * n]);
          dS[4 * n + 1] = fmaf(sT[4 * n + 1], e.y, dS[4 * n + 1]);
          dS[4 * n + 2] = fmaf(sT[4 * n + 2], e.x, dS[4 * n + 2]);
          dS[4 * n + 3] = fmaf(sT[4 * n + 3], e.y, dS[4 * n + 3]);
        }
        if (a.P > 1 && c + 1 < a.nc) {
          // st.async: the bytes complete on the receiver's barrier (whose
          // expectation the receiver sets itself)
          const uint32_t dst = static_cast<uint32_t>((c + 1) % a.P);
          const uint32_t bar = hopper::mapa(in_state, dst);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            hopper::st_async(hopper::mapa(inbox + 4 * (i * WG + ct), dst),
                             make_float4(dS[4 * i], dS[4 * i + 1],
                                         dS[4 * i + 2], dS[4 * i + 3]),
                             bar);
        }
        // expect the state of this block's next chunk, off the chain's path
        if (a.P > 1 && c > 0 && c + a.P < a.nc && ct == 0)
          hopper::mbar_arrive_expect_tx(in_state, WG * 32 * 4);
        // y^T += S_in^T q^T: S_in^T from registers (n8 blocks 2 kk, 2 kk + 1
        // are k16 step kk), hi + lo, against q^T (K-major B), hi + lo; two
        // k16 steps' fragments at a time leave the registers room
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2) {
          uint32_t fh[2][4], fl[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              tc::split_bf2(sT[8 * (2 * k2 + i) + 2 * e],
                            sT[8 * (2 * k2 + i) + 2 * e + 1], fh[i][e],
                            fl[i][e]);
          hopper::wgmma_fence();
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int kk = 2 * k2 + i;
            hopper::wgmma_rs<bf16, 64, 0>(yT, fh[i], kstep(dqh, kk), 1);
            hopper::wgmma_rs<bf16, 64, 0>(yT, fh[i], kstep(dql, kk), 1);
            hopper::wgmma_rs<bf16, 64, 0>(yT, fl[i], kstep(dqh, kk), 1);
          }
          hopper::wgmma_commit();
          if (k2 == 0) hopper::wgmma_wait<0>();   // fh and fl are reused
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) sT[i] = dS[i];
      } else {
        // two slices (hd > 64) keep the whole walk in one block: the state
        // stays in sT from chunk to chunk.  Its registers leave room for one
        // k16 step's fragments at a time.
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hopper::wgmma_ss<bf16, 64, 0, 1>(yT, dv + kk * 128,
                                           kstep(dah, kk), kk > 0);
          hopper::wgmma_ss<bf16, 64, 0, 1>(yT, dv + kk * 128,
                                           kstep(dal, kk), 1);
        }
        hopper::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < 4 * MT; ++kk) {
          uint32_t fh[4], fl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tc::split_bf2(sT[8 * kk + 2 * e], sT[8 * kk + 2 * e + 1], fh[e],
                          fl[e]);
          hopper::wgmma_fence();
          hopper::wgmma_rs<bf16, 64, 0>(yT, fh, kstep(dqh, kk), 1);
          hopper::wgmma_rs<bf16, 64, 0>(yT, fh, kstep(dql, kk), 1);
          hopper::wgmma_rs<bf16, 64, 0>(yT, fl, kstep(dqh, kk), 1);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();   // fh and fl are reused
        }
        hopper::fence_regs(yT);
        // S^T's columns i decay by e_end_i over the chunk
#pragma unroll
        for (int n = 0; n < 8 * MT; ++n) {
          const float2 e = *reinterpret_cast<const float2*>(ee + 8 * n + 2 * q);
          sT[4 * n] *= e.x;
          sT[4 * n + 1] *= e.y;
          sT[4 * n + 2] *= e.x;
          sT[4 * n + 3] *= e.y;
        }
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hopper::wgmma_ss<bf16, 64 * MT, 1, 1>(sT, dv + kk * 128,
                                                dkh + kk * 128, 1);
          hopper::wgmma_ss<bf16, 64 * MT, 1, 1>(sT, dv + kk * 128,
                                                dkl + kk * 128, 1);
        }
        hopper::wgmma_commit();
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(yT);
      hopper::fence_regs(sT);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(c_empty + sc);   // the stage is free
      // y rows t0 + 8 n + 2 q + e0, columns j0 and j0 + 8: a pointer that
      // steps down the rows (loop-invariant offsets a row would be hoisted
      // out of the chunk loop, 64 bits each, and spill)
      const int left = a.S - c * L;
#pragma unroll
      for (int e0 = 0; e0 < 2; ++e0) {
        float* p = ybase + static_cast<long long>(c * L + 2 * q + e0) * yrow +
                   j0;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if (8 * n + 2 * q + e0 < left) {
            if (j0 < a.hd) p[0] = yT[4 * n + e0];
            if (j0 + 8 < a.hd) p[8] = yT[4 * n + 2 + e0];
          }
          p += 8 * yrow;
        }
      }
    }
    if (rho + (nk - 1) * a.P + 1 == a.nc) {   // the last chunk's block
      float* sl = a.s_last + sbase;
#pragma unroll
      for (int n = 0; n < 8 * MT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (s_in(n, e)) sl[s_at(n, e)] = sT[4 * n + e];
        asm volatile("" ::: "memory");
      }
    }
  
  }
  // no block leaves while another may still write into its inbox
  if (a.P > 1) hopper::cluster_sync();
}

// The tensor map of r, k, v (bf16, 128-byte swizzle) or logw (f32,
// unswizzled) over (hd, H, S, B), boxes of 64 channels x 1 x 64 rows x 1,
// from the view's element strides st (batch, seq, head).
inline cudaError_t encode(CUtensorMap* map, const void* ptr, bool f32, int B,
                          int S, int H, int hd, const long long* st) {
  const uint64_t dims[4] = {static_cast<uint64_t>(hd),
                            static_cast<uint64_t>(H),
                            static_cast<uint64_t>(S),
                            static_cast<uint64_t>(B)};
  const long long steps[3] = {st[2], st[1], st[0]};
  const uint32_t box[4] = {64, 1, L, 1};
  return hopper::encode_view(map, f32, 4, ptr, dims, steps, box);
}

template <int MT>
cudaError_t launch(const Args& a, const void* r, const void* k,
                   const void* v, const float* logw, const long long* st,
                   int B, int smem, cudaStream_t stream) {
  auto kernel = wkv_fwd_walk<MT>;
  static unsigned long long smem_set = 0;
  cudaError_t e = tc::allow_smem(kernel, SMEM_MAX, smem_set);
  if (e != cudaSuccess) return e;
  CUtensorMap maps[4];
  const void* views[4] = {r, k, v, logw};
  for (int i = 0; i < 4 && e == cudaSuccess; ++i)
    e = encode(&maps[i], views[i], i == 3, B, a.S, a.H, a.hd, st + 3 * i);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * a.H * a.P, 1, 1);
  cfg.blockDim = dim3(WG * (att_groups(MT) + MT), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], maps[3], a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace walk

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (r, k and v alike).
// strides: 12 element strides, (batch, seq, head) of r, k, v, then logw.
// s0 may be null (a zero state).  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int repro_torch_wkv6(const void* r, const void* k, const void* v,
                                const float* logw, const float* u,
                                const float* s0, float* y, float* s_last,
                                int dtype, int B, int S, int H, int hd,
                                const long long* strides, void* stream) {
  if (B < 1 || S < 1 || H < 1 || hd < 1 || hd > 128)
    return cudaErrorInvalidValue;
  Args args;
  args.r = r;
  args.k = k;
  args.v = v;
  args.w = logw;
  args.u = u;
  args.s0 = s0;
  args.y = y;
  args.s_last = s_last;
  args.S = S;
  args.H = H;
  args.hd = hd;
  for (int i = 0; i < 3; ++i) {
    args.rs[i] = strides[i];
    args.ks[i] = strides[3 + i];
    args.vs[i] = strides[6 + i];
    args.ws[i] = strides[9 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(args, B, s);
    case 1: return launch<__half>(args, B, s);
    case 2: return launch<__nv_bfloat16>(args, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// The most clusters of `cluster` blocks (the kernel at one slice and the
// shared memory of walk_geometry's stages) that fit on the current device
// at once, into *out; returns the CUDA error (0 on success).
extern "C" int repro_torch_wkv6_max_clusters(int cluster, int* out) {
  const int smem = walk::Layout(1, 2, 2, cluster).total;
  auto kernel = walk::wkv_fwd_walk<1>;
  static unsigned long long smem_set = 0;
  cudaError_t e = tc::allow_smem(kernel, walk::SMEM_MAX, smem_set);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(walk::WG * 3, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

// The Hopper path: bf16 r, k and v; hd a multiple of 16 up to 128.
// strides as above (each a positive multiple of 16 bytes where its dim is
// above 1; the data pointers on 16 bytes).  The launch geometry comes from
// the caller (kernels/wkv6.py walk_geometry): slices (consumer warpgroups,
// 64 columns of v each: 1, or 2 past hd 64), cluster (the blocks of a
// (batch, head), 1 to 8 and at most the chunks; 1 at two slices),
// stages_in and stages_c (1 or 2 each), smem_bytes (which must be
// walk::Layout's total), the grid (B H cluster, 1, 1) and threads (128 a
// warpgroup: the att warpgroup and the consumers).  s0 may be null.
// Issues one kernel on the stream; returns its launch error (0 on
// success), or cudaErrorInvalidValue for what it does not take.
extern "C" int repro_torch_wkv6_walk(const void* r, const void* k,
                                     const void* v, const float* logw,
                                     const float* u, const float* s0,
                                     float* y, float* s_last, int B, int S,
                                     int H, int hd, const long long* strides,
                                     int slices, int cluster, int stages_in,
                                     int stages_c, int smem_bytes, int grid_x,
                                     int grid_y, int grid_z, int threads,
                                     void* stream) {
  if (B < 1 || S < 1 || H < 1 || hd < 16 || hd % 16 || hd > 128)
    return cudaErrorInvalidValue;
  const int mt = hd > 64 ? 2 : 1;
  const int nc = (S + walk::L - 1) / walk::L;
  const long long items = static_cast<long long>(B) * H;
  if (slices != mt || cluster < 1 || cluster > 8 || cluster > nc ||
      (mt == 2 && cluster != 1) || stages_in < 1 || stages_in > 2 ||
      stages_c < 1 || stages_c > 2 ||
      smem_bytes != walk::Layout(mt, stages_in, stages_c, cluster).total ||
      smem_bytes > walk::SMEM_MAX || items * cluster > 0x7fffffffLL ||
      grid_x != items * cluster || grid_y != 1 || grid_z != 1 ||
      threads != walk::WG * (walk::att_groups(mt) + mt))
    return cudaErrorInvalidValue;
  walk::Args args;
  args.u = u;
  args.s0 = s0;
  args.y = y;
  args.s_last = s_last;
  args.S = S;
  args.H = H;
  args.hd = hd;
  args.nc = nc;
  args.sin = stages_in;
  args.sc = stages_c;
  args.P = cluster;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mt == 2 ? walk::launch<2>(args, r, k, v, logw, strides, B,
                                   smem_bytes, s)
                 : walk::launch<1>(args, r, k, v, logw, strides, B,
                                   smem_bytes, s);
}
