// Grouped matmul for the MoE experts on Hopper (sm_90a), plain CUDA C++.
//
// Replaces the JAX package's Pallas TPU kernel kernels/moe_gmm.py:_gmm_kernel
// (launched by gmm).  For every expert e:
//   out[e] = x[e] @ w[e],   x (E,C,D), w (E,D,F) -> out (E,C,F)
// with the sum over D in f32 and the result written in x's type (f32, f16
// or bf16; x and w share it).  In the model, x is an expert's bucket of
// routed tokens (C = its capacity) and w one of the expert's three
// matrices: gate and up (D = d_model, F = d_ff), then out (D and F
// swapped).
//
// Layout: x and w are read through their strides in elements (expert and
// row; the last axis has unit stride), so one group's (E,D,F) slice of the
// stacked (G,E,D,F) weights, or any strided view of them, goes in without
// a copy.  out is contiguous.  For f16/bf16 the base pointers and the
// strides must be 16-byte aligned (the wrapper checks): every load below is
// 16 bytes.  Ragged C, D and F (the model's capacities, 200 in a 512-token
// prefill and 2 in a 4-slot decode step, divide no tile; the Pallas kernel
// asserts that they do) cost no branch in the product loops: rows and
// columns past the edge are zero-filled by the copies.
//
// Bound on an H100 (bf16, 3.35 TB/s, 989 TFLOP/s): at granite-moe's
// prefill (E 32, C 200, D 1024, F 512) 53.2 MB for 6.71 GFLOP: 15.9 us,
// bytes; at its decode step (C 2) the 33.6 MB of weights, 10.1 us, bytes.
// Both buckets are bytes-bound, so what counts is that each expert's w is
// read from HBM once and streams at the card's rate.  The path follows
// from the dtype and C, never from a failure:
//
// * f16/bf16, C > GEMV_MAX_C: gmm_fwd_mma, tensor cores.  One block of 8
//   warps owns a 128 x 128 output tile of one expert and walks D in steps
//   of 64 through a ring of 3 shared-memory stages (105 KB, two blocks an
//   SM) filled by 16-byte cp.async.cg copies (x rows k-contiguous, w rows
//   n-contiguous, both padded by 16 bytes so the ldmatrix reads hit 32
//   banks).  Each warp multiplies a 32 x 64 sub-tile with mma.sync
//   m16n8k16 (f32 accumulators in registers); w's B fragments come through
//   ldmatrix.trans.  An m16 row strip past C skips its products (C = 200
//   pays for 208 rows, not 256), and the warps of one row slab sit on
//   neighbouring schedulers, so the idle strips of the last C tile are
//   spread over the SM.  The tile leaves through shared memory in 16-byte
//   stores.  The grid is ordered so that the C tiles of one (expert, F
//   tile) are neighbours and share w through L2.  At granite's prefill
//   bucket it does about 190 TFLOP/s of useful work, 2.2x its byte bound;
//   wgmma fed by TMA, Hopper's route to the full tensor-core rate, is the
//   next step.
// * f16/bf16, C <= GEMV_MAX_C: gmm_fwd_gemv, a batched GEMV on the CUDA
//   cores (2 C multiply-adds per 2-byte weight are far below the card's
//   f32 rate).  One block of 512 threads owns 64 (or 128) columns of one
//   expert: 8 (16) threads read a row's 128 (256) bytes with 16-byte
//   loads, 64 (32) such row lanes split D, and each keeps 4 to 8 loads in
//   flight (the next batch is issued before this one is used); x is copied
//   into shared memory by cp.async while the first batch flies; the row
//   lanes' partial sums meet through shuffles and shared memory.  The
//   wider blocks are taken where the narrow ones would need more than one
//   wave of two blocks an SM: granite's gate/up runs 256 blocks of 64
//   columns, its out product 256 of 128.
// * f32: gmm_fwd, the CUDA-core kernel of the first port: one block of
//   256 threads per 64 x 64 output tile, D in tiles of 32 staged through
//   shared memory, a 4x4 f32 micro-tile a thread.  TF32 would not hold
//   the f32 contract (1e-5 of the output's scale).
//
// Every path reads every expert's weights, whether its bucket holds
// tokens or not; skipping empty buckets needs per-expert row counts and is
// the next step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "mma_sm80.cuh"

namespace {

struct Args {
  const void* x;
  const void* w;
  void* out;
  int C, D, F;
  long long xs_e, xs_c;  // x strides (expert, row of C)
  long long ws_e, ws_d;  // w strides (expert, row of D)
};

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

// ---------------------------------------------------------------- f16/bf16,
// tensor cores

constexpr int TBM = 128;         // rows of C per block
constexpr int TBN = 128;         // columns of F per block
constexpr int TBK = 64;          // depth of one stage
constexpr int STAGES = 3;
constexpr int WARPS_M = 4;       // warps along M
constexpr int WARPS_N = 2;       // warps along N
constexpr int TNT = 32 * WARPS_M * WARPS_N;
constexpr int MS = TBM / WARPS_M / 16;   // m16 strips a warp
constexpr int NP = TBN / WARPS_N / 16;   // pairs of n8 tiles a warp
constexpr int MIN_BLOCKS = TNT >= 512 ? 1 : 2;
constexpr int ALD = TBK + 8;     // padded x row in a stage (+16 bytes)
constexpr int BLD = TBN + 8;     // padded w row in a stage (+16 bytes)
constexpr int CLD = TBN + 8;     // padded output row (the epilogue)
constexpr int A_STAGE = TBM * ALD;
constexpr int B_STAGE = TBK * BLD;
constexpr int MMA_SMEM = STAGES * (A_STAGE + B_STAGE) * 2;  // bytes
constexpr int A_LOADS = TBM * TBK / 8 / TNT;  // 16-byte chunks a thread
constexpr int B_LOADS = TBK * TBN / 8 / TNT;  // copies a stage

static_assert(A_LOADS * TNT * 8 == TBM * TBK && B_LOADS * TNT * 8 == TBK * TBN,
              "x and w stages are whole chunks a thread");
static_assert(MS >= 1 && MS <= 4 && NP >= 1, "warp tiles of 16-64 rows");
static_assert(TBM * CLD <= STAGES * (A_STAGE + B_STAGE),
              "the output tile fits in the stages");

// One stage: x rows [m0, m0 + TBM) and w columns [n0, n0 + TBN) at depth
// k0, zero past C, D and F.
template <typename T>
__device__ __forceinline__ void load_stage(T* As, T* Bs, const T* x,
                                           const T* w, const Args& a,
                                           int m0, int n0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < A_LOADS; ++i) {
    const int c = tid + i * TNT;
    const int r = c / (TBK / 8), kc = c % (TBK / 8) * 8;
    const int m = m0 + r, k = k0 + kc;
    const bool in = m < a.C && k < a.D;
    tc::cp_async16(As + r * ALD + kc, in ? x + m * a.xs_c + k : x,
                   in ? min(8, a.D - k) * 2 : 0);
  }
#pragma unroll
  for (int i = 0; i < B_LOADS; ++i) {
    const int c = tid + i * TNT;
    const int kr = c / (TBN / 8), nc = c % (TBN / 8) * 8;
    const int kk = k0 + kr, n = n0 + nc;
    const bool in = kk < a.D && n < a.F;
    tc::cp_async16(Bs + kr * BLD + nc, in ? w + kk * a.ws_d + n : w,
                   in ? min(8, a.F - n) * 2 : 0);
  }
}

// One stage's products for a warp's first NS m16 strips (rows
// wm * 16 MS + 16 i) and its 16 NP columns: per k16 step, the strips' A
// fragments and NP x4.trans B fragments, then 2 NS NP mma.sync.
template <typename T, int NS>
__device__ __forceinline__ void mma_stage(float (&acc)[MS][2 * NP][4],
                                          const T* as, const T* bs, int wm,
                                          int wn, int lr, int lc) {
#pragma unroll
  for (int ks = 0; ks < TBK; ks += 16) {
    uint32_t af[NS][4], bf[NP][4];
#pragma unroll
    for (int i = 0; i < NS; ++i)
      tc::ldmatrix_x4(af[i],
                      as + (wm * 16 * MS + i * 16 + lr) * ALD + ks + lc);
#pragma unroll
    for (int np = 0; np < NP; ++np)
      tc::ldmatrix_x4_trans(
          bf[np], bs + (ks + lr) * BLD + (wn * NP + np) * 16 + lc);
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        tc::mma16816<T>(acc[i][2 * np], af[i], bf[np][0], bf[np][1]);
        tc::mma16816<T>(acc[i][2 * np + 1], af[i], bf[np][2], bf[np][3]);
      }
  }
}

// mma_stage for the warp's `strips` strips (warp-uniform: no divergence);
// none when it is 0.
template <typename T, int NS>
__device__ __forceinline__ void mma_strips(int strips,
                                           float (&acc)[MS][2 * NP][4],
                                           const T* as, const T* bs, int wm,
                                           int wn, int lr, int lc) {
  if (strips == NS)
    mma_stage<T, NS>(acc, as, bs, wm, wn, lr, lc);
  else if constexpr (NS > 1)
    mma_strips<T, NS - 1>(strips, acc, as, bs, wm, wn, lr, lc);
}

template <typename T>
__global__ void __launch_bounds__(TNT, MIN_BLOCKS)
    gmm_fwd_mma(Args a, int m_tiles, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + STAGES * A_STAGE;
  const int mt = blockIdx.x % m_tiles;             // C tiles are neighbours
  const int nt = (blockIdx.x / m_tiles) % n_tiles;
  const int e = blockIdx.x / (m_tiles * n_tiles);
  const int m0 = mt * TBM, n0 = nt * TBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // neighbouring warps share a row slab, so the slabs spread over the SM's
  // 4 schedulers (warp % 4) and rows past C idle none of them wholly
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const T* x = static_cast<const T*>(a.x) + (long long)e * a.xs_e;
  const T* w = static_cast<const T*>(a.w) + (long long)e * a.ws_e;
  // m16 strips of this warp below C (the others only copy)
  const int strips = min(MS, max(0, (a.C - m0 - wm * 16 * MS + 15) / 16));

  float acc[MS][2 * NP][4];
#pragma unroll
  for (int i = 0; i < MS; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int k_tiles = (a.D + TBK - 1) / TBK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles)
      load_stage(As + s * A_STAGE, Bs + s * B_STAGE, x, w, a, m0, n0,
                 s * TBK, tid);
    tc::cp_async_commit();
  }

  // ldmatrix lane offsets: A rows (l % 8) + 8 ((l / 8) % 2), k 8 (l / 16);
  // B k rows the same, n 8 (l / 16)
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;

  for (int kt = 0; kt < k_tiles; ++kt) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();                 // stage kt landed; kt - 1 is consumed
    const int nxt = kt + STAGES - 1;
    if (nxt < k_tiles)
      load_stage(As + (nxt % STAGES) * A_STAGE, Bs + (nxt % STAGES) * B_STAGE,
                 x, w, a, m0, n0, nxt * TBK, tid);
    tc::cp_async_commit();
    const T* as = As + (kt % STAGES) * A_STAGE;
    const T* bs = Bs + (kt % STAGES) * B_STAGE;
    mma_strips<T, MS>(strips, acc, as, bs, wm, wn, lr, lc);
  }
  tc::cp_async_wait<0>();

  // The tile goes out through shared memory (the stages are free now), so
  // that each row leaves in 16-byte stores.
  __syncthreads();
  T* Cs = As;                                      // [TBM][CLD]
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < MS; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2 * NP; ++j)
        *reinterpret_cast<uint32_t*>(
            Cs + (wm * 16 * MS + i * 16 + g + h * 8) * CLD + wn * 16 * NP
            + j * 8 + 2 * q) =
            tc::pack2<T>(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  __syncthreads();
  T* out = static_cast<T*>(a.out) + (long long)e * a.C * a.F;
  const bool vec = a.F % 8 == 0;
  for (int c = tid; c < TBM * TBN / 8; c += TNT) {
    const int r = c / (TBN / 8), col = c % (TBN / 8) * 8;
    const int m = m0 + r, n = n0 + col;
    if (m >= a.C || n >= a.F) continue;
    const T* src = Cs + r * CLD + col;
    T* dst = out + (long long)m * a.F + n;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < min(8, a.F - n); ++j) dst[j] = src[j];
    }
  }
}

// ---------------------------------------------------------------- f16/bf16,
// small C: batched GEMV

constexpr int GEMV_MAX_C = 8;
constexpr int GV_NT = 512;
constexpr int GV_U = 4;                  // 16-byte loads a thread a batch
constexpr int GV_SMEM_MAX = 48 * 1024;   // no opt-in needed below this

// x's rows padded to 8 elements (2 bytes each), then the partial sums of
// the warps, 8 G columns each
__host__ __device__ constexpr int gemv_smem(int cr, int G, int D) {
  return cr * ((D + 7) / 8 * 8) * 2 + (GV_NT / 32) * cr * 8 * G * 4;
}

template <typename T>
__device__ __forceinline__ uint4 load8(const T* p, int valid) {
  if (valid >= 8) return __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  uint32_t v[4] = {0u, 0u, 0u, 0u};  // the ragged last column group
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < valid) v[j / 2] |= static_cast<uint32_t>(h[j]) << (16 * (j % 2));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// One batch: rows d0 + lanes u of the thread's 8 columns, zero past D.
template <typename T>
__device__ __forceinline__ void load_batch(uint4 (&v)[GV_U], const T* w,
                                           const Args& a, int d0, int lanes,
                                           int n, int valid) {
#pragma unroll
  for (int u = 0; u < GV_U; ++u) {
    const int d = d0 + u * lanes;
    v[u] = d < a.D ? load8(w + d * a.ws_d + n, valid) : make_uint4(0, 0, 0, 0);
  }
}

// One block owns 8 G columns of one expert: G threads side by side read
// one row's 16 G bytes, GV_NT / G such row lanes split D.
template <typename T, int CR, int G>
__global__ void __launch_bounds__(GV_NT) gmm_fwd_gemv(Args a) {
  constexpr int LANES = GV_NT / G, COLS = 8 * G;
  static_assert(G == 8 || G == 16, "a warp holds 32 / G row lanes");
  extern __shared__ __align__(16) unsigned char gsm_raw[];
  const int DP = (a.D + 7) / 8 * 8;
  T* xs = reinterpret_cast<T*>(gsm_raw);                 // [CR][DP]
  float* red = reinterpret_cast<float*>(xs + CR * DP);   // [warp][CR][COLS]
  const int e = blockIdx.y, n0 = blockIdx.x * COLS;
  const int tid = threadIdx.x, cg = tid % G, rl = tid / G;
  const T* x = static_cast<const T*>(a.x) + (long long)e * a.xs_e;
  const T* w = static_cast<const T*>(a.w) + (long long)e * a.ws_e;

  // x's rows (zero past C and D) copy into shared memory while the first
  // batch of weights is in flight
  for (int i = tid; i < CR * (DP / 8); i += GV_NT) {
    const int c = i / (DP / 8), k = i % (DP / 8) * 8;
    const bool in = c < a.C;
    tc::cp_async16(xs + c * DP + k, in ? x + c * a.xs_c + k : x,
                   in ? min(8, a.D - k) * 2 : 0);
  }
  tc::cp_async_commit();

  float acc[CR][8];
#pragma unroll
  for (int c = 0; c < CR; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[c][j] = 0.f;
  const int n = n0 + cg * 8, valid = a.F - n;
  constexpr int STEP = LANES * GV_U;
  uint4 cur[GV_U], nxt[GV_U];
  if (valid > 0) load_batch(cur, w, a, rl, LANES, n, valid);
  tc::cp_async_wait<0>();
  __syncthreads();
  if (valid > 0) {
    for (int d0 = rl; d0 < a.D; d0 += STEP) {
      if (d0 + STEP < a.D) load_batch(nxt, w, a, d0 + STEP, LANES, n, valid);
#pragma unroll
      for (int u = 0; u < GV_U; ++u) {
        const int d = d0 + u * LANES;
        if (d < a.D) {
          float f[8];
          tc::unpack8<T>(cur[u], f);
#pragma unroll
          for (int c = 0; c < CR; ++c) {
            const float xv = to_f(xs[c * DP + d]);
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[c][j] = fmaf(xv, f[j], acc[c][j]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < GV_U; ++u) cur[u] = nxt[u];
    }
  }
  // lanes l, l ^ G, ... of a warp hold one column group's row lanes
#pragma unroll
  for (int c = 0; c < CR; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int off = G; off < 32; off *= 2)
        acc[c][j] += __shfl_xor_sync(0xffffffffu, acc[c][j], off);
  const int lane = tid & 31, warp = tid >> 5;
  if (lane < G)
#pragma unroll
    for (int c = 0; c < CR; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        red[(warp * CR + c) * COLS + lane * 8 + j] = acc[c][j];
  __syncthreads();
  T* out = static_cast<T*>(a.out) + (long long)e * a.C * a.F;
  for (int i = tid; i < CR * COLS; i += GV_NT) {
    const int c = i / COLS, col = n0 + i % COLS;
    if (c >= a.C || col >= a.F) continue;
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < GV_NT / 32; ++wp)
      s += red[(wp * CR + c) * COLS + i % COLS];
    out[(long long)c * a.F + col] = from_f<T>(s);
  }
}

// ---------------------------------------------------------------- f32,
// CUDA cores (the first port's kernel)

constexpr int BM = 64;     // rows of C per block
constexpr int BN = 64;     // columns of F per block
constexpr int BK = 32;     // depth of one D tile
constexpr int NT = 256;    // threads per block: a 16 x 16 grid
constexpr int PER = BM * BK / NT;  // x (and w) tile elements each thread loads

static_assert(BM * BK == BK * BN && PER == 8, "tiles are 8 loads a thread");
static_assert(BM == 64 && BN == 64 && NT == 256, "4x4 outputs a thread");

// Loads the D tile at k0: x rows [m0, m0 + rows) and w columns [n0, n0+BN),
// zero outside the matrices.  Element i of a thread is tile index
// tid + i * NT: x (row idx / BK, depth idx % BK), w (depth idx / BN,
// column idx % BN), so a warp reads 32 consecutive elements of one row.
__device__ __forceinline__ void load_tile(const float* x, const float* w,
                                          const Args& a, int m0, int rows,
                                          int n0, int k0, int tid,
                                          float (&ra)[PER], float (&rb)[PER]) {
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = tid + i * NT;
    const int m = idx / BK, k = k0 + idx % BK;
    ra[i] = (m < rows && k < a.D) ? x[(long long)(m0 + m) * a.xs_c + k] : 0.f;
    const int kk = k0 + idx / BN, n = n0 + idx % BN;
    rb[i] = (kk < a.D && n < a.F) ? w[(long long)kk * a.ws_d + n] : 0.f;
  }
}

__global__ void __launch_bounds__(NT, 2) gmm_fwd(Args a) {
  __shared__ float As[BM][BK + 1];   // padded: a warp reads two rows at once
  __shared__ float Bs[BK][BN];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int rows = min(BM, a.C - m0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* x = static_cast<const float*>(a.x) + (long long)e * a.xs_e;
  const float* w = static_cast<const float*>(a.w) + (long long)e * a.ws_e;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  float ra[PER], rb[PER];
  load_tile(x, w, a, m0, rows, n0, 0, tid, ra, rb);
  for (int k0 = 0; k0 < a.D; k0 += BK) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = tid + i * NT;
      As[idx / BK][idx % BK] = ra[i];
      Bs[idx / BN][idx % BN] = rb[i];
    }
    __syncthreads();
    if (k0 + BK < a.D)  // the next tile's loads fly during these products
      load_tile(x, w, a, m0, rows, n0, k0 + BK, tid, ra, rb);
    if (ty < rows) {     // whole warps past the tile's last row skip this
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        float b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (ty + 16 * i < rows) {
            const float av = As[ty + 16 * i][k];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }

  float* out = static_cast<float*>(a.out) + ((long long)e * a.C + m0) * a.F;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty + 16 * i;
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < a.F) out[(long long)m * a.F + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------- launch

cudaError_t launch_f32(const Args& a, int E, cudaStream_t stream) {
  if (a.C > 65535 * BM) return cudaErrorInvalidValue;
  const dim3 grid((a.F + BN - 1) / BN, (a.C + BM - 1) / BM, E);
  gmm_fwd<<<grid, NT, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int CR, int G>
cudaError_t launch_gemv(const Args& a, int E, cudaStream_t stream) {
  const dim3 grid((a.F + 8 * G - 1) / (8 * G), E);
  gmm_fwd_gemv<T, CR, G><<<grid, GV_NT, gemv_smem(CR, G, a.D), stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int CR>
cudaError_t launch_gemv_cr(const Args& a, int E, bool wide,
                           cudaStream_t stream) {
  return wide ? launch_gemv<T, CR, 16>(a, E, stream)
              : launch_gemv<T, CR, 8>(a, E, stream);
}

template <typename T>
cudaError_t launch_tc(const Args& a, int E, cudaStream_t stream) {
  const int cr = a.C <= 1 ? 1 : a.C <= 2 ? 2 : a.C <= 4 ? 4 : 8;
  if (a.C <= GEMV_MAX_C) {
    // 128 columns a block where 64 would need more than one wave of two
    // blocks an SM (granite's out product: 512 blocks of 64 columns)
    int sms = 0;
    const cudaError_t err = tc::sm_count(&sms);
    if (err != cudaSuccess) return err;
    const bool wide = (long long)E * ((a.F + 63) / 64) > 2LL * sms &&
                      gemv_smem(cr, 16, a.D) <= GV_SMEM_MAX;
    if (wide || gemv_smem(cr, 8, a.D) <= GV_SMEM_MAX) {
      switch (cr) {
        case 1: return launch_gemv_cr<T, 1>(a, E, wide, stream);
        case 2: return launch_gemv_cr<T, 2>(a, E, wide, stream);
        case 4: return launch_gemv_cr<T, 4>(a, E, wide, stream);
        default: return launch_gemv_cr<T, 8>(a, E, wide, stream);
      }
    }
  }
  static unsigned long long smem_set = 0;
  const cudaError_t err = tc::allow_smem(gmm_fwd_mma<T>, MMA_SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int m_tiles = (a.C + TBM - 1) / TBM, n_tiles = (a.F + TBN - 1) / TBN;
  const long long blocks = (long long)E * m_tiles * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  gmm_fwd_mma<T><<<static_cast<unsigned>(blocks), TNT, MMA_SMEM, stream>>>(
      a, m_tiles, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (x, w and out alike).
// strides: 4 element strides: x (expert, row of C), w (expert, row of D);
// the last axis of each has unit stride.  out (E,C,F) is contiguous.
// Returns cudaGetLastError() after the launch (0 on success); launches
// nothing when E, C or F is 0.
extern "C" int repro_torch_gmm(const void* x, const void* w, void* out,
                               int dtype, int E, int C, int D, int F,
                               const long long* strides, void* stream) {
  if (E < 0 || C < 0 || D < 0 || F < 0 || E > 65535)
    return cudaErrorInvalidValue;
  if (E == 0 || C == 0 || F == 0) return cudaSuccess;
  Args args;
  args.x = x;
  args.w = w;
  args.out = out;
  args.C = C;
  args.D = D;
  args.F = F;
  args.xs_e = strides[0];
  args.xs_c = strides[1];
  args.ws_e = strides[2];
  args.ws_d = strides[3];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_f32(args, E, s);
    case 1: return launch_tc<__half>(args, E, s);
    case 2: return launch_tc<__nv_bfloat16>(args, E, s);
    default: return cudaErrorInvalidValue;
  }
}
