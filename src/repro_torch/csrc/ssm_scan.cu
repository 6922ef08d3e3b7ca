// Chunked Mamba2 SSD scan for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/ssm_scan.py:_ssd_kernel (launched by ssd_scan).  Per (batch b,
// head h), with a < 0, dt_t > 0 and the state h (hd, N):
//   h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T,      y_t = h_t C_t
// computed chunk by chunk.  Inside a chunk, with cum_t the running sum of
// dt_s a over the chunk's rows s <= t:
//   y_t  = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//        + exp(cum_t) h C_t                           (the carried state)
//   h'   = exp(cum_end) h + sum_s exp(cum_end - cum_s) dt_s x_s B_s^T
// Every decay is an exp of a difference of cumulative logs with s <= t (or
// a product of two such), so no exponent is positive; pairs with s > t
// never reach an exp.
//
// Layout: x (B,S,H,hd) in f32/f16/bf16, dt (B,S,H) f32, B and C (B,S,N) in
// x's type, each given by its strides in elements with a unit stride on
// the last axis, so the model's projections are read in place; B and C are
// shared by all heads and read with no per-head copy (the Pallas wrapper
// broadcasts them).  a (H,) f32.  h0 (B,H,hd,N) f32 or null (zeros).
// Outputs y (B,S,H,hd) f32 and h_last (B,H,hd,N) f32, contiguous: the
// decode cache's layout (the Pallas scratch is (N, hd)).  The Pallas grid
// is (batch*heads, chunks) with the chunk axis sequential and the state in
// VMEM scratch; on Hopper nothing carries over between blocks, so each
// block walks its own chunks in order, keeping the state on chip.
//
// Bound on an H100 at zamba2's prefill (B=1, S=512, H=80, hd=64, N=64,
// bf16 x/B/C): about 17.3 MB in and out, 5.2 us at 3.35 TB/s; the
// recurrence's 5 hd N operations a token and head are 0.84 GFLOP, 0.85 us
// on the tensor cores (12.5 us at f32's 67 TFLOP/s on the CUDA cores).  At
// its train forward (B=2, S=1024) 66.7 MB, 20 us.  So the bytes bound it,
// and a kernel near the bound has to keep the card busy on a problem of
// 17 MB: enough blocks, a short serial chain in each.
//
// bf16 with hd and N multiples of 16 up to 128: ssd_fwd_walk, one launch a
// call.  Its work is items of (batch b, head h, a slice of DSL columns of
// hd): y[:, d] and h[d, :] depend on column d of x alone, so slices are
// independent.  A block walks an item's 64-row chunks in order with the
// slice's state H^T (N x DSL, f32) in the accumulators of one consumer
// warpgroup; nothing of the state goes to device memory between chunks.
// Per chunk, with cum the chunk's cumulative log decay:
//   S   = C B^T                         wgmma m64n64, C and B K-major
//   G   = S exp(cum_t - cum_s) dt_s     s <= t, in registers
//   y   = exp(cum_t) C H_in^T + G x     C H_in^T: wgmma with H_in^T
//                                       written by the warpgroup to shared
//                                       memory (MN-major, by stmatrix); G x:
//                                       G from registers, x MN-major
//   H^T = exp(cum_end) H^T + B^T (w x)  w_s = exp(cum_end - cum_s) dt_s; B
//                                       an M-major A, w x MN-major
// with N > 64 as two m64 tiles of H^T (and of S's K), N < 64 padded to 64
// by TMA's zero fill (K runs over N rounded up to 64, so no product is
// conditional).  x, B and C are exact bf16 operands; G, H_in^T and w x are
// f32, and rounding them to bf16 (2^-8) or TF32 (2^-11) would break the
// 1e-4 tolerance, so each goes in as a hi + lo pair of bf16 (two products,
// about 2^-17 of the value; tc::split_bf2).  With one state tile, C H_in^T
// takes hi and lo in one product of width 2 DSL (the lo tile is the next
// column block of the operand), so C is read once.
//   G's decays: a 16-row block of t below the diagonal block of its
// columns factors about r, the columns' last row (s <= r < t), as
// exp(cum_t - cum_r) v_s with v_s = exp(cum_r - cum_s) dt_s, two exps a
// thread and block; the diagonal block takes one exp a pair, masked before
// it.  Every factor is at most 1.  The code is compiled for each warp (the
// causal triangle gives warp w w + 1 blocks).  Exps are ex2.approx.ftz of
// the argument times log2(e): about 2^-22 of the value, plus |argument|
// 2^-24 from the argument's rounding.
//   Warps: a producer (warp 4) issues each chunk's TMA boxes into a ring of
// stages and computes its scalars beside them (dt; cum by a warp scan of
// dt a in the reference's order of roundings; v; w; exp(cum)): C and B
// through rank-3 maps over (N, S, B) in boxes of 64 x 64 (128-byte swizzle;
// N = 128 takes two), x through a rank-4 map over (hd, H, S, B) in boxes of
// DSL x 1 x 64 x 1, each with the view's own byte strides; TMA zero-fills
// the rows past S and the columns past N, so a ragged last chunk and S < 16
// take no other path.  Warp 5 writes each stage's w x (hi and lo) once the
// boxes and scalars are in.  The stages complete on mbarriers (boxes and
// scalars; w x) and are freed by the consumers' arrivals.  The block's
// first boxes are issued before the block meets at __syncthreads.
//   Overlap, per chunk in one commit order: G x, the next chunk's S, then
// C H_in^T and the state's update; once G x and S are done, the next
// chunk's G is built while the state's products run.  The next chunk's
// H_in^T goes to the other of two buffers, so the consumer warps meet at
// one named barrier a chunk.
//   Geometry (kernels/ssm_scan.py walk_geometry, passed in and checked
// here): DSL 32 where hd allows it, there is an item for every SM and two
// blocks fit an SM's shared memory (at two stages; not at hd and N 128),
// else 16; stages: 3 where two blocks of them fit, else 2; the grid:
// min(items, 2 SMs) blocks of 192 threads (two an SM, 168 registers),
// which take the items in turn, the ring's stages and parities running on
// from item to item.  zamba2's prefill runs 160 items on 160 blocks; its
// train forward 320 items on 264, the 56 left over on SMs whose other
// block is done (faster than a grid of one block an item).  Measured at
// those shapes: DSL 16 and two stages are slower; so were DSL 64 at one
// block an SM, the w x built by consumer warps, rows permuted among the warps to even out the causal
// triangle (C in 8-row boxes), and the producer on warp 5 (PERF.md).
// ptxas 12.9 crashes on a proxy fence between the first S's issue and its
// wait, so H_in^T is written before that S.
//
// f32, f16, and widths the path does not take: ssd_fwd, the CUDA-core
// kernel of the first port.  One block owns one (batch, head, slice of
// DS = 16 columns of hd): y[:, d] and h[d, :] depend on column d of x
// alone, so the block keeps its (DS, N) slice of the state in shared
// memory and walks the chunks in order.  Per chunk of L = 64 rows it
// stages B, C, dt and its x columns as f32, takes the cumulative sum
// serially, builds G(t,s) with 4x4 register tiles, then y, then the state
// update, all in f32 FMA (TF32 or a 16-bit split would not hold f32's
// tolerance; f16's range does not hold the split's lo parts).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"
#include "mma_sm80.cuh"

namespace {

constexpr int L = 64;      // chunk rows
constexpr int DS = 16;     // hd columns per block
constexpr int NT = 256;    // threads per block
constexpr int GP = L + 1;  // padded row of G

static_assert(L == 64 && NT == 256, "G tiles are 4x4 on a 16x16 thread grid");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Args {
  const void* x;
  const float* dt;
  const float* a;
  const void* B;
  const void* C;
  const float* h0;  // may be null
  float* y;
  float* h_last;
  int S, H, hd, N;
  long long xs[3];   // x (batch, seq, head) strides
  long long dts[3];  // dt (batch, seq, head) strides
  long long bs[2];   // B (batch, seq) strides
  long long cs[2];   // C (batch, seq) strides
};

int smem_floats(int N) {
  const int NP = N + 1;
  return 2 * L * NP + L * GP + L * DS + DS * NP + 3 * L;
}

template <typename T>
__global__ void __launch_bounds__(NT) ssd_fwd(Args a) {
  extern __shared__ float smem[];
  const int N = a.N, NP = N + 1;
  float* sB = smem;               // [L][NP]
  float* sC = sB + L * NP;        // [L][NP]
  float* sG = sC + L * NP;        // [L][GP]
  float* sX = sG + L * GP;        // [L][DS]
  float* sH = sX + L * DS;        // [DS][NP] this block's state columns
  float* sCum = sH + DS * NP;     // [L]
  float* sDt = sCum + L;          // [L]
  float* sW = sDt + L;            // [L] exp(cum_end - cum_s) dt_s

  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * DS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nd = min(DS, a.hd - d0);
  const float A = a.a[h];
  const T* xp = static_cast<const T*>(a.x) + b * a.xs[0] + h * a.xs[2] + d0;
  const float* dtp = a.dt + b * a.dts[0] + h * a.dts[2];
  const T* Bp = static_cast<const T*>(a.B) + b * a.bs[0];
  const T* Cp = static_cast<const T*>(a.C) + b * a.cs[0];
  const long long y_row = static_cast<long long>(a.H) * a.hd;
  float* yp = a.y + static_cast<long long>(b) * a.S * y_row +
              static_cast<long long>(h) * a.hd + d0;
  const long long h_off = (static_cast<long long>(b) * a.H + h) * a.hd + d0;

  for (int idx = tid; idx < DS * N; idx += NT) {
    const int d = idx / N, n = idx % N;
    sH[d * NP + n] =
        (a.h0 != nullptr && d < nd) ? a.h0[(h_off + d) * N + n] : 0.f;
  }

  for (int t0 = 0; t0 < a.S; t0 += L) {
    const int lc = min(L, a.S - t0);
    __syncthreads();  // the last chunk's reads of sB/sC/sG/sX/sW are done
    for (int idx = tid; idx < L * N; idx += NT) {
      const int r = idx / N, n = idx % N;
      const bool in = r < lc;
      sB[r * NP + n] = in ? to_f(Bp[(t0 + r) * a.bs[1] + n]) : 0.f;
      sC[r * NP + n] = in ? to_f(Cp[(t0 + r) * a.cs[1] + n]) : 0.f;
    }
    for (int idx = tid; idx < L * DS; idx += NT) {
      const int r = idx / DS, d = idx % DS;
      sX[idx] = (r < lc && d < nd) ? to_f(xp[(t0 + r) * a.xs[1] + d]) : 0.f;
    }
    if (tid < L) sDt[tid] = tid < lc ? dtp[(t0 + tid) * a.dts[1]] : 0.f;
    __syncthreads();
    if (tid == 0) {  // serial, in the order of the reference's cumsum
      float c = 0.f;
      for (int r = 0; r < L; ++r) {
        if (r < lc) c += __fmul_rn(sDt[r], A);   // da = dt a, rounded
        sCum[r] = c;
      }
    }
    __syncthreads();
    const float cend = sCum[lc - 1];
    if (tid < L) sW[tid] = tid < lc ? expf(cend - sCum[tid]) * sDt[tid] : 0.f;

    // G(t,s) = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t < lc, else 0.
    {
      const int tr = tid >> 4, tc = tid & 15;
      float g[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) g[r][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = sC[(tr * 4 + r) * NP + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = sB[(tc + 16 * c) * NP + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[r][c] = fmaf(cv[r], bv[c], g[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = tr * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int s = tc + 16 * c;
          float val = 0.f;
          if (s <= t && t < lc) val = g[r][c] * expf(sCum[t] - sCum[s]) * sDt[s];
          sG[t * GP + s] = val;
        }
      }
    }
    __syncthreads();

    // y_t[d] = sum_{s<=t} G(t,s) x_s[d] + exp(cum_t) sum_n C_t[n] h[d][n]
    {
      const int d = tid % DS;
      for (int t = tid / DS; t < lc; t += NT / DS) {
        float acc = 0.f;
        for (int s = 0; s <= t; ++s) acc = fmaf(sG[t * GP + s], sX[s * DS + d], acc);
        float carry = 0.f;
        for (int n = 0; n < N; ++n) carry = fmaf(sC[t * NP + n], sH[d * NP + n], carry);
        acc = fmaf(expf(sCum[t]), carry, acc);
        if (d < nd) yp[(t0 + t) * y_row + d] = acc;
      }
    }
    __syncthreads();  // every read of the old state is done

    // h[d][n] = exp(cum_end) h[d][n] + sum_s exp(cum_end - cum_s) dt_s x_s[d] B_s[n]
    {
      const float eend = expf(cend);
      for (int idx = tid; idx < DS * N; idx += NT) {
        const int d = idx / N, n = idx % N;
        float acc = 0.f;
        for (int s = 0; s < lc; ++s)
          acc = fmaf(sW[s] * sX[s * DS + d], sB[s * NP + n], acc);
        sH[d * NP + n] = fmaf(eend, sH[d * NP + n], acc);
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < DS * N; idx += NT) {
    const int d = idx / N, n = idx % N;
    if (d < nd) a.h_last[(h_off + d) * N + n] = sH[d * NP + n];
  }
}

template <typename T>
cudaError_t launch(const Args& a, int Bsz, cudaStream_t stream) {
  const int smem = smem_floats(a.N) * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.hd + DS - 1) / DS, a.H, Bsz);
  ssd_fwd<T><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}


// ----------------------------------------------------------- bf16, Hopper:
// a block walks the chunks of its items (batch, head, column slice) with
// the state on chip (see the header)

namespace walk {

using bf16 = __nv_bfloat16;
constexpr int L = 64;                     // chunk rows: wgmma's m64
constexpr int THREADS = 192;   // warps 0-3 consume, 4 loads, 5 makes w x
constexpr int CONSUMERS = 128;
constexpr int MIN_BLOCKS = 2;             // blocks an SM (registers)
constexpr int NBOX = 64;                  // B and C boxes: 64 state columns
constexpr int NBOX_BYTES = L * NBOX * 2;  // 128-byte rows, 8 KB
constexpr unsigned FULL = 0xffffffffu;

// A chunk's scalars in shared memory, 64 f32 each: dt, cum_t = sum_{s<=t}
// dt_s a, v_s = exp(cum_r - cum_s) dt_s with r the last row of s's 16-row
// block (G's factor for the columns of a block below the diagonal), w_s =
// exp(cum_end - cum_s) dt_s (the state update's) and e_t = exp(cum_t).
enum Scalar { DT = 0, CUM = 1, V = 2, W = 3, E = 4, SCALARS = 5 };

// Shared memory of one block from the first 1024-byte boundary: the stages
// (C's MT boxes, B's MT boxes, x's 64 x DSL tile and w x's hi and lo
// tiles), two buffers of H_in^T hi and lo (64 MT x DSL each), each stage's
// scalars (SCALARS x 64 f32), the full, w x and empty barriers.
// kernels/ssm_scan.py walk_smem_bytes computes the same total, which the
// entry point checks.
struct Layout {
  int x_bytes, stage_bytes, h_bytes, total;
  __host__ __device__ Layout(int dsl, int mt, int stages)
      : x_bytes(L * dsl * 2),
        stage_bytes(2 * mt * NBOX_BYTES + 3 * L * dsl * 2),
        h_bytes(mt * 64 * dsl * 2),
        total(1024 + stages * stage_bytes + 4 * h_bytes +
              stages * SCALARS * L * 4 + 3 * stages * 8) {}
};

struct Args {
  const float* dt;
  const float* a;
  const float* h0;   // may be null
  float* y;
  float* h_last;
  int S, H, hd, N, nc, stages, items;   // items: B H (hd / DSL)
  long long dts[3];  // dt (batch, seq, head) strides
};

// The byte offset o of a tile whose rows are P bytes (32, 64 or 128: the
// swizzle span) as the span's swizzle stores it: the 16-byte chunk index
// XOR the row's bits above it (CU_TENSOR_MAP_SWIZZLE_{32,64,128}B, the
// layout wgmma reads).
template <int P>
__device__ __forceinline__ int swz(int o) {
  return o ^ (((o >> 7) & (P / 16 - 1)) << 4);
}

// exp(y) as ex2.approx.ftz of y log2(e): to about 2^-22 of the value plus
// the argument's rounding, |y| 2^-24, with results below f32's normal
// range flushed to 0 (what the products do with them anyway).  The decays
// have y <= 0, and where |y| is large the value is far below the tolerance.
__device__ __forceinline__ float exp_ftz(float y) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y * 1.4426950408889634f));
  return r;
}

// The producer warp's part of a chunk: lane l loads dt of rows 2l and
// 2l + 1 (0 past S), the warp scans dt a in the reference's order of
// roundings (each dt a rounded, then summed), and writes the scalars.
__device__ __forceinline__ void chunk_scalars(const float* dtp,
                                              long long dt_step, int t0,
                                              int S, float A, float* sc,
                                              int lane) {
  const int r0 = t0 + 2 * lane;
  const float dt0 = r0 < S ? dtp[r0 * dt_step] : 0.f;
  const float dt1 = r0 + 1 < S ? dtp[(r0 + 1) * dt_step] : 0.f;
  const float d0 = __fmul_rn(dt0, A);
  const float d1 = __fmul_rn(dt1, A);
  float s = d0 + d1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(FULL, s, o);
    if (lane >= o) s += n;
  }
  float prev = __shfl_up_sync(FULL, s, 1);
  if (lane == 0) prev = 0.f;
  const float c0 = prev + d0;
  const float r = __shfl_sync(FULL, s, lane | 7);   // row 16 (l / 8) + 15
  const float cend = __shfl_sync(FULL, s, 31);
  const int i = 2 * lane;
  *reinterpret_cast<float2*>(sc + DT * L + i) = make_float2(dt0, dt1);
  *reinterpret_cast<float2*>(sc + CUM * L + i) = make_float2(c0, s);
  *reinterpret_cast<float2*>(sc + V * L + i) =
      make_float2(exp_ftz(r - c0) * dt0, exp_ftz(r - s) * dt1);
  *reinterpret_cast<float2*>(sc + W * L + i) =
      make_float2(exp_ftz(cend - c0) * dt0, exp_ftz(cend - s) * dt1);
  *reinterpret_cast<float2*>(sc + E * L + i) = make_float2(expf(c0), expf(s));
}

// The k16 step kk of a K-major operand in 64-column boxes of 128-byte
// rows: 32 bytes a step inside a box, the next box every four.
__device__ __forceinline__ uint64_t kstep_k(uint64_t desc, int kk) {
  return desc + ((((kk >> 2) * NBOX_BYTES) + (kk & 3) * 32) >> 4);
}

// S = C B^T over a chunk (both K-major, exact bf16), issued and
// committed: K = N in KS k16 steps (columns past N are TMA's zeros).
template <int KS>
__device__ __forceinline__ void issue_cb(float (&sc)[32], uint64_t dc,
                                         uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    hopper::wgmma_ss<bf16, 64, 0, 0>(sc, kstep_k(dc, kk), kstep_k(db, kk),
                                     kk > 0);
  hopper::wgmma_commit();
}

// G(t, s) = S(t, s) exp(cum_t - cum_s) dt_s for s <= t, 0 above the
// diagonal, as the A fragments of G x split hi + lo: the accumulators of
// n8 blocks 2 kk and 2 kk + 1 are k16 step kk.  Warp WP's rows t (16 WP ..
// 16 WP + 15) see no column of steps past WP.  Below the diagonal block the
// decay factors about r, the last row of the columns' block (s <= r < t):
// exp(cum_t - cum_r) (two exps a thread and block) times v_s; every factor
// is at most 1, and where one flushes to 0 the product is below it.  The
// diagonal block takes one exp a pair, masked before it.  Compiled for
// each warp, so each runs one straight block of its own steps.
template <int WP>
__device__ __forceinline__ void make_g_warp(const float (&sc)[32],
                                            const float* scal, int g, int q,
                                            uint32_t (&ghi)[4][4],
                                            uint32_t (&glo)[4][4]) {
  const float* cum = scal + CUM * L;
  const float* v = scal + V * L;
  const float* dt = scal + DT * L;
  const int t0 = 16 * WP + g, t1 = t0 + 8;
  const float c0 = cum[t0], c1 = cum[t1];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk > WP) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ghi[kk][e] = glo[kk][e] = 0u;
    } else if (kk < WP) {
      const float r = cum[16 * kk + 15];
      const float u0 = exp_ftz(c0 - r), u1 = exp_ftz(c1 - r);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * kk + half, s = 8 * j + 2 * q;
        const float2 vs = *reinterpret_cast<const float2*>(v + s);
        tc::split_bf2(sc[4 * j] * u0 * vs.x, sc[4 * j + 1] * u0 * vs.y,
                      ghi[kk][2 * half], glo[kk][2 * half]);
        tc::split_bf2(sc[4 * j + 2] * u1 * vs.x, sc[4 * j + 3] * u1 * vs.y,
                      ghi[kk][2 * half + 1], glo[kk][2 * half + 1]);
      }
    } else {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * kk + half, s = 8 * j + 2 * q;
        const float2 cs = *reinterpret_cast<const float2*>(cum + s);
        const float2 ds = *reinterpret_cast<const float2*>(dt + s);
        const float w00 = exp_ftz(s <= t0 ? c0 - cs.x : -INFINITY) * ds.x;
        const float w01 = exp_ftz(s + 1 <= t0 ? c0 - cs.y : -INFINITY) * ds.y;
        const float w10 = exp_ftz(s <= t1 ? c1 - cs.x : -INFINITY) * ds.x;
        const float w11 = exp_ftz(s + 1 <= t1 ? c1 - cs.y : -INFINITY) * ds.y;
        tc::split_bf2(sc[4 * j] * w00, sc[4 * j + 1] * w01,
                      ghi[kk][2 * half], glo[kk][2 * half]);
        tc::split_bf2(sc[4 * j + 2] * w10, sc[4 * j + 3] * w11,
                      ghi[kk][2 * half + 1], glo[kk][2 * half + 1]);
      }
    }
  }
}

__device__ __forceinline__ void make_g(const float (&sc)[32],
                                       const float* scal, int w, int g,
                                       int q, uint32_t (&ghi)[4][4],
                                       uint32_t (&glo)[4][4]) {
  switch (w) {
    case 0: make_g_warp<0>(sc, scal, g, q, ghi, glo); break;
    case 1: make_g_warp<1>(sc, scal, g, q, ghi, glo); break;
    case 2: make_g_warp<2>(sc, scal, g, q, ghi, glo); break;
    default: make_g_warp<3>(sc, scal, g, q, ghi, glo); break;
  }
}

// w_s x_s (w_s = exp(cum_end - cum_s) dt_s) as hi + lo tiles in x's own
// layout: a 16-byte chunk of the x tile and its two images share their
// offset, and the swizzle keeps a chunk in its row s = o / P.  Written by
// the lanes of warp 5.
constexpr int WX_THREADS = 32;
template <int DSL>
__device__ __forceinline__ void write_wx(const unsigned char* sx,
                                         const float* scal,
                                         unsigned char* whi,
                                         unsigned char* wlo, int tid) {
  constexpr int P = DSL * 2;
#pragma unroll
  for (int i = tid; i < L * P / 16; i += WX_THREADS) {
    const int o = 16 * i, s = o / P;
    const float ws = scal[W * L + s];
    float f[8];
    tc::unpack8<bf16>(*reinterpret_cast<const uint4*>(sx + o), f);
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tc::split_bf2(f[2 * e] * ws, f[2 * e + 1] * ws, hi[e], lo[e]);
    *reinterpret_cast<uint4*>(whi + o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(wlo + o) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// The state entering the next chunk, H^T (64 MT x DSL, the accumulators),
// as hi + lo tiles of rows n (DSL columns d, P bytes a row, swizzled): the
// MN-major B operand of C H_in^T.  A warp's rows are 8 x 8 matrices (rows
// 16 w + 8 half + 0..7, columns 8 j + 0..7), four to a stmatrix: matrix i
// of group k is j = 2 k + i / 2, half = i % 2.
template <int DSL, int MT>
__device__ __forceinline__ void write_h(const float (&hs)[MT][DSL / 2],
                                        unsigned char* hhi,
                                        unsigned char* hlo, int w,
                                        int lane) {
  constexpr int P = DSL * 2;
  const int i = lane >> 3, r = lane & 7;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int k = 0; k < DSL / 16; ++k) {
      const int n = 64 * m + 16 * w + 8 * (i & 1) + r;
      const int o = swz<P>(n * P + 16 * (2 * k + (i >> 1)));
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int e = 4 * (2 * k + (ii >> 1)) + 2 * (ii & 1);
        tc::split_bf2(hs[m][e], hs[m][e + 1], hi[ii], lo[ii]);
      }
      hopper::stmatrix_x4(hhi + o, hi[0], hi[1], hi[2], hi[3]);
      hopper::stmatrix_x4(hlo + o, lo[0], lo[1], lo[2], lo[3]);
    }
}

// One walk item: the (batch, head, column slice) of index `item`, slices
// fastest.
struct Item {
  int d0, h, b;
  __device__ Item(int item, int DSL, const Args& a) {
    const int slices = a.hd / DSL;
    d0 = item % slices * DSL;
    h = item / slices % a.H;
    b = item / slices / a.H;
  }
};

template <int DSL, int MT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    ssd_fwd_walk(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tcm, const Args a) {
  constexpr int P = DSL * 2;               // bytes of a row of x, w x, H_in^T
  constexpr int KS = 4 * MT;               // k16 steps over N (zero-padded)
  const Layout lay(DSL, MT, a.stages);
  const int ST = a.stages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // tiles start on 1024 bytes (the 128-byte swizzle's period)
  const uint32_t pad = (1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023;
  unsigned char* tiles = smem_raw + pad;   // [ST][C, B boxes, x, w x hi, lo]
  unsigned char* hbuf = tiles + ST * lay.stage_bytes;   // [2][hi, lo]
  float* scalars = reinterpret_cast<float*>(hbuf + 4 * lay.h_bytes);
  uint64_t* full =                                      // [ST][SCALARS][L]
      reinterpret_cast<uint64_t*>(scalars + ST * SCALARS * L);
  uint64_t* wxf = full + ST;               // w x written
  uint64_t* empty = wxf + ST;

  // The ring of stages and its parities run on from one item to the next
  // (each role counts its chunks across the block's items).
  // The producer's lane 0 sets up the barriers and issues the first
  // chunk's boxes before the block meets, so their latency starts first.
  const uint32_t box_bytes = 2 * MT * NBOX_BYTES + lay.x_bytes;
  auto issue_boxes = [&](int s, int t0, const Item& it) {
    hopper::mbar_arrive_expect_tx(full + s, box_bytes);
    unsigned char* st = tiles + s * lay.stage_bytes;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      hopper::tma_load(st + m * NBOX_BYTES, &tcm, full + s, m * NBOX, t0,
                       it.b);
      hopper::tma_load(st + (MT + m) * NBOX_BYTES, &tb, full + s, m * NBOX,
                       t0, it.b);
    }
    hopper::tma_load(st + 2 * MT * NBOX_BYTES, &tx, full + s, it.d0, it.h,
                     t0, it.b);
  };
  if (threadIdx.x == 4 * 32) {
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(full + s, 33);       // the boxes' bytes, each lane
      hopper::mbar_init(wxf + s, 1);         // warp 5
      hopper::mbar_init(empty + s, 4);       // each consumer warp
    }
    hopper::fence_barrier_init();
    issue_boxes(0, 0, Item(blockIdx.x, DSL, a));
  }
  __syncthreads();
  // the warp, broadcast from lane 0 so the compiler sees it uniform
  const int warp = __shfl_sync(FULL, threadIdx.x / 32, 0);
  const int lane = threadIdx.x & 31;
  auto scal = [&](int s) { return scalars + s * SCALARS * L; };
  auto sx = [&](int s) {
    return tiles + s * lay.stage_bytes + 2 * MT * NBOX_BYTES;
  };
  auto swx = [&](int s) { return sx(s) + lay.x_bytes; };   // hi, then lo

  if (warp == 4) {
    // Producer warp: lane 0 issues the TMA boxes of C, B and x, then the
    // lanes compute the chunk's scalars, each chunk into the next free
    // stage.
    int s = 0;
    uint32_t ph = 0u;
    for (int item = blockIdx.x, gc = 0; item < a.items;
         item += gridDim.x) {
      const Item it(item, DSL, a);
      const float* dtp = a.dt + it.b * a.dts[0] + it.h * a.dts[2];
      const float A = a.a[it.h];
      for (int c = 0; c < a.nc; ++c, ++gc) {
        const int t0 = c * L;
        if (gc > 0) {                      // the first boxes are in flight
          hopper::mbar_wait(empty + s, ph ^ 1u);
          if (lane == 0) issue_boxes(s, t0, it);
        }
        chunk_scalars(dtp, a.dts[1], t0, a.S, A, scal(s), lane);
        hopper::mbar_arrive(full + s);     // this lane's scalars are written
        if (++s == ST) {
          s = 0;
          ph ^= 1u;
        }
      }
    }
    return;
  }
  if (warp == 5) {
    // w x of each chunk, once its x and scalars are in, into its stage
    int s = 0;
    uint32_t ph = 0u;
    for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
      for (int c = 0; c < a.nc; ++c) {
        hopper::mbar_wait(full + s, ph);
        write_wx<DSL>(sx(s), scal(s), swx(s), swx(s) + lay.x_bytes, lane);
        hopper::fence_proxy_async();
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(wxf + s);
        if (++s == ST) {
          s = 0;
          ph ^= 1u;
        }
      }
    }
    return;
  }

  // The consumer warpgroup.  This thread's rows: t (of y) and n (of H^T)
  // 16 warp + g and + 8; its columns 8 j + 2 q (+ 1).
  const int w = warp, g = lane >> 2, q = lane & 3;
  const int tr0 = 16 * w + g, tr1 = tr0 + 8;
  // H_in^T, hi and lo, double-buffered by the chunk's parity
  auto hhi = [&](int gc) { return hbuf + (gc & 1) * 2 * lay.h_bytes; };
  auto desc_c = [&](int s) {
    return hopper::smem_desc(tiles + s * lay.stage_bytes, 0, 1024, 128);
  };
  auto desc_b = [&](int s, int m) {        // B's box m (K-major B, M-major A)
    return hopper::smem_desc(tiles + s * lay.stage_bytes +
                                 (MT + m) * NBOX_BYTES,
                             NBOX_BYTES, 1024, 128);
  };
  auto desc_mn = [&](const unsigned char* p, int lbo) {   // MN-major B
    return hopper::smem_desc(p, lbo, 8 * P, P);
  };
  const long long y_row = static_cast<long long>(a.H) * a.hd;

  float sc[32];                 // S = C B^T of the next chunk
  // C H_in^T: with one state tile, C [H_in^T hi | lo] in one product of
  // width 2 DSL (C read once); with two, hi and lo in turn into one
  // accumulator (the wider one's registers would spill)
  constexpr bool WIDE = MT == 1;
  constexpr int YC = WIDE ? DSL : DSL / 2;
  float yi[DSL / 2];            // G x
  float yc[YC];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DSL / 2; ++i) yi[i] = 0.f;
#pragma unroll
  for (int i = 0; i < YC; ++i) yc[i] = 0.f;
  uint32_t ghi[4][4], glo[4][4];

  int s = 0;                               // the chunk's stage, its parity
  uint32_t ph = 0u;
  for (int item = blockIdx.x, gc = 0; item < a.items; item += gridDim.x) {
    const Item it(item, DSL, a);
    // the state: H^T rows n = 64 m + 16 w + g (+ 8), columns d0 + 8 j + 2 q
    float hs[MT][DSL / 2];
    const long long hrow =
        (static_cast<long long>(it.b) * a.H + it.h) * a.hd + it.d0;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < DSL / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 64 * m + 16 * w + g + 8 * (e >> 1);
          const int d = 8 * j + 2 * q + (e & 1);
          hs[m][4 * j + e] = a.h0 != nullptr && n < a.N
                                 ? a.h0[(hrow + d) * a.N + n] : 0.f;
        }

    // the first chunk: H_in^T in shared memory, S and G.  (H_in^T goes
    // first: with the proxy fence between S's issue and its wait, ptxas
    // 12.9 crashes.)
    write_h<DSL, MT>(hs, hhi(gc), hhi(gc) + lay.h_bytes, w, lane);
    hopper::fence_proxy_async();
    hopper::mbar_wait(full + s, ph);
    hopper::wgmma_fence();
    issue_cb<KS>(sc, desc_c(s), desc_b(s, 0));
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    make_g(sc, scal(s), w, g, q, ghi, glo);
    hopper::named_barrier_sync(1, CONSUMERS);

    float* ybase = a.y + static_cast<long long>(it.b) * a.S * y_row +
                   static_cast<long long>(it.h) * a.hd + it.d0;
    for (int c = 0; c < a.nc; ++c, ++gc) {
      const int t0 = c * L;
      const bool more = c + 1 < a.nc;
      const int s1 = s + 1 == ST ? 0 : s + 1;         // the next chunk's
      const uint32_t ph1 = s1 == 0 ? ph ^ 1u : ph;
      // the stage whose S is made below: the next chunk's, or this one's
      // again after the last (unused; it keeps the products unconditional)
      const int sn = more ? s1 : s;
      const float* es = scal(s) + E * L;
      const float e0 = es[tr0], e1 = es[tr1], ecend = es[L - 1];
      if (more) hopper::mbar_wait(full + sn, ph1);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < DSL / 2; ++i) hs[m][i] *= ecend;
      const uint64_t dx = desc_mn(sx(s), lay.x_bytes);
      // H_in^T hi and lo side by side: the lo tile is the next column
      // block of one 2 DSL-wide operand
      const uint64_t dh = desc_mn(hhi(gc), lay.h_bytes);
      const uint64_t dw_hi = desc_mn(swx(s), lay.x_bytes);
      const uint64_t dw_lo = desc_mn(swx(s) + lay.x_bytes, lay.x_bytes);
      hopper::mbar_wait(wxf + s, ph);       // this chunk's w x
      const uint64_t dc = desc_c(s);
      hopper::wgmma_fence();
      // yi = G x (G hi, then lo, from registers; x MN-major)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::wgmma_rs<bf16, DSL, 1>(yi, ghi[kk], dx + (kk * 16 * P >> 4),
                                       kk > 0);
        hopper::wgmma_rs<bf16, DSL, 1>(yi, glo[kk], dx + (kk * 16 * P >> 4),
                                       1);
      }
      hopper::wgmma_commit();
      // S of the next chunk, so that its G is built while the state's
      // products run
      issue_cb<KS>(sc, desc_c(sn), desc_b(sn, 0));
      // yc = C H_in^T (hi and lo); H^T = exp(cum_end) H^T + B^T (w x)
      if constexpr (WIDE) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          hopper::wgmma_ss<bf16, 2 * DSL, 1, 0>(yc, kstep_k(dc, kk),
                                                dh + (kk * 16 * P >> 4),
                                                kk > 0);
      } else {
        const uint64_t dh_lo = dh + (lay.h_bytes >> 4);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          hopper::wgmma_ss<bf16, DSL, 1, 0>(yc, kstep_k(dc, kk),
                                            dh + (kk * 16 * P >> 4), kk > 0);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          hopper::wgmma_ss<bf16, DSL, 1, 0>(yc, kstep_k(dc, kk),
                                            dh_lo + (kk * 16 * P >> 4), 1);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const uint64_t dbm = desc_b(s, m);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hopper::wgmma_ss<bf16, DSL, 1, 1>(hs[m], dbm + (kk * 16 * 128 >> 4),
                                            dw_hi + (kk * 16 * P >> 4), 1);
          hopper::wgmma_ss<bf16, DSL, 1, 1>(hs[m], dbm + (kk * 16 * 128 >> 4),
                                            dw_lo + (kk * 16 * P >> 4), 1);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();               // G x and S done: G is free
      hopper::fence_regs(sc);
      if (more) make_g(sc, scal(sn), w, g, q, ghi, glo);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(yi);
      hopper::fence_regs(yc);
#pragma unroll
      for (int m = 0; m < MT; ++m) hopper::fence_regs(hs[m]);
      // the next chunk's H_in^T into the other buffer (its last readers,
      // chunk gc - 1's products, finished before the last barrier)
      if (more) {
        write_h<DSL, MT>(hs, hhi(gc + 1), hhi(gc + 1) + lay.h_bytes, w, lane);
        hopper::fence_proxy_async();
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty + s);   // the stage is free
      float* yb = ybase + t0 * y_row;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = tr0 + 8 * half;
        const float e = half ? e1 : e0;
        if (t0 + t < a.S) {
          float* row = yb + t * y_row;
#pragma unroll
          for (int j = 0; j < DSL / 8; ++j) {
            const int i = 4 * j + 2 * half;
            float c0 = yc[i], c1 = yc[i + 1];
            if constexpr (WIDE) {           // the lo columns' share
              c0 += yc[i + DSL / 2];
              c1 += yc[i + DSL / 2 + 1];
            }
            *reinterpret_cast<float2*>(row + 8 * j + 2 * q) =
                make_float2(fmaf(e, c0, yi[i]), fmaf(e, c1, yi[i + 1]));
          }
        }
      }
      hopper::named_barrier_sync(1, CONSUMERS);
      s = s1;
      ph = ph1;
    }

#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < DSL / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 64 * m + 16 * w + g + 8 * (e >> 1);
          const int d = 8 * j + 2 * q + (e & 1);
          if (n < a.N) a.h_last[(hrow + d) * a.N + n] = hs[m][4 * j + e];
        }
  }
}

template <int DSL, int MT>
cudaError_t launch(const Args& a, const void* x, const void* B,
                   const void* C, const long long* st, int Bsz, int smem,
                   int blocks, cudaStream_t stream) {
  auto kernel = ssd_fwd_walk<DSL, MT>;
  static unsigned long long smem_set = 0;
  cudaError_t e = tc::allow_smem(kernel, Layout(DSL, MT, 3).total, smem_set);
  if (e != cudaSuccess) return e;
  CUtensorMap maps[3];
  // x: dims (hd, H, S, B), boxes (DSL, 1, 64, 1); B and C: (N, S, B),
  // boxes (64, 64, 1)
  const uint64_t xd[4] = {static_cast<uint64_t>(a.hd),
                          static_cast<uint64_t>(a.H),
                          static_cast<uint64_t>(a.S),
                          static_cast<uint64_t>(Bsz)};
  const long long xs[3] = {st[2], st[1], st[0]};
  const uint32_t xbox[4] = {DSL, 1, L, 1};
  const uint64_t nd[3] = {static_cast<uint64_t>(a.N),
                          static_cast<uint64_t>(a.S),
                          static_cast<uint64_t>(Bsz)};
  const long long bs[2] = {st[7], st[6]}, cs[2] = {st[9], st[8]};
  const uint32_t nbox[3] = {NBOX, L, 1};
  e = hopper::encode_view(&maps[0], false, 4, x, xd, xs, xbox);
  if (e == cudaSuccess)
    e = hopper::encode_view(&maps[1], false, 3, B, nd, bs, nbox);
  if (e == cudaSuccess)
    e = hopper::encode_view(&maps[2], false, 3, C, nd, cs, nbox);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], a);
  return cudaGetLastError();
}

}  // namespace walk

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (x, B and C alike).
// strides: 10 element strides: x (batch, seq, head), dt (batch, seq,
// head), B (batch, seq), C (batch, seq).  h0 may be null (a zero state).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_torch_ssd_scan(const void* x, const float* dt,
                                    const float* a, const void* B,
                                    const void* C, const float* h0, float* y,
                                    float* h_last, int dtype, int Bsz, int S,
                                    int H, int hd, int N,
                                    const long long* strides, void* stream) {
  if (Bsz < 1 || S < 1 || H < 1 || hd < 1 || N < 1 || N > 256)
    return cudaErrorInvalidValue;
  Args args;
  args.x = x;
  args.dt = dt;
  args.a = a;
  args.B = B;
  args.C = C;
  args.h0 = h0;
  args.y = y;
  args.h_last = h_last;
  args.S = S;
  args.H = H;
  args.hd = hd;
  args.N = N;
  for (int i = 0; i < 3; ++i) {
    args.xs[i] = strides[i];
    args.dts[i] = strides[3 + i];
  }
  for (int i = 0; i < 2; ++i) {
    args.bs[i] = strides[6 + i];
    args.cs[i] = strides[8 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(args, Bsz, s);
    case 1: return launch<__half>(args, Bsz, s);
    case 2: return launch<__nv_bfloat16>(args, Bsz, s);
    default: return cudaErrorInvalidValue;
  }
}

// The Hopper path: bf16 x, B and C; hd and N multiples of 16 up to 128.
// strides as above (each a positive multiple of 16 bytes where its dim is
// above 1; the data pointers on 16 bytes).  The launch geometry comes from
// the caller (kernels/ssm_scan.py walk_geometry): dsl (16 or 32) columns
// of hd an item, stages (2 or 3), smem_bytes (which must be walk::Layout's
// total) and the grid (blocks, 1, 1), at most the B H (hd / dsl) items,
// which the blocks take in turn.  h0 may be null.  Issues one kernel on
// the stream; returns cudaGetLastError() after it (0 on success), or
// cudaErrorInvalidValue for what it does not take.
extern "C" int repro_torch_ssd_walk(const void* x, const float* dt,
                                    const float* a, const void* B,
                                    const void* C, const float* h0, float* y,
                                    float* h_last, int Bsz, int S, int H,
                                    int hd, int N, const long long* strides,
                                    int dsl, int stages, int smem_bytes,
                                    int grid_x, int grid_y, int grid_z,
                                    void* stream) {
  if (Bsz < 1 || S < 1 || H < 1 || hd < 16 || N < 16 || hd % 16 ||
      N % 16 || hd > 128 || N > 128)
    return cudaErrorInvalidValue;
  const int mt = N > 64 ? 2 : 1;
  const long long items = static_cast<long long>(Bsz) * H * (hd / 16);
  if ((dsl != 16 && dsl != 32) || hd % dsl || (stages != 2 && stages != 3) ||
      smem_bytes != walk::Layout(dsl, mt, stages).total || grid_x < 1 ||
      grid_y != 1 || grid_z != 1 || items > 0x7fffffffLL ||
      grid_x > items / (dsl / 16))
    return cudaErrorInvalidValue;
  walk::Args args;
  args.dt = dt;
  args.a = a;
  args.h0 = h0;
  args.y = y;
  args.h_last = h_last;
  args.S = S;
  args.H = H;
  args.hd = hd;
  args.N = N;
  args.nc = (S + walk::L - 1) / walk::L;
  args.stages = stages;
  args.items = static_cast<int>(items / (dsl / 16));
  for (int i = 0; i < 3; ++i) args.dts[i] = strides[3 + i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dsl == 16)
    return mt == 2 ? walk::launch<16, 2>(args, x, B, C, strides, Bsz,
                                         smem_bytes, grid_x, s)
                   : walk::launch<16, 1>(args, x, B, C, strides, Bsz,
                                         smem_bytes, grid_x, s);
  return mt == 2 ? walk::launch<32, 2>(args, x, B, C, strides, Bsz,
                                       smem_bytes, grid_x, s)
                 : walk::launch<32, 1>(args, x, B, C, strides, Bsz,
                                       smem_bytes, grid_x, s);
}
