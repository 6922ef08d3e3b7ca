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
// Every decay is one exp of a difference of cumulative logs with s <= t, so
// no exponent is positive; pairs with s > t never reach an exp.
//
// Layout: x (B,S,H,hd) in f32/f16/bf16, dt (B,S,H) f32, B and C (B,S,N) in
// x's type, each given by its strides in elements with a unit stride on
// the last axis, so the model's projections are read in place; B and C are
// shared by all heads and read with no per-head copy (the Pallas wrapper
// broadcasts them).  a (H,) f32.  h0 (B,H,hd,N) f32 or null (zeros).
// Outputs y (B,S,H,hd) f32 and h_last (B,H,hd,N) f32, contiguous: the
// decode cache's layout (the Pallas scratch is (N, hd)).  The Pallas grid
// is (batch*heads, chunks) with the chunk axis sequential and the state in
// VMEM scratch; on Hopper nothing carries over between blocks, so the two
// paths below differ in what walks the chunks.
//
// Bound on an H100 at zamba2's prefill (B=1, S=512, H=80, hd=64, N=64,
// bf16 x/B/C): about 17.3 MB in and out, 5.2 us at 3.35 TB/s; the
// recurrence's 5 hd N operations a token and head are 0.84 GFLOP, 0.85 us
// on the tensor cores (12.5 us at f32's 67 TFLOP/s on the CUDA cores).  So
// the bytes bound it, and a kernel near the bound has to keep the card
// busy on a problem of 17 MB: enough blocks, short serial chains.
//
// bf16 with hd and N multiples of 16 up to 128: the tensor-core path,
// Mamba2's own chunk-state / state-passing / chunk-scan form in three
// launches on the caller's stream, 64-row chunks (a ragged last one is
// zero-filled), 4 warps a block, each warp one 16-row strip:
//   ssd_fwd_state, one block per (batch, chunk, head): the
//     chunk's cumulative log decay by a warp scan, its decay exp(cum_end)
//     and its local state dH = (w x)^T B with w_s = exp(cum_end - cum_s)
//     dt_s, into an f32 scratch (B, chunks, H, hd, N);
//   ssd_fwd_pass, one thread per (batch, head, state element): walks the
//     chunks in f32, H_c = exp(cum_end_c) H_{c-1} + dH_c from h0, writes the
//     state entering each chunk over its dH, and h_last;
//   ssd_fwd_scan, one block per (batch, chunk, group of hg heads): C B^T
//     once for the group (B and C are shared by every head; only the decay
//     depends on the head), then per head G = (C B^T) exp(cum_t - cum_s)
//     dt_s for s <= t (one exp a pair and head, as before) and
//     y = G x + exp(cum_t) C H_in^T.
// Every product is mma.sync m16n8k16 with f32 sums.  x, B and C are exact
// bf16 operands; G, w x and the state are f32, and rounding them to bf16
// (2^-8) or TF32 (2^-11) would break the 1e-4 tolerance, so each goes in
// as a hi + lo pair of bf16 (two products, about 2^-17 of the value;
// tc::split_bf2).  The scratch is 4 hd N bytes a chunk and head (10.5 MB at
// zamba2's prefill, mostly in L2: written by the state kernel, read and
// rewritten by the pass, read by the scan).  hg
// trades C B^T recomputation against blocks: the launcher keeps about two
// scan blocks an SM (two heads a block at zamba2's shape, which measured
// fastest of 1 to 16).  What holds it back is latency: each head's loads
// wait at a __syncthreads before its products, with C B^T held in
// registers (three blocks an SM), and the scratch's three trips through
// memory (PERF.md).
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


// ----------------------------------------------------------- bf16, tensor
// cores: chunk state, state passing, chunk scan (see the header)

using bf16 = __nv_bfloat16;
constexpr int TL = 64;       // chunk rows
constexpr int TNT = 128;     // 4 warps, one 16-row strip each
constexpr int TMAX = 128;    // largest hd and N of the path
constexpr int PNT = 256;     // threads of a state-passing block
constexpr unsigned FULL = 0xffffffffu;

struct TcArgs {
  const bf16* x;
  const float* dt;
  const float* a;
  const bf16* B;
  const bf16* C;
  const float* h0;   // may be null
  float* y;
  float* h_last;
  float* states;     // (B, nc, H, hd, N): dH_c, then the state entering c
  float* decay;      // (B, nc, H): exp(cum_end_c)
  int S, H, hd, N, nc, hg;   // hg: heads a block of the scan
  long long xs[3], dts[3], bs[2], cs[2];
};

int state_smem(int hd, int N) {
  return TL * (N + 8) * 2 + TL * (hd + 8) * 2 + 3 * TL * 4;
}

int scan_smem(int hd, int N) {
  return 2 * TL * (N + 8) * 2 + TL * (hd + 8) * 2 + 2 * hd * (N + 8) * 2 +
         2 * TL * 4;
}

// cum_t = sum_{s<=t} dt_s a over the chunk (rows past its end hold dt 0),
// by one warp: lane l owns rows 2l and 2l + 1.
__device__ __forceinline__ void chunk_cumsum(const float* sDt, float A,
                                             float* sCum, int lane) {
  const float d0 = __fmul_rn(sDt[2 * lane], A);
  const float d1 = __fmul_rn(sDt[2 * lane + 1], A);
  float s = d0 + d1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(FULL, s, o);
    if (lane >= o) s += n;
  }
  float prev = __shfl_up_sync(FULL, s, 1);
  if (lane == 0) prev = 0.f;
  sCum[2 * lane] = prev + d0;
  sCum[2 * lane + 1] = s;
}

// Loads dt for head h of this chunk, 0 past its end.
__device__ __forceinline__ void load_dt(const TcArgs& a, float* sDt, int b,
                                        int t0, int lc, int h, int tid) {
  if (tid < TL)
    sDt[tid] = tid < lc ? a.dt[b * a.dts[0] + (t0 + tid) * a.dts[1] +
                               h * a.dts[2]]
                        : 0.f;
}

// dH[d][n] = sum_s x_s[d] w_s B_s[n], w_s = exp(cum_end - cum_s) dt_s; the
// warps own 16-row strips of d, the product's M.
__global__ void __launch_bounds__(TNT) ssd_fwd_state(TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LB = a.N + 8, LX = a.hd + 8;
  bf16* sB = reinterpret_cast<bf16*>(smem_raw);        // [TL][LB]
  bf16* sX = sB + TL * LB;                             // [TL][LX]
  float* sDt = reinterpret_cast<float*>(sX + TL * LX); // [TL]
  float* sCum = sDt + TL;                              // [TL]
  float* sW = sCum + TL;                               // [TL]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const tc::Lanes ln(lane);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * TL, lc = min(TL, a.S - t0);
  const long long E = static_cast<long long>(a.hd) * a.N;

  tc::cp_rows(sB, LB * 2, a.B + b * a.bs[0] + t0 * a.bs[1], a.bs[1] * 2, TL,
              lc, a.N * 2, tid, TNT);
  tc::cp_rows(sX, LX * 2, a.x + b * a.xs[0] + t0 * a.xs[1] + h * a.xs[2],
              a.xs[1] * 2, TL, lc, a.hd * 2, tid, TNT);
  tc::cp_async_commit();
  load_dt(a, sDt, b, t0, lc, h, tid);
  __syncthreads();
  if (warp == 0) chunk_cumsum(sDt, a.a[h], sCum, lane);
  tc::cp_async_wait<0>();
  __syncthreads();
  const float cend = sCum[TL - 1];
  if (tid < TL) sW[tid] = expf(cend - sCum[tid]) * sDt[tid];
  if (tid == 0) a.decay[(b * a.nc + c) * a.H + h] = expf(cend);
  __syncthreads();

  float* out = a.states + ((static_cast<long long>(b) * a.nc + c) * a.H + h) * E;
  for (int ds = warp; ds < a.hd / 16; ds += TNT / 32) {
    // A = (w x)^T: rows d, k = s, from x stored [s][d] (.trans); the
    // fragments' k of register r is s = 16 ks + 8 (r / 2) + 2 q (+1)
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t raw[4];
      tc::ldmatrix_x4_trans(raw, sX + (ks * 16 + ln.kr) * LX + ds * 16 + ln.kc);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int s = ks * 16 + (r >> 1) * 8 + 2 * ln.q;
        const float2 v = tc::unpack_bf2(raw[r]);
        tc::split_bf2(v.x * sW[s], v.y * sW[s + 1], ahi[ks][r], alo[ks][r]);
      }
    }
    for (int nb = 0; nb < a.N / 16; ++nb) {
      float acc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t bb[4];  // B: k = s, n contiguous (.trans)
        tc::ldmatrix_x4_trans(bb, sB + (ks * 16 + ln.ar) * LB + nb * 16 + ln.ac);
        tc::mma16816<bf16>(acc[0], ahi[ks], bb[0], bb[1]);
        tc::mma16816<bf16>(acc[0], alo[ks], bb[0], bb[1]);
        tc::mma16816<bf16>(acc[1], ahi[ks], bb[2], bb[3]);
        tc::mma16816<bf16>(acc[1], alo[ks], bb[2], bb[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float* o = out + (ds * 16 + ln.g) * a.N + nb * 16 + j * 8 + 2 * ln.q;
        *reinterpret_cast<float2*>(o) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(o + 8 * a.N) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
  }
}

// H_c = exp(cum_end_c) H_{c-1} + dH_c from h0, in f32 and in the chunks'
// order; the state entering chunk c replaces dH_c, the last goes to h_last.
__global__ void __launch_bounds__(PNT) ssd_fwd_pass(TcArgs a) {
  const long long E = static_cast<long long>(a.hd) * a.N, HE = a.H * E;
  const long long idx = blockIdx.x * static_cast<long long>(PNT) + threadIdx.x;
  if (idx >= HE) return;
  const int b = blockIdx.y, h = static_cast<int>(idx / E);
  float st = a.h0 != nullptr ? a.h0[b * HE + idx] : 0.f;
  a.h_last[b * HE + idx] = tc::pass_states(
      st, a.states + b * a.nc * HE + idx, HE,
      a.decay + static_cast<long long>(b) * a.nc * a.H + h, a.H, a.nc);
}

// y = G x + exp(cum_t) C H_in^T with G = (C B^T) exp(cum_t - cum_s) dt_s,
// s <= t; each warp owns 16 rows t, the products' M.
__global__ void __launch_bounds__(TNT) ssd_fwd_scan(TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LC = a.N + 8, LX = a.hd + 8;
  bf16* sC = reinterpret_cast<bf16*>(smem_raw);          // [TL][LC]
  bf16* sB = sC + TL * LC;                               // [TL][LC]
  bf16* sX = sB + TL * LC;                               // [TL][LX]
  bf16* sHhi = sX + TL * LX;                             // [hd][LC]
  bf16* sHlo = sHhi + a.hd * LC;                         // [hd][LC]
  float* sDt = reinterpret_cast<float*>(sHlo + a.hd * LC);  // [TL]
  float* sCum = sDt + TL;                                // [TL]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const tc::Lanes ln(lane);
  const int c = blockIdx.x, b = blockIdx.z;
  const int h_first = blockIdx.y * a.hg, h_end = min(a.H, h_first + a.hg);
  const int t0 = c * TL, lc = min(TL, a.S - t0);
  const long long E = static_cast<long long>(a.hd) * a.N;
  const int tr0 = warp * 16 + ln.g, tr1 = tr0 + 8;   // this lane's rows

  tc::cp_rows(sC, LC * 2, a.C + b * a.cs[0] + t0 * a.cs[1], a.cs[1] * 2, TL,
              lc, a.N * 2, tid, TNT);
  tc::cp_rows(sB, LC * 2, a.B + b * a.bs[0] + t0 * a.bs[1], a.bs[1] * 2, TL,
              lc, a.N * 2, tid, TNT);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  // C B^T for this warp's rows and the columns s of its strip and before
  // (n8 tiles 0 .. 2 warp + 1), once for every head of the group
  float cb[8][4] = {};
  for (int ks = 0; ks < a.N / 16; ++ks) {
    uint32_t ca[4];
    tc::ldmatrix_x4(ca, sC + (warp * 16 + ln.ar) * LC + ks * 16 + ln.ac);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (np <= warp) {
        uint32_t bk[4];  // B: k = n, rows s (n contiguous)
        tc::ldmatrix_x4(bk, sB + (np * 16 + ln.kr) * LC + ks * 16 + ln.kc);
        tc::mma16816<bf16>(cb[2 * np], ca, bk[0], bk[1]);
        tc::mma16816<bf16>(cb[2 * np + 1], ca, bk[2], bk[3]);
      }
    }
  }

  const long long y_row = static_cast<long long>(a.H) * a.hd;
  for (int h = h_first; h < h_end; ++h) {
    __syncthreads();  // the last head's reads of sX, sH, sDt, sCum are done
    tc::cp_rows(sX, LX * 2, a.x + b * a.xs[0] + t0 * a.xs[1] + h * a.xs[2],
                a.xs[1] * 2, TL, lc, a.hd * 2, tid, TNT);
    tc::cp_async_commit();
    load_dt(a, sDt, b, t0, lc, h, tid);
    tc::split_rows(sHhi, sHlo, LC,
                   a.states + ((static_cast<long long>(b) * a.nc + c) * a.H + h) * E,
                   static_cast<int>(E), a.N, tid, TNT);
    __syncthreads();
    if (warp == 0) chunk_cumsum(sDt, a.a[h], sCum, lane);
    tc::cp_async_wait<0>();
    __syncthreads();

    // G as the A fragments of G x, hi + lo: n8 tiles 2 kk and 2 kk + 1 of
    // the C B^T accumulators are the k16 step kk
    const float ct0 = sCum[tr0], ct1 = sCum[tr1];
    uint32_t ghi[4][4], glo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk <= warp) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * kk + half, s = j * 8 + 2 * ln.q;
          const float w00 = s <= tr0 ? expf(ct0 - sCum[s]) * sDt[s] : 0.f;
          const float w01 =
              s + 1 <= tr0 ? expf(ct0 - sCum[s + 1]) * sDt[s + 1] : 0.f;
          const float w10 = s <= tr1 ? expf(ct1 - sCum[s]) * sDt[s] : 0.f;
          const float w11 =
              s + 1 <= tr1 ? expf(ct1 - sCum[s + 1]) * sDt[s + 1] : 0.f;
          tc::split_bf2(cb[j][0] * w00, cb[j][1] * w01, ghi[kk][2 * half],
                        glo[kk][2 * half]);
          tc::split_bf2(cb[j][2] * w10, cb[j][3] * w11, ghi[kk][2 * half + 1],
                        glo[kk][2 * half + 1]);
        }
      }
    }

    const float e0 = expf(ct0), e1 = expf(ct1);
    float* y0 = a.y + (static_cast<long long>(b) * a.S + t0 + tr0) * y_row +
                static_cast<long long>(h) * a.hd;
    float* y1 = y0 + 8 * y_row;
    for (int db = 0; db < a.hd / 16; ++db) {
      float yi[2][4] = {}, yc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk <= warp) {
          uint32_t bv[4];  // B: k = s, d contiguous (.trans)
          tc::ldmatrix_x4_trans(bv, sX + (kk * 16 + ln.ar) * LX + db * 16 + ln.ac);
          tc::mma16816<bf16>(yi[0], ghi[kk], bv[0], bv[1]);
          tc::mma16816<bf16>(yi[0], glo[kk], bv[0], bv[1]);
          tc::mma16816<bf16>(yi[1], ghi[kk], bv[2], bv[3]);
          tc::mma16816<bf16>(yi[1], glo[kk], bv[2], bv[3]);
        }
      }
      for (int ks = 0; ks < a.N / 16; ++ks) {
        uint32_t ca[4], bh[4], bl[4];  // B: k = n, rows d (n contiguous)
        tc::ldmatrix_x4(ca, sC + (warp * 16 + ln.ar) * LC + ks * 16 + ln.ac);
        tc::ldmatrix_x4(bh, sHhi + (db * 16 + ln.kr) * LC + ks * 16 + ln.kc);
        tc::ldmatrix_x4(bl, sHlo + (db * 16 + ln.kr) * LC + ks * 16 + ln.kc);
        tc::mma16816<bf16>(yc[0], ca, bh[0], bh[1]);
        tc::mma16816<bf16>(yc[0], ca, bl[0], bl[1]);
        tc::mma16816<bf16>(yc[1], ca, bh[2], bh[3]);
        tc::mma16816<bf16>(yc[1], ca, bl[2], bl[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = db * 16 + j * 8 + 2 * ln.q;
        if (tr0 < lc)
          *reinterpret_cast<float2*>(y0 + d) =
              make_float2(fmaf(e0, yc[j][0], yi[j][0]),
                          fmaf(e0, yc[j][1], yi[j][1]));
        if (tr1 < lc)
          *reinterpret_cast<float2*>(y1 + d) =
              make_float2(fmaf(e1, yc[j][2], yi[j][2]),
                          fmaf(e1, yc[j][3], yi[j][3]));
      }
    }
  }
}

unsigned long long g_scan_smem_set = 0;

cudaError_t launch_tc(TcArgs a, int Bsz, cudaStream_t stream) {
  // state_smem stays under the 48 KB default; the scan may take 120 KB
  cudaError_t e =
      tc::allow_smem(ssd_fwd_scan, scan_smem(TMAX, TMAX), g_scan_smem_set);
  if (e != cudaSuccess) return e;
  int sms = 0;   // the scan: about two blocks an SM, fewer C B^T products
  e = tc::sm_count(&sms);
  if (e != cudaSuccess) return e;
  a.hg = max(1, min(a.H, a.nc * a.H * Bsz / (2 * sms)));
  // the chunk state shares nothing across heads but B: one head a block
  ssd_fwd_state<<<dim3(a.nc, a.H, Bsz), TNT, state_smem(a.hd, a.N), stream>>>(
      a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long HE = static_cast<long long>(a.H) * a.hd * a.N;
  const dim3 pgrid(static_cast<unsigned>((HE + PNT - 1) / PNT), Bsz);
  ssd_fwd_pass<<<pgrid, PNT, 0, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const dim3 grid(a.nc, (a.H + a.hg - 1) / a.hg, Bsz);
  ssd_fwd_scan<<<grid, TNT, scan_smem(a.hd, a.N), stream>>>(a);
  return cudaGetLastError();
}

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

// The tensor-core path: bf16 x, B and C; hd and N multiples of 16 up to
// 128; x, B and C rows on 16 bytes (the copies are 16-byte cp.async).
// states (B, ceil(S/64), H, hd, N) and decay (B, ceil(S/64), H) are f32
// scratch.  strides as above.  Issues three kernels on the stream; returns the first launch
// error (0 on success).
extern "C" int repro_torch_ssd_scan_tc(const void* x, const float* dt,
                                       const float* a, const void* B,
                                       const void* C, const float* h0,
                                       float* y, float* h_last, float* states,
                                       float* decay, int Bsz, int S, int H,
                                       int hd, int N,
                                       const long long* strides,
                                       void* stream) {
  if (Bsz < 1 || S < 1 || H < 1 || hd < 16 || N < 16 || hd % 16 ||
      N % 16 || hd > TMAX || N > TMAX)
    return cudaErrorInvalidValue;
  TcArgs args;
  args.x = static_cast<const bf16*>(x);
  args.dt = dt;
  args.a = a;
  args.B = static_cast<const bf16*>(B);
  args.C = static_cast<const bf16*>(C);
  args.h0 = h0;
  args.y = y;
  args.h_last = h_last;
  args.states = states;
  args.decay = decay;
  args.S = S;
  args.H = H;
  args.hd = hd;
  args.N = N;
  args.nc = (S + TL - 1) / TL;
  for (int i = 0; i < 3; ++i) {
    args.xs[i] = strides[i];
    args.dts[i] = strides[3 + i];
  }
  for (int i = 0; i < 2; ++i) {
    args.bs[i] = strides[6 + i];
    args.cs[i] = strides[8 + i];
  }
  return launch_tc(args, Bsz, static_cast<cudaStream_t>(stream));
}
