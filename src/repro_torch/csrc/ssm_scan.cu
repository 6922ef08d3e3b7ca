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
// decode cache's layout (the Pallas scratch is (N, hd)).
//
// Design.  The Pallas grid is (batch*heads, chunks) with the chunk axis
// sequential and the state in VMEM scratch.  Here one block owns one
// (batch, head, slice of DS = 16 columns of hd): y[:, d] and h[d, :]
// depend on column d of x alone, so the block keeps its (DS, N) slice of
// the state in shared memory and walks the chunks in order; at zamba2's
// prefill (B=1, H=80, hd=64) that is 320 blocks for 132 SMs.  Per chunk of
// L = 64 rows (a ragged last chunk is masked) it stages B, C, dt and its x
// columns in shared memory as f32, takes the cumulative sum serially in
// the reference's order, builds G(t,s) = (C_t.B_s) exp(cum_t - cum_s) dt_s
// for s <= t with 4x4 register tiles (recomputed by each block: it depends
// on the head through the decay), then y, then the state update.  The
// chunk is the kernel's own: the chunked form is exact for any chunk up to
// rounding, and 64 keeps the pairwise matrix at 16 KB.
//
// Bound on an H100 at zamba2's prefill (B=1, S=512, H=80, hd=64, N=64,
// bf16 x/B/C): about 17 MB in and out (5.2 us at 3.35 TB/s) against the
// recurrence's 5 hd N flops per token and head, 0.84 GFLOP (12.5 us at
// 67 TFLOP/s in f32): the f32 math bounds it.  This first version does its
// math on the CUDA cores and recomputes C.B in every block; tensor-core
// MMAs for C.B and the state products are the later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

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
