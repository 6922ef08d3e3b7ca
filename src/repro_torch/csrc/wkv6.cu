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
// Every decay is one exp of a difference of cumulative logs over rows
// s < t (or s <= end), so no exponent is positive; pairs with s >= t are
// never computed.
//
// Layout: r, k, v (B,S,H,hd) in f32/f16/bf16 and logw (B,S,H,hd) f32, each
// given by its (batch, seq, head) strides in elements with a unit stride
// on hd, so the model's projections are read in place.  u (H,hd) f32.
// s0 (B,H,hd,hd) f32 or null (zeros).  Outputs y (B,S,H,hd) f32 and
// s_last (B,H,hd_k,hd_v) f32, contiguous: the decode cache's layout.
//
// Design.  The Pallas grid is (batch*heads, chunks) with the chunk axis
// sequential and the state in VMEM scratch.  Here one block owns one
// (batch, head, slice of DS = 16 value columns): y[:, j] and S[:, j]
// depend on column j of v alone, so the block keeps its (hd, DS) slice of
// the state in shared memory and walks the chunks in order; at rwkv6's
// prefill (B=1, H=32, hd=64) that is 128 blocks for 132 SMs.  Per chunk of
// L = 32 rows (a ragged last chunk is masked) it stages r, k, logw and its
// v columns in shared memory as f32, takes the per-channel cumulative sums
// serially in the reference's order, then computes att(t,s) for the
// L(L-1)/2 pairs s < t (each block recomputes them: they do not depend on
// the value column), y, and the state update.  The pairwise term costs one
// exp per (t, s, i), so its work grows with the chunk while the state
// terms do not; 32 rows halve the Pallas kernel's 64.
//
// Bound on an H100 at rwkv6's prefill (B=1, S=512, H=32, hd=64, bf16
// r/k/v): about 15 MB in and out (4.5 us at 3.35 TB/s) against the
// recurrence's 5 hd^2 flops per token and head (3 hd^2 for the state
// update diag(w) S + k^T v, 2 hd^2 for the read-out r S; the bonus term is
// O(hd)), 0.34 GFLOP (5.0 us at 67 TFLOP/s in f32): the f32 math bounds it.  This first version does its
// math on the CUDA cores, with an exp per pair and channel; a
// secondary-chunked form on tensor cores is the later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

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
