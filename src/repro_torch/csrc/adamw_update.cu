// Fused AdamW leaf update for Hopper (sm_90a), plain CUDA C++, in place.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/adamw_update.py:_adamw_kernel (launched by adamw_update):
//   m' = b1 m + (1 - b1) g
//   v' = b2 v + (1 - b2) g^2
//   u  = (m' / bc1) / (sqrt(v' / bc2) + eps)  [+ wd * p]
//   p' = p - lr u
// with the math in f32, p' written back in p's dtype and m', v' in f32.
// lr, bc1 = 1 - b1^t and bc2 = 1 - b2^t change every step: they are read
// from a 3-float device buffer, so the host never waits on the device and
// the launch can be captured in a CUDA graph; b1, b2, eps and wd are
// arguments, with 1 - b1 and 1 - b2 rounded to f32 on the host as PyTorch
// rounds a Python scalar.
//
// Layout: p, g, m and v are contiguous and hold n elements each; p is f32
// or bf16, g f32 or bf16, m and v f32.  The Pallas version pads the leaf
// to (rows, 128) tiles and returns new arrays; here a grid-stride loop
// covers any n and p, m and v are updated in place, so a step allocates
// nothing (the port's full-width phi4 step has no room for a second copy
// of the 30.7 GB of moments).
//
// Bound: 22 bytes move per element for a bf16 p and g (p read and written,
// g read, m and v read and written in f32) against about 15 f32 operations,
// so memory traffic bounds it: 4.0 ms for phi4's 615 M-element embedding
// at 3.35 TB/s.  Loads are coalesced across a warp with four independent
// elements in flight per thread.  Every step is rounded on its own
// (__fmul_rn and friends never contract into a fused multiply-add;
// division and sqrt are IEEE), in the order the plain version takes them,
// so for f32 the kernel can agree with the plain version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int ITEMS = 4;
constexpr long long MAX_BLOCKS = 132 * 16;   // 16 blocks on each of 132 SMs

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;
};

template <typename P, typename G>
__global__ void __launch_bounds__(NT)
adamw(P* __restrict__ p, const G* __restrict__ g, float* __restrict__ m,
      float* __restrict__ v, const float* __restrict__ sc, long long n,
      Hyper h) {
  const float lr = sc[0], bc1 = sc[1], bc2 = sc[2];
  const long long stride = static_cast<long long>(gridDim.x) * NT * ITEMS;
  for (long long base = static_cast<long long>(blockIdx.x) * NT * ITEMS +
                        threadIdx.x;
       base < n; base += stride) {
    float pf[ITEMS], gf[ITEMS], mf[ITEMS], vf[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const long long j = base + i * NT;
      if (j < n) {
        pf[i] = to_f(p[j]);
        gf[i] = to_f(g[j]);
        mf[i] = m[j];
        vf[i] = v[j];
      }
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const long long j = base + i * NT;
      if (j >= n) break;
      const float gi = gf[i];
      const float mn = __fadd_rn(__fmul_rn(h.b1, mf[i]), __fmul_rn(h.omb1, gi));
      const float vn = __fadd_rn(__fmul_rn(h.b2, vf[i]),
                                 __fmul_rn(h.omb2, __fmul_rn(gi, gi)));
      float u = __fdiv_rn(__fdiv_rn(mn, bc1),
                          __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, bc2)), h.eps));
      if (h.wd != 0.f) u = __fadd_rn(u, __fmul_rn(h.wd, pf[i]));
      p[j] = from_f<P>(__fsub_rn(pf[i], __fmul_rn(lr, u)));
      m[j] = mn;
      v[j] = vn;
    }
  }
}

template <typename P, typename G>
cudaError_t launch(void* p, const void* g, float* m, float* v, const float* sc,
                   long long n, Hyper h, cudaStream_t stream) {
  long long blocks = (n + NT * ITEMS - 1) / (NT * ITEMS);
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  adamw<P, G><<<static_cast<int>(blocks), NT, 0, stream>>>(
      static_cast<P*>(p), static_cast<const G*>(g), m, v, sc, n, h);
  return cudaGetLastError();
}

}  // namespace

// p_dtype, g_dtype: 0 = float32, 2 = bfloat16.  scalars: device f32
// [lr, bc1, bc2].  omb1 = 1 - b1 and omb2 = 1 - b2 as f32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_torch_adamw_update(void* p, const void* g, void* m,
                                        void* v, const void* scalars,
                                        int p_dtype, int g_dtype, long long n,
                                        float b1, float omb1, float b2,
                                        float omb2, float eps, float wd,
                                        void* stream) {
  if (n < 1) return cudaSuccess;
  const Hyper h{b1, omb1, b2, omb2, eps, wd};
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  const float* sc = static_cast<const float*>(scalars);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_dtype == 0 && g_dtype == 0)
    return launch<float, float>(p, g, mf, vf, sc, n, h, s);
  if (p_dtype == 0 && g_dtype == 2)
    return launch<float, __nv_bfloat16>(p, g, mf, vf, sc, n, h, s);
  if (p_dtype == 2 && g_dtype == 0)
    return launch<__nv_bfloat16, float>(p, g, mf, vf, sc, n, h, s);
  if (p_dtype == 2 && g_dtype == 2)
    return launch<__nv_bfloat16, __nv_bfloat16>(p, g, mf, vf, sc, n, h, s);
  return cudaErrorInvalidValue;
}
