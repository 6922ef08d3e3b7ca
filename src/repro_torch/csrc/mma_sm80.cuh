// Building blocks shared by the port's bf16/f16 kernels (moe_gmm.cu,
// flash_attention.cu, ssm_scan.cu, wkv6.cu), all of them on sm_80 and
// later (the kernels are built for sm_90a): 16-byte cp.async copies into
// shared memory with a zero-filled tail, packing and unpacking of 16-bit
// pairs, the hi + lo bf16 split of an f32 operand, and on the host the
// opt-in to more than 48 KB of dynamic shared memory and the SM count.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies `bytes` (0..16) of src to the 16 bytes at dst and zero-fills the
// rest; with bytes == 0 nothing is read.  src and dst are 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two floats rounded to the 16-bit type and packed (lo in the low half).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An f32 pair as bf16 hi + lo pairs: hi = bf16(v), lo = bf16(v - hi), so
// hi + lo carries v to about 2^-17 of |v| (bf16 keeps f32's exponent
// range, so no value overflows).  A product with an exact bf16 operand
// takes two products (hi, lo); one with another split operand three (hi
// hi, hi lo, lo hi): the lo lo term is below 2^-16 of the product.
__device__ __forceinline__ void split_bf2(float v0, float v1, uint32_t& hi,
                                          uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Eight 16-bit values (one 16-byte load) widened to f32.
template <typename T>
__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]);

template <>
__device__ __forceinline__ void unpack8<__nv_bfloat16>(const uint4& v,
                                                       float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <>
__device__ __forceinline__ void unpack8<__half>(const uint4& v,
                                                float (&f)[8]) {
  const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __half22float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory (above the 48 KB
// default) on the current device, once a device: `done` keeps a bit for
// each device already set.
template <typename K>
inline cudaError_t allow_smem(K* kernel, int bytes,
                              unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (done >> dev & 1ull)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
  return err;
}

// The current device's number of SMs, looked up once a device.
inline cudaError_t sm_count(int* n) {
  static int known[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && known[dev]) {
    *n = known[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) known[dev] = *n;
  return err;
}

}  // namespace tc
