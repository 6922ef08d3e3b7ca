// Tensor-core building blocks shared by the port's bf16/f16 kernels
// (moe_gmm.cu, flash_attention.cu, ssm_scan.cu, wkv6.cu): 16-byte cp.async
// copies into shared memory with a zero-filled tail, ldmatrix fragment
// loads and the mma.sync m16n8k16 product with f32 accumulators (all of
// them exist on sm_80 and later; the kernels are built for sm_90a), the
// hi + lo bf16 split of an f32 operand, and on the host the opt-in to more
// than 48 KB of dynamic shared memory.
//
// Fragment layout of mma.sync.m16n8k16 (lane l, g = l / 4, q = l % 4):
//   A (16 x 16, row-major): a0 (row g, k 2q..2q+1), a1 (row g+8, same k),
//                           a2 (row g, k 8+2q..), a3 (row g+8, k 8+2q..)
//   B (16 x 8, "col"):      b0 (k 2q..2q+1, col g), b1 (k 8+2q.., col g)
//   C/D (16 x 8, f32):      c0 c1 (row g, cols 2q, 2q+1), c2 c3 (row g+8)
// So the accumulators of two neighbouring n8 tiles are, lane for lane,
// the A fragment of one k16 step of the next product (flash attention's
// P V takes P that way, without shared memory).
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

// Copies `rows` rows of `row_bytes` (a multiple of 16) from src, whose rows
// lie `src_stride` bytes apart, to dst, whose rows lie `dst_stride` bytes
// apart; rows from `limit` on are zero-filled and read nothing.  The
// block's `nt` threads share the 16-byte chunks; the caller commits.
__device__ __forceinline__ void cp_rows(void* dst, int dst_stride,
                                        const void* src,
                                        long long src_stride, int rows,
                                        int limit, int row_bytes, int tid,
                                        int nt) {
  const int per_row = row_bytes / 16;
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  for (int c = tid; c < rows * per_row; c += nt) {
    const int r = c / per_row, off = (c % per_row) * 16;
    const bool in = r < limit;
    cp_async16(d + r * dst_stride + off, in ? s + r * src_stride + off : s,
               in ? 16 : 0);
  }
}

// ldmatrix lane offsets for the fragments of mma.sync m16n8k16: "a" rows
// and columns address A fragments of a row-major tile and, with .trans, B
// fragments of a k-major tile (n contiguous); "k" ones address B fragments
// of an n-major tile (k contiguous) and, with .trans, A fragments of a
// k-major tile.  g and q place a lane's accumulators (see the top).
struct Lanes {
  int ar, ac, kr, kc, g, q;
  __device__ explicit Lanes(int lane)
      : ar((lane & 7) + ((lane >> 3) & 1) * 8), ac((lane >> 4) * 8),
        kr((lane & 7) + (lane >> 4) * 8), kc(((lane >> 3) & 1) * 8),
        g(lane >> 2), q(lane & 3) {}
};

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives r[i] of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way (B fragments of a matrix
// stored k-major, with n contiguous).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b on the tensor cores, f32 accumulators.
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Two packed bf16 (lo in the low half) widened to f32.
__device__ __forceinline__ float2 unpack_bf2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// An f32 pair as bf16 hi + lo pairs: hi = bf16(v), lo = bf16(v - hi), so
// hi + lo carries v to about 2^-17 of |v| (bf16 keeps f32's exponent
// range, so no value overflows).  A product with an exact bf16 operand
// takes two mma (hi, lo); one with another split operand three (hi hi,
// hi lo, lo hi): the lo lo term is below 2^-16 of the product.
__device__ __forceinline__ void split_bf2(float v0, float v1, uint32_t& hi,
                                          uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// n f32 values (a multiple of 4, 16-byte aligned), rows of `cols`, split
// into bf16 hi and lo tiles whose rows lie `ld` elements apart.  Each
// thread has up to eight 16-byte loads in flight before it splits.
__device__ __forceinline__ void split_rows(__nv_bfloat16* hi,
                                           __nv_bfloat16* lo, int ld,
                                           const float* src, int n, int cols,
                                           int tid, int nt) {
  const float4* v4 = reinterpret_cast<const float4*>(src);
  for (int i0 = tid; i0 < n / 4; i0 += 8 * nt) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i0 + u * nt < n / 4) v[u] = v4[i0 + u * nt];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * nt;
      if (i < n / 4) {
        const int row = 4 * i / cols, col = 4 * i % cols;
        uint32_t h0, l0, h1, l1;
        split_bf2(v[u].x, v[u].y, h0, l0);
        split_bf2(v[u].z, v[u].w, h1, l1);
        *reinterpret_cast<uint2*>(hi + row * ld + col) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(lo + row * ld + col) = make_uint2(l0, l1);
      }
    }
  }
}

// One state element's walk over the chunks: st starts as the state before
// chunk 0; chunk c's local state at p[c * step] is replaced by the state
// entering it, and st = dec[c * dstep] st + local, in f32 with the
// reference's two roundings; returns the state after the last chunk.
// Eight chunks' loads are in flight at a time.
__device__ __forceinline__ float pass_states(float st, float* p,
                                             long long step, const float* dec,
                                             long long dstep, int nc) {
  for (int c0 = 0; c0 < nc; c0 += 8) {
    float d[8], e[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u < nc) {
        d[u] = p[(c0 + u) * step];
        e[u] = dec[(c0 + u) * dstep];
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u < nc) {
        p[(c0 + u) * step] = st;
        st = __fadd_rn(__fmul_rn(e[u], st), d[u]);
      }
    }
  }
  return st;
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
