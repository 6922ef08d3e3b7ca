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
// a copy.  out is contiguous.
//
// Design.  The Pallas grid is (E, C/bc, F/bf, D/bd) with 128-aligned blocks,
// the D axis innermost and sequential, and the sum in VMEM scratch; it
// asserts that C, D and F divide the blocks, which the model's own
// capacities (200 in a 512-token prefill, 2 in a 4-slot decode step) do
// not.  Here one block of 256 threads owns one (expert, 64-row tile of C,
// 64-column tile of F) and walks D itself in tiles of 32, staged through
// shared memory as f32; the next tile's loads are issued into registers
// before the current tile's products, so they are in flight meanwhile.
// Each thread keeps a 4x4 f32 accumulator in registers (rows ty + 16 i,
// columns tx + 16 j: conflict-free shared reads and coalesced writes).
// Two blocks fit an SM (at most 128 registers a thread; fully unrolled,
// the product loop took 159, which left one block an SM and ran slower).
// Ragged C, D and F are masked; the rows of a tile past C are neither
// loaded nor multiplied (at a decode step's C = 2, seven of a block's
// eight warps skip the products).  Nothing is launched when C, E or F is
// 0.
//
// Bound on an H100 (bf16, 3.35 TB/s, 989 TFLOP/s): at granite-moe's
// prefill (E 32, C 200, D 1024, F 512) 53.2 MB for 6.71 GFLOP: 15.9 us,
// bytes; at its decode step (C 2) the 33.6 MB of weights, 10.1 us.  This
// first version multiplies on the CUDA cores in f32 (67 TFLOP/s at most,
// so 100 us for the prefill product) and reads every expert's weights
// whether its bucket holds tokens or not; tensor-core MMAs (mma.sync, then
// wgmma fed by TMA) and skipping empty buckets are the later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;     // rows of C per block
constexpr int BN = 64;     // columns of F per block
constexpr int BK = 32;     // depth of one D tile
constexpr int NT = 256;    // threads per block: a 16 x 16 grid
constexpr int PER = BM * BK / NT;  // x (and w) tile elements each thread loads

static_assert(BM * BK == BK * BN && PER == 8, "tiles are 8 loads a thread");
static_assert(BM == 64 && BN == 64 && NT == 256, "4x4 outputs a thread");

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

struct Args {
  const void* x;
  const void* w;
  void* out;
  int C, D, F;
  long long xs_e, xs_c;  // x strides (expert, row of C)
  long long ws_e, ws_d;  // w strides (expert, row of D)
};

// Loads the D tile at k0: x rows [m0, m0 + rows) and w columns [n0, n0+BN),
// zero outside the matrices.  Element i of a thread is tile index
// tid + i * NT: x (row idx / BK, depth idx % BK), w (depth idx / BN,
// column idx % BN), so a warp reads 32 consecutive elements of one row.
template <typename T>
__device__ __forceinline__ void load_tile(const T* x, const T* w,
                                          const Args& a, int m0, int rows,
                                          int n0, int k0, int tid,
                                          float (&ra)[PER], float (&rb)[PER]) {
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = tid + i * NT;
    const int m = idx / BK, k = k0 + idx % BK;
    ra[i] = (m < rows && k < a.D)
                ? to_f(x[(long long)(m0 + m) * a.xs_c + k]) : 0.f;
    const int kk = k0 + idx / BN, n = n0 + idx % BN;
    rb[i] = (kk < a.D && n < a.F) ? to_f(w[(long long)kk * a.ws_d + n]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) gmm_fwd(Args a) {
  __shared__ float As[BM][BK + 1];   // padded: a warp reads two rows at once
  __shared__ float Bs[BK][BN];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int rows = min(BM, a.C - m0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* x = static_cast<const T*>(a.x) + (long long)e * a.xs_e;
  const T* w = static_cast<const T*>(a.w) + (long long)e * a.ws_e;

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

  T* out = static_cast<T*>(a.out) + ((long long)e * a.C + m0) * a.F;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty + 16 * i;
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < a.F) out[(long long)m * a.F + n] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const Args& a, int E, cudaStream_t stream) {
  const dim3 grid((a.F + BN - 1) / BN, (a.C + BM - 1) / BM, E);
  gmm_fwd<T><<<grid, NT, 0, stream>>>(a);
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
  if (E < 0 || C < 0 || D < 0 || F < 0 || E > 65535 || C > 65535 * BM)
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
    case 0: return launch<float>(args, E, s);
    case 1: return launch<__half>(args, E, s);
    case 2: return launch<__nv_bfloat16>(args, E, s);
    default: return cudaErrorInvalidValue;
  }
}
