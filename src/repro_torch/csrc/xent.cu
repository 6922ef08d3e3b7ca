// Fused softmax cross-entropy, forward and backward, for Hopper (sm_90a),
// plain CUDA C++.
//
// Replaces the JAX package's Pallas TPU kernels
//   kernels/xent.py:_xent_fwd_kernel (launched by _fwd_call):
//     per row r of logits (R, V): sc = softcap * tanh(s / softcap) (or s),
//     lse[r] = max + log(max(sum exp(sc - max), 1e-30)),
//     nll[r] = lse[r] - sc[r, label[r]]  (gold = 0 for a label outside [0, V));
//   kernels/xent.py:_xent_bwd_kernel (launched by _bwd_call):
//     dlogits[r, j] = dy[r] * (exp(sc - lse[r]) - onehot) * dsc,
//     dsc = 1 - tanh^2 with a softcap, else 1; written in the logits' dtype.
//
// Layout: logits (R, V) with a unit column stride and a row stride in
// elements (f32 or bf16; math in f32); labels (R,) int32; nll, lse
// and dy (R,) f32; dlogits (R, V) contiguous.  Ragged V needs no padding:
// every loop is bounded by V.
//
// Design.  The Pallas forward walks vocab tiles in grid order and carries
// (max, sum, gold) across them in VMEM scratch.  CUDA blocks run in no
// order, so one block owns one row and its 256 threads stride over V, each
// with its own online (max, sum); a warp-shuffle and then a shared-memory
// reduction merge the 256 pairs, and thread 0 reads the gold logit once.
// The backward has no cross-tile state: each thread recomputes softmax
// entries from the saved lse.  Both are elementwise or a reduction over
// bytes read once: at the port's loss chunk (R = 1024 rows, V = 200,064,
// f32) the forward reads 819 MB (0.245 ms at 3.35 TB/s) and the backward
// reads and writes 1.64 GB (0.49 ms); the exp/tanh arithmetic is about a
// twentieth of that at the f32 rate.  So memory traffic bounds both, and
// the design reads each logit once in the forward and once in the
// backward, with loads coalesced across a warp and four independent loads
// in flight per thread.  The steps of the backward's product are rounded
// one at a time (no fused multiply-add) in the order the plain version
// takes them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;                // threads per block
constexpr int WARPS = NT / 32;
constexpr int ITEMS = 4;               // loads in flight per thread
constexpr float NEG_INF = -1e30f;

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

// softcap * tanh(s / softcap); cap <= 0 means no cap.
__device__ __forceinline__ float capped(float s, float cap) {
  return cap > 0.f ? __fmul_rn(cap, tanhf(__fdiv_rn(s, cap))) : s;
}

// Merge two online (max, sum) pairs.  Empty pairs are (NEG_INF, 0) and
// merge to (NEG_INF, 0) with no NaN: exp(0) * 0.
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(NT)
xent_fwd(const T* __restrict__ logits, long long row_stride,
         const int* __restrict__ labels, float* __restrict__ nll,
         float* __restrict__ lse, int V, float cap) {
  const long long r = blockIdx.x;
  const T* row = logits + r * row_stride;
  float m = NEG_INF, l = 0.f;
  for (int base = threadIdx.x; base < V; base += NT * ITEMS) {
    float s[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = base + i * NT;
      s[i] = j < V ? to_f(row[j]) : NEG_INF;
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (base + i * NT >= V) break;
      const float x = capped(s[i], cap);
      if (x > m) {
        l = l * expf(m - x) + 1.f;
        m = x;
      } else {
        l += expf(x - m);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    merge(m, l, m2, l2);
  }
  __shared__ float sm[WARPS], sl[WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w) merge(m, l, sm[w], sl[w]);
    const int lab = labels[r];
    const float gold = (lab >= 0 && lab < V) ? capped(to_f(row[lab]), cap)
                                             : 0.f;
    const float out = m + logf(fmaxf(l, 1e-30f));
    lse[r] = out;
    nll[r] = out - gold;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
xent_bwd(const T* __restrict__ logits, long long row_stride,
         const int* __restrict__ labels, const float* __restrict__ lse,
         const float* __restrict__ dy, T* __restrict__ dlogits, int V,
         float cap) {
  const long long r = blockIdx.x;
  const T* row = logits + r * row_stride;
  T* out = dlogits + r * static_cast<long long>(V);
  const int lab = labels[r];
  const float lr = lse[r], d = dy[r];
  const int step = gridDim.y * NT * ITEMS;
  for (int base = blockIdx.y * NT * ITEMS + threadIdx.x; base < V;
       base += step) {
    float s[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = base + i * NT;
      s[i] = j < V ? to_f(row[j]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = base + i * NT;
      if (j >= V) break;
      float sc = s[i], dsc = 1.f;
      if (cap > 0.f) {
        const float t = tanhf(__fdiv_rn(s[i], cap));
        sc = __fmul_rn(cap, t);
        dsc = __fsub_rn(1.f, __fmul_rn(t, t));
      }
      const float p = expf(__fsub_rn(sc, lr));
      float g = __fmul_rn(d, __fsub_rn(p, j == lab ? 1.f : 0.f));
      if (cap > 0.f) g = __fmul_rn(g, dsc);
      out[j] = from_f<T>(g);
    }
  }
}

template <typename T>
cudaError_t launch_fwd(const void* logits, long long row_stride,
                       const int* labels, float* nll, float* lse, int R, int V,
                       float cap, cudaStream_t stream) {
  xent_fwd<T><<<R, NT, 0, stream>>>(static_cast<const T*>(logits), row_stride,
                                    labels, nll, lse, V, cap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* logits, long long row_stride,
                       const int* labels, const float* lse, const float* dy,
                       void* dlogits, int R, int V, float cap,
                       cudaStream_t stream) {
  const int tiles = (V + NT * ITEMS - 1) / (NT * ITEMS);
  const dim3 grid(R, tiles < 65535 ? tiles : 65535);
  xent_bwd<T><<<grid, NT, 0, stream>>>(static_cast<const T*>(logits),
                                       row_stride, labels, lse, dy,
                                       static_cast<T*>(dlogits), V, cap);
  return cudaGetLastError();
}

}  // namespace

// dtype of logits (and dlogits): 0 = float32, 2 = bfloat16.
// row_stride: elements between rows of logits (dlogits is contiguous).
// softcap: > 0 applies softcap * tanh(s / softcap); 0 means none.
// Each returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_torch_xent_fwd(const void* logits, const void* labels,
                                    void* nll, void* lse, int dtype, int R,
                                    int V, long long row_stride, float softcap,
                                    void* stream) {
  if (R < 1 || V < 1 || row_stride < V) return cudaErrorInvalidValue;
  const int* lab = static_cast<const int*>(labels);
  float* n = static_cast<float*>(nll);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_fwd<float>(logits, row_stride, lab, n, l, R, V,
                                     softcap, s);
    case 2: return launch_fwd<__nv_bfloat16>(logits, row_stride, lab, n, l, R,
                                             V, softcap, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int repro_torch_xent_bwd(const void* logits, const void* labels,
                                    const void* lse, const void* dy,
                                    void* dlogits, int dtype, int R, int V,
                                    long long row_stride, float softcap,
                                    void* stream) {
  if (R < 1 || V < 1 || row_stride < V) return cudaErrorInvalidValue;
  const int* lab = static_cast<const int*>(labels);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_bwd<float>(logits, row_stride, lab, l, d, dlogits, R,
                                     V, softcap, s);
    case 2: return launch_bwd<__nv_bfloat16>(logits, row_stride, lab, l, d,
                                             dlogits, R, V, softcap, s);
    default: return cudaErrorInvalidValue;
  }
}
