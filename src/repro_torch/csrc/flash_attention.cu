// Flash-attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/flash_attention.py:_flash_kernel (launched by flash_attention):
//   out = softmax(q k^T * scale [causal]) v
// with an online max and sum over k tiles, f32 accumulators, and the
// result written in q's dtype.
//
// Layout: q (B,H,Sq,dh), k/v (B,KV,Sk,dh), o (B,H,Sq,dh), each given by its
// (batch, head, seq) strides in elements with a unit stride on dh, so the
// caller may pass transposed views without a copy.  Query head h reads KV
// head h / (H / KV) (native GQA; KV == H is the Pallas kernel's case).
//
// Mask: the causal mask is bottom-right aligned like the oracle
// (kernels/ref.py attention_ref, tril(k = Sk - Sq)): key j is visible to
// query i iff j <= i + Sk - Sq.  Masked scores are NEG_INF (-1e30), as in
// the oracle, so a fully masked row averages v uniformly there too; keys
// past Sk (the ragged tail of the last tile) are -inf and add nothing.
//
// Head dims 16, 32, 64, 80 and 128 are instantiated; each lane owns the
// output columns lane + 32 c, so dh 80 leaves the third column's upper
// lanes idle and needs no padding.
//
// Design.  One block owns one (batch, head, 64-row q tile); a loop inside
// the block walks the 64-row k tiles (the Pallas grid's sequential k axis).
// Q, K and V tiles are staged in shared memory as f32, so one code path
// serves f32, f16 and bf16.  256 threads: for S = Q K^T each thread owns a
// 4x4 micro-tile; for the softmax and for P V each warp owns 8 query rows,
// so the row statistics and the output accumulator stay in registers.
// Scores carry scale * log2(e), and exp2 replaces exp.  When every row of
// the q tile sees key 0 (causal with Sq <= Sk), k tiles wholly above the
// diagonal are skipped: their probabilities are exactly 0.
//
// Bound on an H100 at phi4-mini prefill shapes (B=1, H=24, KV=8, S=512,
// dh=128, bf16): q, k, v and o are 8.4 MB and the causal work 1.6 GFLOP,
// so the card's floor is the 2.5 us of memory traffic, not the 1.6 us of
// tensor-core math.  This first version does its math on the CUDA cores
// in f32 and reloads each K/V tile once per q tile; it is far from that
// floor.  Tensor-core MMAs (wgmma) and TMA loads are the later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // key rows per tile
constexpr int NT = 256;                // threads per block
constexpr int WARPS = NT / 32;
constexpr int ROWS = BQ / WARPS;       // query rows per warp (softmax, PV)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

static_assert(BK == 64, "the softmax step gives each lane two columns");
static_assert(BQ == 64 && NT == 256, "S micro-tiles are 4x4 on a 16x16 grid");

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, KV, Sq, Sk;
  long long qs[3], ks[3], vs[3], os[3];  // (batch, head, seq) strides
  float scale_log2;                       // softmax scale * log2(e)
  int causal;
};

template <int DH>
constexpr int smem_floats() {
  return BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1);
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) flash_fwd(Args a) {
  extern __shared__ float smem[];
  constexpr int QP = DH + 1;            // padded rows: no bank conflicts
  constexpr int SP = BK + 1;
  constexpr int NC = (DH + 31) / 32;    // output columns per lane
  float* sQ = smem;                     // [BQ][QP], pre-scaled
  float* sK = sQ + BQ * QP;             // [BK][QP]
  float* sV = sK + BK * QP;             // [BK][DH]
  float* sS = sV + BK * DH;             // [BQ][SP] scores, then probabilities

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const T* qp = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T* kp = static_cast<const T*>(a.k) + b * a.ks[0] + kvh * a.ks[1];
  const T* vp = static_cast<const T*>(a.v) + b * a.vs[0] + kvh * a.vs[1];
  T* op = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[1];
  const int diag = a.Sk - a.Sq;         // j visible to i iff j <= i + diag

  for (int idx = tid; idx < BQ * DH; idx += NT) {
    const int r = idx / DH, d = idx % DH, i = q0 + r;
    sQ[r * QP + d] = i < a.Sq ? to_f(qp[i * a.qs[2] + d]) * a.scale_log2 : 0.f;
  }

  // Skip k tiles wholly above the diagonal only when every query row sees
  // key 0; otherwise a fully masked row must still average all of v.
  int kv_end = a.Sk;
  if (a.causal && diag >= 0) kv_end = min(a.Sk, q0 + BQ + diag);
  const int n_tiles = (kv_end + BK - 1) / BK;

  const int r0 = warp * ROWS;           // this warp's rows (softmax, PV)
  const int tr = tid >> 4, tc = tid & 15;   // S micro-tile coordinates
  float m[ROWS], l[ROWS], acc[ROWS][NC];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[rr][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();                    // last tile's sK/sV/sS reads done
    for (int idx = tid; idx < BK * DH; idx += NT) {
      const int r = idx / DH, d = idx % DH, j = k0 + r;
      const bool in = j < a.Sk;
      sK[r * QP + d] = in ? to_f(kp[j * a.ks[2] + d]) : 0.f;
      sV[r * DH + d] = in ? to_f(vp[j * a.vs[2] + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = sQ[(tr * 4 + r) * QP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = sK[(tc + 16 * c) * QP + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + tr * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tc + 16 * c;
        float x = s[r][c];
        if (j >= a.Sk)
          x = -INFINITY;
        else if (a.causal && j > i + diag)
          x = NEG_INF;
        sS[(tr * 4 + r) * SP + tc + 16 * c] = x;
      }
    }
    __syncthreads();

    // Online softmax over this tile; each lane owns columns lane, lane+32.
    float alpha[ROWS];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      float* row = sS + (r0 + rr) * SP;
      const float x0 = row[lane], x1 = row[lane + 32];
      const float m_new = fmaxf(m[rr], warp_max(fmaxf(x0, x1)));
      alpha[rr] = exp2f(m[rr] - m_new);
      const float p0 = exp2f(x0 - m_new), p1 = exp2f(x1 - m_new);
      l[rr] = l[rr] * alpha[rr] + warp_sum(p0 + p1);
      m[rr] = m_new;
      row[lane] = p0;
      row[lane + 32] = p1;
    }
    __syncwarp();

    // acc = alpha * acc + P V over this warp's rows.
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[rr][c] *= alpha[rr];
    for (int j = 0; j < BK; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < DH ? sV[j * DH + d] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const float p = sS[(r0 + rr) * SP + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[rr][c] = fmaf(p, vv[c], acc[rr][c]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int i = q0 + r0 + rr;
    if (i >= a.Sq) continue;
    const float den = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < DH) op[i * a.os[2] + d] = from_f<T>(acc[rr][c] / den);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int smem = smem_floats<DH>() * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, B);
  flash_fwd<T, DH><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const Args& a, int B, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16>(a, B, stream);
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 80: return launch<T, 80>(a, B, stream);    // zamba2's shared attention
    case 128: return launch<T, 128>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (q, k, v and o alike).
// strides: 12 element strides, (batch, head, seq) of q, k, v, then o.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int dtype,
                                         int B, int H, int KV, int Sq, int Sk,
                                         int dh, const long long* strides,
                                         float scale, int causal,
                                         void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1)
    return cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.H = H;
  a.KV = KV;
  a.Sq = Sq;
  a.Sk = Sk;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.scale_log2 = scale * LOG2E;
  a.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dh<float>(a, B, dh, s);
    case 1: return launch_dh<__half>(a, B, dh, s);
    case 2: return launch_dh<__nv_bfloat16>(a, B, dh, s);
    default: return cudaErrorInvalidValue;
  }
}
