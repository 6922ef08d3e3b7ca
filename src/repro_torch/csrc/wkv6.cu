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
// s_last (B,H,hd_k,hd_v) f32, contiguous: the decode cache's layout.  The
// Pallas grid is (batch*heads, chunks) with the chunk axis sequential and
// the state in VMEM scratch; on Hopper nothing carries over between
// blocks, so the two paths below differ in what walks the chunks.
//
// Bound on an H100 at rwkv6's prefill (B=1, S=512, H=32, hd=64, bf16
// r/k/v): about 15.2 MB in and out, 4.5 us at 3.35 TB/s; the recurrence's
// 5 hd^2 operations a token and head (3 hd^2 for diag(w) S + k^T v, 2 hd^2
// for r S; the bonus is O(hd)) are 0.34 GFLOP, 0.34 us on the tensor cores
// (5.0 us at f32's 67 TFLOP/s on the CUDA cores).  So the bytes bound it.
//
// bf16 with hd a multiple of 16 up to 128: the tensor-core path, the
// chunk-state / state-passing / chunk-scan form in three launches on the
// caller's stream, 64-row chunks (a ragged last one is zero-filled) of
// four 16-row sub-chunks, 4 warps a block:
//   wkv_fwd_state, one block per (batch, chunk, head): the per-channel
//     cumulative sums (serial per channel, the reference's order), the
//     chunk's decays exp(cum_end) and its local state
//     dS = (k exp(cum_end - cum))^T v, into an f32 scratch (B, chunks, H,
//     hd, hd);
//   wkv_fwd_pass, one thread per (batch, head, state element): walks the
//     chunks in f32, S_c = diag(exp(cum_end_c)) S_{c-1} + dS_c from s0,
//     writes the state entering each chunk over its dS, and s_last;
//   wkv_fwd_scan, one block per (batch, chunk, head), warp w on sub-chunk
//     w: for s in an earlier sub-chunk, att(t,s) is one product of
//     r~_t = r_t exp(cum_{t-1} - cum_b) and k~_s = k_s exp(cum_b - cum_s)
//     with b the row before t's sub-chunk (both exponents <= 0; with logw
//     at the model's -8 floor a factor reaches e^-384 and flushes to 0 in
//     f32, and the true term is smaller still); only the 16-row diagonal
//     keeps one exact exp a pair and channel (its 120 pairs shared by the
//     warp's lanes), with the bonus r_t (u k_t) at s = t; then
//     y = att v + (r exp(cum_{t-1})) S_in.
// Every product is mma.sync m16n8k16 with f32 sums.  r, k and v are exact
// bf16 operands; r~, k~, att, the decayed k and r and the state are f32,
// and rounding them to bf16 (2^-8) or TF32 (2^-11) would break the 1e-4
// tolerance, so each goes in as a hi + lo pair of bf16 (two products
// against an exact operand, three between two split ones; about 2^-17 of
// the value; tc::split_bf2).  At rwkv6's prefill that is 256 blocks, two an
// SM by shared memory.  What holds it back is latency: the scan's phases
// (loads, per-channel sums, q, products) wait on each other at
// __syncthreads with 8 warps an SM, the last sub-chunk's warp has six more
// r~ k~^T tiles than the first, and the state scratch makes three trips
// through memory (PERF.md).
//
// f32, f16, and widths the path does not take: wkv_fwd, the CUDA-core
// kernel of the first port.  One block owns one (batch, head, slice of
// DS = 16 value columns): y[:, j] and S[:, j] depend on column j of v
// alone, so the block keeps its (hd, DS) slice of the state in shared
// memory and walks the chunks in order.  Per chunk of L = 32 rows it
// stages r, k, logw and its v columns as f32, takes the per-channel sums
// serially, then att(t,s) for the L(L-1)/2 pairs s < t (one exp a pair
// and channel), y, and the state update, all in f32 FMA.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_sm80.cuh"

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


// ----------------------------------------------------------- bf16, tensor
// cores: chunk state, state passing, chunk scan (see the header)

using bf16 = __nv_bfloat16;
constexpr int TL = 64;       // chunk rows, four sub-chunks of 16
constexpr int SUB = 16;      // sub-chunk rows
constexpr int TNT = 128;     // 4 warps, one sub-chunk each
constexpr int TMAX = 128;    // largest hd of the path
constexpr int PNT = 256;     // threads of a state-passing block

struct TcArgs {
  const bf16* r;
  const bf16* k;
  const bf16* v;
  const float* w;    // logw
  const float* u;
  const float* s0;   // may be null
  float* y;
  float* s_last;
  float* states;     // (B, nc, H, hd, hd): dS_c, then the state entering c
  float* decay;      // (B, nc, H, hd): exp(cum_end_c)
  int S, H, hd, nc;
  long long rs[3], ks[3], vs[3], ws[3];
};

int state_smem(int hd) {
  return 2 * TL * (hd + 8) * 2 + TL * (hd + 4) * 4;
}

int scan_smem(int hd) {
  return 5 * TL * (hd + 8) * 2 + 2 * hd * (hd + 8) * 2 +
         2 * TL * (hd + 4) * 4 + hd * 4 + (TNT / 32) * SUB * (SUB + 1) * 4;
}

// Per-channel cumulative sums of logw (rows past the chunk's end hold 0)
// in the reference's serial order, one thread a channel: cum_t to cum and,
// where prev is given, cum_{t-1} = cum_t - logw_t to prev.  lw may be cum
// or prev: each batch of 16 rows is read before it is written.
__device__ __forceinline__ void channel_cumsum(const float* lw, float* cum,
                                               float* prev, int LC, int hd,
                                               int tid) {
  for (int ch = tid; ch < hd; ch += TNT) {
    float c = 0.f;
    for (int r0 = 0; r0 < TL; r0 += 16) {
      float x[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) x[i] = lw[(r0 + i) * LC + ch];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        c += x[i];
        cum[(r0 + i) * LC + ch] = c;
        if (prev != nullptr) prev[(r0 + i) * LC + ch] = c - x[i];
      }
    }
  }
}

// dS[i][j] = sum_s k_s[i] exp(cum_end[i] - cum_s[i]) v_s[j]; the warps own
// 16-row strips of i, the product's M.
__global__ void __launch_bounds__(TNT) wkv_fwd_state(TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LD = a.hd + 8, LC = a.hd + 4;
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);          // [TL][LD]
  bf16* sV = sK + TL * LD;                               // [TL][LD]
  float* sCum = reinterpret_cast<float*>(sV + TL * LD);  // [TL][LC]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const tc::Lanes ln(lane);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * TL, lc = min(TL, a.S - t0);
  tc::cp_rows(sK, LD * 2, a.k + b * a.ks[0] + t0 * a.ks[1] + h * a.ks[2],
              a.ks[1] * 2, TL, lc, a.hd * 2, tid, TNT);
  tc::cp_rows(sV, LD * 2, a.v + b * a.vs[0] + t0 * a.vs[1] + h * a.vs[2],
              a.vs[1] * 2, TL, lc, a.hd * 2, tid, TNT);
  tc::cp_rows(sCum, LC * 4, a.w + b * a.ws[0] + t0 * a.ws[1] + h * a.ws[2],
              a.ws[1] * 4, TL, lc, a.hd * 4, tid, TNT);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  channel_cumsum(sCum, sCum, nullptr, LC, a.hd, tid);
  __syncthreads();
  const float* cend = sCum + (TL - 1) * LC;
  const long long bch = (static_cast<long long>(b) * a.nc + c) * a.H + h;
  for (int ch = tid; ch < a.hd; ch += TNT)
    a.decay[bch * a.hd + ch] = expf(cend[ch]);

  float* out = a.states + bch * a.hd * a.hd;
  for (int is = warp; is < a.hd / 16; is += TNT / 32) {
    // A = (k exp(cum_end - cum))^T: rows i, k = s, from k stored [s][i]
    // (.trans); register r holds rows i = 16 is + g + 8 (r % 2) and
    // s = 16 ks + 8 (r / 2) + 2 q (+1)
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t raw[4];
      tc::ldmatrix_x4_trans(raw, sK + (ks * 16 + ln.kr) * LD + is * 16 + ln.kc);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = is * 16 + ln.g + (r & 1) * 8;
        const int s = ks * 16 + (r >> 1) * 8 + 2 * ln.q;
        const float2 kv = tc::unpack_bf2(raw[r]);
        tc::split_bf2(kv.x * expf(cend[i] - sCum[s * LC + i]),
                      kv.y * expf(cend[i] - sCum[(s + 1) * LC + i]),
                      ahi[ks][r], alo[ks][r]);
      }
    }
    for (int jb = 0; jb < a.hd / 16; ++jb) {
      float acc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t bv[4];  // B: k = s, j contiguous (.trans)
        tc::ldmatrix_x4_trans(bv, sV + (ks * 16 + ln.ar) * LD + jb * 16 + ln.ac);
        tc::mma16816<bf16>(acc[0], ahi[ks], bv[0], bv[1]);
        tc::mma16816<bf16>(acc[0], alo[ks], bv[0], bv[1]);
        tc::mma16816<bf16>(acc[1], ahi[ks], bv[2], bv[3]);
        tc::mma16816<bf16>(acc[1], alo[ks], bv[2], bv[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float* o = out + (is * 16 + ln.g) * a.hd + jb * 16 + j * 8 + 2 * ln.q;
        *reinterpret_cast<float2*>(o) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(o + 8 * a.hd) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
  }
}

// S_c = diag(exp(cum_end_c)) S_{c-1} + dS_c from s0, in f32 and in the
// chunks' order; the state entering chunk c replaces dS_c, the last goes
// to s_last.
__global__ void __launch_bounds__(PNT) wkv_fwd_pass(TcArgs a) {
  const long long E = static_cast<long long>(a.hd) * a.hd, HE = a.H * E;
  const long long idx = blockIdx.x * static_cast<long long>(PNT) + threadIdx.x;
  if (idx >= HE) return;
  const int b = blockIdx.y;
  float st = a.s0 != nullptr ? a.s0[b * HE + idx] : 0.f;
  const long long HK = static_cast<long long>(a.H) * a.hd;
  a.s_last[b * HE + idx] = tc::pass_states(
      st, a.states + b * a.nc * HE + idx, HE,
      a.decay + b * a.nc * HK + idx / a.hd, HK, a.nc);   // row h hd + i
}

// y = att v + (r exp(cum_{t-1})) S_in; warp w owns sub-chunk w (rows t),
// the products' M.  att(t,s) for s in earlier sub-chunks is the product
// (r_t exp(cum_{t-1} - cum_b)) (k_s exp(cum_b - cum_s))^T through the row
// b = 16 w - 1 before the sub-chunk (both exponents <= 0; a factor that
// underflows belongs to a term smaller still); inside the sub-chunk one
// exp a pair and channel, and r_t (u k_t) at s = t.
__global__ void __launch_bounds__(TNT) wkv_fwd_scan(TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LD = a.hd + 8, LC = a.hd + 4;
  bf16* sR = reinterpret_cast<bf16*>(smem_raw);           // [TL][LD]
  bf16* sK = sR + TL * LD;                                // [TL][LD]
  bf16* sV = sK + TL * LD;                                // [TL][LD]
  bf16* sQhi = sV + TL * LD;                              // [TL][LD]
  bf16* sQlo = sQhi + TL * LD;                            // [TL][LD]
  bf16* sShi = sQlo + TL * LD;                            // [hd][LD]
  bf16* sSlo = sShi + a.hd * LD;                          // [hd][LD]
  float* sCum = reinterpret_cast<float*>(sSlo + a.hd * LD);  // [TL][LC]
  float* sCp = sCum + TL * LC;                            // [TL][LC]
  float* sU = sCp + TL * LC;                              // [hd]
  float* sD = sU + a.hd;                // [4][SUB][SUB + 1] diagonal tiles

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const tc::Lanes ln(lane);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * TL, lc = min(TL, a.S - t0);
  const long long bch = (static_cast<long long>(b) * a.nc + c) * a.H + h;
  tc::cp_rows(sR, LD * 2, a.r + b * a.rs[0] + t0 * a.rs[1] + h * a.rs[2],
              a.rs[1] * 2, TL, lc, a.hd * 2, tid, TNT);
  tc::cp_rows(sK, LD * 2, a.k + b * a.ks[0] + t0 * a.ks[1] + h * a.ks[2],
              a.ks[1] * 2, TL, lc, a.hd * 2, tid, TNT);
  tc::cp_rows(sV, LD * 2, a.v + b * a.vs[0] + t0 * a.vs[1] + h * a.vs[2],
              a.vs[1] * 2, TL, lc, a.hd * 2, tid, TNT);
  tc::cp_rows(sCp, LC * 4, a.w + b * a.ws[0] + t0 * a.ws[1] + h * a.ws[2],
              a.ws[1] * 4, TL, lc, a.hd * 4, tid, TNT);
  tc::cp_async_commit();
  tc::split_rows(sShi, sSlo, LD, a.states + bch * a.hd * a.hd,
                 a.hd * a.hd, a.hd, tid, TNT);
  for (int i = tid; i < a.hd; i += TNT) sU[i] = a.u[h * a.hd + i];
  tc::cp_async_wait<0>();
  __syncthreads();
  channel_cumsum(sCp, sCum, sCp, LC, a.hd, tid);
  __syncthreads();
  // q = r exp(cum_{t-1}), hi + lo, the A operand of the carried state
  for (int i = tid; i < TL * a.hd / 2; i += TNT) {
    const int t = i / (a.hd / 2), ch = 2 * (i % (a.hd / 2));
    const float2 rv =
        tc::unpack_bf2(*reinterpret_cast<const uint32_t*>(sR + t * LD + ch));
    uint32_t hi, lo;
    tc::split_bf2(rv.x * expf(sCp[t * LC + ch]),
                  rv.y * expf(sCp[t * LC + ch + 1]), hi, lo);
    *reinterpret_cast<uint32_t*>(sQhi + t * LD + ch) = hi;
    *reinterpret_cast<uint32_t*>(sQlo + t * LD + ch) = lo;
  }
  __syncthreads();

  const int sub = warp, tr0 = sub * 16 + ln.g, tr1 = tr0 + 8;
  float att[8][4] = {};   // n8 tiles of s; tiles 0 .. 2 sub - 1 are used
  if (sub > 0) {
    const float* cb = sCum + (sub * 16 - 1) * LC;   // cum_b
    for (int ks = 0; ks < a.hd / 16; ++ks) {
      const int c0 = ks * 16 + 2 * ln.q;   // channels c0, c0+1, c0+8, c0+9
      uint32_t rhi[4], rlo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = (r & 1) ? tr1 : tr0, ch = c0 + (r >> 1) * 8;
        const float2 rv =
            tc::unpack_bf2(*reinterpret_cast<const uint32_t*>(sR + t * LD + ch));
        const float2 cp = *reinterpret_cast<const float2*>(sCp + t * LC + ch);
        const float2 cbv = *reinterpret_cast<const float2*>(cb + ch);
        tc::split_bf2(rv.x * expf(cp.x - cbv.x), rv.y * expf(cp.y - cbv.y),
                      rhi[r], rlo[r]);
      }
#pragma unroll
      for (int n = 0; n < 6; ++n) {
        if (n < 2 * sub) {
          const int s = n * 8 + ln.g;
          uint32_t khi[2], klo[2];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int ch = c0 + hh * 8;
            const float2 kv = tc::unpack_bf2(
                *reinterpret_cast<const uint32_t*>(sK + s * LD + ch));
            const float2 cs = *reinterpret_cast<const float2*>(sCum + s * LC + ch);
            const float2 cbv = *reinterpret_cast<const float2*>(cb + ch);
            tc::split_bf2(kv.x * expf(cbv.x - cs.x), kv.y * expf(cbv.y - cs.y),
                          khi[hh], klo[hh]);
          }
          tc::mma16816<bf16>(att[n], rhi, khi[0], khi[1]);
          tc::mma16816<bf16>(att[n], rhi, klo[0], klo[1]);
          tc::mma16816<bf16>(att[n], rlo, khi[0], khi[1]);
        }
      }
    }
  }

  // the diagonal sub-chunk, one exp a pair and channel: the warp's lanes
  // share its 120 pairs s < t (numbered row by row: pair p is t' (t' - 1)
  // / 2 + s' with s' < t' in the sub-chunk) and its 16 bonus terms
  // r_t (u k_t), into a 16 x 16 tile of shared memory
  float* sDw = sD + warp * SUB * (SUB + 1);
  for (int p = lane; p < SUB * (SUB - 1) / 2; p += 32) {
    int tt = static_cast<int>((1.f + sqrtf(1.f + 8.f * p)) * 0.5f);
    if (tt * (tt - 1) / 2 > p) --tt;
    if (tt * (tt + 1) / 2 <= p) ++tt;
    const int ss = p - tt * (tt - 1) / 2;
    const bf16* rt = sR + (sub * SUB + tt) * LD;
    const bf16* ks = sK + (sub * SUB + ss) * LD;
    const float* pt = sCp + (sub * SUB + tt) * LC;
    const float* cs = sCum + (sub * SUB + ss) * LC;
    float acc = 0.f;
    for (int ch = 0; ch < a.hd; ch += 2) {
      const float2 rv = tc::unpack_bf2(*reinterpret_cast<const uint32_t*>(rt + ch));
      const float2 kv = tc::unpack_bf2(*reinterpret_cast<const uint32_t*>(ks + ch));
      const float2 pv = *reinterpret_cast<const float2*>(pt + ch);
      const float2 cv = *reinterpret_cast<const float2*>(cs + ch);
      acc = fmaf(rv.x * kv.x, expf(pv.x - cv.x), acc);
      acc = fmaf(rv.y * kv.y, expf(pv.y - cv.y), acc);
    }
    sDw[tt * (SUB + 1) + ss] = acc;
  }
  if (lane < SUB) {
    const bf16* rt = sR + (sub * SUB + lane) * LD;
    const bf16* kt = sK + (sub * SUB + lane) * LD;
    float acc = 0.f;
    for (int ch = 0; ch < a.hd; ++ch)
      acc = fmaf(__bfloat162float(rt[ch]) * sU[ch], __bfloat162float(kt[ch]),
                 acc);
    sDw[lane * (SUB + 1) + lane] = acc;
  }
  __syncwarp();
  // dg[4 hh + rr]: t' = g + 8 (rr / 2), s' = 8 hh + 2 q + rr % 2, the
  // layout of n8 tiles 2 sub and 2 sub + 1
  float dg[8];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int tt = ln.g + (rr >> 1) * 8, ss = hh * 8 + 2 * ln.q + (rr & 1);
      dg[hh * 4 + rr] = ss <= tt ? sDw[tt * (SUB + 1) + ss] : 0.f;
    }
  }

  // att as the A fragments of att v, hi + lo: k16 step kk < sub from the
  // product's tiles 2 kk, 2 kk + 1, step sub from the diagonal
  uint32_t ahi[4][4], alo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk < sub) {
      tc::split_bf2(att[2 * kk][0], att[2 * kk][1], ahi[kk][0], alo[kk][0]);
      tc::split_bf2(att[2 * kk][2], att[2 * kk][3], ahi[kk][1], alo[kk][1]);
      tc::split_bf2(att[2 * kk + 1][0], att[2 * kk + 1][1], ahi[kk][2],
                    alo[kk][2]);
      tc::split_bf2(att[2 * kk + 1][2], att[2 * kk + 1][3], ahi[kk][3],
                    alo[kk][3]);
    } else if (kk == sub) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        tc::split_bf2(dg[2 * r], dg[2 * r + 1], ahi[kk][r], alo[kk][r]);
    }
  }

  const long long y_row = static_cast<long long>(a.H) * a.hd;
  float* y0 = a.y + (static_cast<long long>(b) * a.S + t0 + tr0) * y_row +
              static_cast<long long>(h) * a.hd;
  float* y1 = y0 + 8 * y_row;
  for (int jb = 0; jb < a.hd / 16; ++jb) {
    float acc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk <= sub) {
        uint32_t bv[4];  // B: k = s, j contiguous (.trans)
        tc::ldmatrix_x4_trans(bv, sV + (kk * 16 + ln.ar) * LD + jb * 16 + ln.ac);
        tc::mma16816<bf16>(acc[0], ahi[kk], bv[0], bv[1]);
        tc::mma16816<bf16>(acc[0], alo[kk], bv[0], bv[1]);
        tc::mma16816<bf16>(acc[1], ahi[kk], bv[2], bv[3]);
        tc::mma16816<bf16>(acc[1], alo[kk], bv[2], bv[3]);
      }
    }
    for (int ks = 0; ks < a.hd / 16; ++ks) {
      uint32_t qh[4], ql[4], sh[4], sl[4];  // S: k = i, j contiguous (.trans)
      tc::ldmatrix_x4(qh, sQhi + (sub * 16 + ln.ar) * LD + ks * 16 + ln.ac);
      tc::ldmatrix_x4(ql, sQlo + (sub * 16 + ln.ar) * LD + ks * 16 + ln.ac);
      tc::ldmatrix_x4_trans(sh, sShi + (ks * 16 + ln.ar) * LD + jb * 16 + ln.ac);
      tc::ldmatrix_x4_trans(sl, sSlo + (ks * 16 + ln.ar) * LD + jb * 16 + ln.ac);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        tc::mma16816<bf16>(acc[j], qh, sh[2 * j], sh[2 * j + 1]);
        tc::mma16816<bf16>(acc[j], qh, sl[2 * j], sl[2 * j + 1]);
        tc::mma16816<bf16>(acc[j], ql, sh[2 * j], sh[2 * j + 1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = jb * 16 + j * 8 + 2 * ln.q;
      if (tr0 < lc)
        *reinterpret_cast<float2*>(y0 + col) = make_float2(acc[j][0], acc[j][1]);
      if (tr1 < lc)
        *reinterpret_cast<float2*>(y1 + col) = make_float2(acc[j][2], acc[j][3]);
    }
  }
}

unsigned long long g_state_smem_set = 0, g_scan_smem_set = 0;

cudaError_t launch_tc(const TcArgs& a, int B, cudaStream_t stream) {
  cudaError_t e =
      tc::allow_smem(wkv_fwd_state, state_smem(TMAX), g_state_smem_set);
  if (e != cudaSuccess) return e;
  e = tc::allow_smem(wkv_fwd_scan, scan_smem(TMAX), g_scan_smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.nc, a.H, B);
  wkv_fwd_state<<<grid, TNT, state_smem(a.hd), stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long HE = static_cast<long long>(a.H) * a.hd * a.hd;
  const dim3 pgrid(static_cast<unsigned>((HE + PNT - 1) / PNT), B);
  wkv_fwd_pass<<<pgrid, PNT, 0, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  wkv_fwd_scan<<<grid, TNT, scan_smem(a.hd), stream>>>(a);
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

// The tensor-core path: bf16 r, k and v; hd a multiple of 16 up to 128; r,
// k, v and logw rows on 16 bytes (the copies are 16-byte cp.async).
// states (B, ceil(S/64), H, hd, hd) and decay (B, ceil(S/64), H, hd) are
// f32 scratch.  strides as above.  Issues three kernels on the stream;
// returns the first launch error (0 on success).
extern "C" int repro_torch_wkv6_tc(const void* r, const void* k,
                                   const void* v, const float* logw,
                                   const float* u, const float* s0, float* y,
                                   float* s_last, float* states, float* decay,
                                   int B, int S, int H, int hd,
                                   const long long* strides, void* stream) {
  if (B < 1 || S < 1 || H < 1 || hd < 16 || hd % 16 || hd > TMAX)
    return cudaErrorInvalidValue;
  TcArgs args;
  args.r = static_cast<const bf16*>(r);
  args.k = static_cast<const bf16*>(k);
  args.v = static_cast<const bf16*>(v);
  args.w = logw;
  args.u = u;
  args.s0 = s0;
  args.y = y;
  args.s_last = s_last;
  args.states = states;
  args.decay = decay;
  args.S = S;
  args.H = H;
  args.hd = hd;
  args.nc = (S + TL - 1) / TL;
  for (int i = 0; i < 3; ++i) {
    args.rs[i] = strides[i];
    args.ks[i] = strides[3 + i];
    args.vs[i] = strides[6 + i];
    args.ws[i] = strides[9 + i];
  }
  return launch_tc(args, B, static_cast<cudaStream_t>(stream));
}
