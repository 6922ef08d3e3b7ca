// Grouped matmul for the MoE experts on Hopper (sm_90a), plain CUDA C++.
//
// Replaces the JAX package's Pallas TPU kernel kernels/moe_gmm.py:_gmm_kernel
// (launched by gmm).  For every expert e:
//   out[e] = x[e] @ w[e],   x (E,C,D), w (E,D,F) -> out (E,C,F)
// with the sum over D in f32 and the result written in x's type (f32, f16
// or bf16; x and w share it).  In the model, x is an expert's bucket of
// routed tokens (C = its capacity) and w one of the expert's three
// matrices: gate and up (D = d_model, F = d_ff), then out (D and F
// swapped).  The gradient's two products run through the same entry point
// with the operands read in place (Mode):
//   FWD  out (E,C,F) = x w          x K-major, w (D,F) n-contiguous
//   DX   dx  (E,C,D) = dy w^T       dy K-major, w (D,F) read as a K-major B
//   DW   dw  (E,D,F) = x^T dy       x read as an M-major A, dy n-contiguous
// so the backward copies no operand.
//
// Occupied rows.  `rows` (int32 per expert, or null for all C) counts the
// rows of each bucket that hold routed entries; they are its first rows
// (the dispatch fills a bucket in order).  Each value is clamped to
// [0, C].  Output rows c >= rows[e] are written as exact zeros, and rows
// of x (dy in DX) at or past rows[e] never reach a kept output: whole
// 64-row boxes past rows[e] are not loaded, and the rows of the last,
// partial box feed only output rows that are written as zeros.  In DW the
// sum runs over c < rows[e]: k tiles past rows[e] are not loaded and the
// rows of the last partial one are zeroed in shared memory, in x's tile
// and dy's.  An expert with rows[e] == 0 reads nothing of w[e] (nor of
// x[e] or dy[e]) and writes zeros.  So NaN anywhere past the occupied
// rows, or in an empty expert's weights, stays out of the result.
//
// Layout: each operand is read through its element strides (expert and
// row; the last axis has unit stride), so one group's (E,D,F) slice of the
// stacked (G,E,D,F) weights, or any strided view of them, goes in without
// a copy.  out is contiguous.  In f16/bf16 the base pointers and the
// strides must be 16-byte aligned (the wrapper checks): TMA and the GEMV's
// loads move 16-byte chunks.  Ragged C, D and F (the model's capacities,
// 200 in a 512-token prefill, 17 in kimi's, 800 in a train step, divide no
// tile; the Pallas kernel asserts that they do) cost no branch in the
// product loops: TMA zero-fills what lies past the edge.
//
// Bound on an H100 (bf16, 3.35 TB/s, 989 TFLOP/s): at granite-moe's
// prefill (E 32, C 200, D 1024, F 512) 53.2 MB for 6.71 GFLOP: 15.9 us,
// bytes; at its decode step (C 2) the 33.6 MB of weights, 10.1 us, bytes;
// its train bucket's gradient products (C 800) 112.2 MB and 26.8 GFLOP
// each: 33.5 us of bytes against 27.1 us of operations.  At occupancy the
// bound counts the occupied experts' weights only: kimi's decode step
// (E 384, C 1) fills at most 32 of 384 buckets, 0.94 GB of its 11.3 GB.
// What counts is that each live expert's w is read from HBM once and
// streams at the card's rate, that an empty one is not read at all, and
// in training that the tensor cores run near their rate.  The path
// follows from the dtype, the mode and C, never from a failure:
//
// * f16/bf16, FWD with C > GEMV_MAX_C, and DX and DW: gmm_wgmma, Hopper's
//   own product.  A persistent grid (two blocks an SM) walks the
//   (expert, n tile, m tile) items, the m tiles of one (expert, n tile)
//   neighbours so that they share w through L2.  In each block one
//   producer warp keeps TMA loads of 64 x 64 boxes (rank-3 tensor maps
//   over (expert, rows, columns) through the views' own strides, so a box
//   never crosses into the next expert) in a ring of shared-memory stages
//   with full and empty mbarriers; two consumer warpgroups each own
//   64 rows of a 128 x 128 tile and run wgmma m64n128k16 with f32
//   accumulators in registers (A K-major, or M-major in DW; B MN-major,
//   or K-major in DX), one k tile's products in flight while the next is
//   issued.  The producer runs ahead into the next item while the
//   consumers store this one, straight from registers in 16-byte stores
//   (a quad's four lanes swap their column pairs).  Items past rows[e]
//   load nothing and store zeros.  What bounds it: a 128 x 128 tile reads
//   its A rows once per n tile and its B columns once per m tile, so the
//   operands cross L2 several times (131 MB for granite's 53 MB prefill
//   bucket, 445 MB for a 112 MB gradient product at C 800), at about 6.3
//   TB/s in the measured times (PERF.md).  Larger tiles at one block an
//   SM, and pairs of blocks in a cluster sharing B by TMA multicast, both
//   measured slower on an H100; the tiles and stage count are the fastest
//   found, left as constants.
// * f16/bf16, FWD with C <= GEMV_MAX_C: gmm_fwd_gemv, a batched GEMV on
//   the CUDA cores (2 C multiply-adds per 2-byte weight are far below the
//   card's f32 rate).  One block of 512 threads owns 64 (or 128) columns of
//   one expert: 8 (16) threads read a row's 128 (256) bytes with 16-byte
//   loads, 64 (32) such row lanes split D, and each keeps 4 to 8 loads in
//   flight (the next batch is issued before this one is used); x's
//   occupied rows are copied into shared memory by cp.async while the
//   first batch flies; the row lanes' partial sums meet through shuffles
//   and shared memory.  The wider blocks are taken where the narrow ones
//   would need more than one wave of two blocks an SM: granite's gate/up
//   runs 256 blocks of 64 columns, its out product 256 of 128.  A block of
//   an empty expert stores its zero columns and reads no weights.
// * f32, every mode: gmm_fwd, the CUDA-core kernel of the first port: one
//   block of 256 threads per 64 x 64 output tile, K in tiles of 32 staged
//   through shared memory, a 4x4 f32 micro-tile a thread; the operands are
//   read through both of their strides, so DX and DW read w and x
//   transposed in place (uncoalesced: f32 is the parity path, never the
//   served type).  TF32 would not hold the f32 contract (1e-5 of the
//   output's scale).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "mma_sm80.cuh"

namespace {

// out[e] (M x N) = A[e] (M x K) B[e] (K x N) in three storage layouts.
enum Mode { FWD = 0, DX = 1, DW = 2 };

struct Args {
  const void* a;
  const void* b;
  void* out;
  const int* rows;              // occupied rows an expert, or null: all
  int M, N, K;
  long long as_e, as_m, as_k;   // A's element strides (expert, m, k)
  long long bs_e, bs_k, bs_n;   // B's (expert, k, n)
  int rows_on_k;                // DW: rows bound the contraction, else M
};

// Expert e's occupied rows, clamped to [0, limit].
__device__ __forceinline__ int live_rows(const Args& a, int e, int limit) {
  if (a.rows == nullptr) return limit;
  return min(max(__ldg(a.rows + e), 0), limit);
}

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

// ---------------------------------------------------------------- f16/bf16,
// Hopper: TMA, wgmma, a persistent warp-specialized pipeline

namespace wg {
constexpr int BOX = 64;                   // a TMA box: 64 x 64 elements, one
constexpr int BOX_BYTES = BOX * BOX * 2;  // 128-byte swizzle span wide
constexpr int BM = 128;                   // two consumer warpgroups of 64
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int A_BOXES = BM / BOX;         // one per consumer warpgroup
constexpr int B_BOXES = BN / BOX;
constexpr int STAGE_BYTES = (A_BOXES + B_BOXES) * BOX_BYTES;
constexpr int STAGES = 3;
constexpr int THREADS = 288;              // warps 0-7 consume, warp 8 loads
constexpr int CONSUMER_WARPS = 8;
constexpr int MIN_BLOCKS = 2;
// the stages from the first 1024-byte boundary, then the barriers
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
static_assert(BK == BOX && BM == 2 * BOX && BN == 128,
              "k tiles one box deep, an m64 box a warpgroup, wgmma n128");
static_assert(MIN_BLOCKS * (SMEM + 1024) <= 233472, "the blocks fit an SM");
}  // namespace wg

// One (expert, m tile, n tile) item as both roles see it: the k tiles it
// loads (0: none, its output is zeros) and which boxes of a stage are
// loaded (bit i of a_on: A's m64 sub-tile i, which is also multiplied).
struct Plan {
  int e, m0, n0, k_tiles, live;
  unsigned a_on, b_on;
};

template <int MODE>
__device__ __forceinline__ Plan plan(const Args& a, int item, int m_tiles,
                                     int n_tiles) {
  using namespace wg;
  Plan p;
  p.e = item / (m_tiles * n_tiles);
  p.n0 = item / m_tiles % n_tiles * BN;
  p.m0 = item % m_tiles * BM;              // m tiles are neighbours
  int m_end;
  if (MODE == DW) {
    p.live = live_rows(a, p.e, a.K);
    p.k_tiles = (p.live + BK - 1) / BK;
    m_end = a.M;
  } else {
    p.live = live_rows(a, p.e, a.M);
    p.k_tiles = p.m0 < p.live ? (a.K + BK - 1) / BK : 0;
    m_end = p.live;
  }
  p.a_on = p.b_on = 0u;
  if (p.k_tiles > 0) {
#pragma unroll
    for (int i = 0; i < A_BOXES; ++i)
      if (p.m0 + BOX * i < m_end) p.a_on |= 1u << i;
#pragma unroll
    for (int j = 0; j < B_BOXES; ++j)
      if (p.n0 + BOX * j < a.N) p.b_on |= 1u << j;
  }
  return p;
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// Lane q of a quad holds v[j] = its columns 2q, 2q + 1 of n8 block j
// (j = 0..3); afterwards o = the 8 columns of block q, in order.
__device__ __forceinline__ void quad_transpose(const uint32_t (&v)[4],
                                               uint32_t (&o)[4], int lane) {
  const int q = lane & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int src = (q + r) & 3;
    // lane s sends its columns of block (s - r) & 3: from src, block q
    const uint32_t got = __shfl_sync(0xffffffffu, pick4(v, (q - r) & 3),
                                     (lane & ~3) | src);
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = src == k ? got : o[k];
  }
}

// A warpgroup's rows of the tile to out: 16-byte stores where rows of N
// are whole 16-byte chunks, else two-byte ones.  In FWD and DX the rows at
// or past p.live are written as zeros.
template <typename T, int MODE>
__device__ __forceinline__ void store_tile(const float (&acc)[wg::BN / 2],
                                           const Args& a, const Plan& p,
                                           int wgi, int warp, int lane) {
  using namespace wg;
  T* out = static_cast<T*>(a.out) + (long long)p.e * a.M * a.N;
  const int g = lane >> 2, q = lane & 3;
  const bool vec = a.N % 8 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = p.m0 + 64 * wgi + 16 * (warp & 3) + g + 8 * h;
    const bool keep = MODE == DW || m < p.live;
    T* row = out + (long long)m * a.N;
#pragma unroll
    for (int j4 = 0; j4 < BN / 32; ++j4) {
      uint32_t v[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int nb = 4 * j4 + jj;
        v[jj] = keep ? tc::pack2<T>(acc[4 * nb + 2 * h],
                                    acc[4 * nb + 2 * h + 1])
                     : 0u;
      }
      if (vec) {                    // every lane shuffles, then stores
        uint32_t o[4] = {0u, 0u, 0u, 0u};
        quad_transpose(v, o, lane);
        const int n = p.n0 + 32 * j4 + 8 * q;
        if (m < a.M && n < a.N)
          *reinterpret_cast<uint4*>(row + n) = make_uint4(o[0], o[1], o[2],
                                                          o[3]);
      } else if (m < a.M) {
        unsigned short* r16 = reinterpret_cast<unsigned short*>(row);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int n = p.n0 + 8 * (4 * j4 + jj) + 2 * q;
          if (n < a.N) r16[n] = static_cast<unsigned short>(v[jj]);
          if (n + 1 < a.N)
            r16[n + 1] = static_cast<unsigned short>(v[jj] >> 16);
        }
      }
    }
  }
}

// DW's last partial k tile: rows kr.. of this warpgroup's A box and of
// every loaded B box lie inside the tensors (TMA loaded them) but past the
// occupied rows; they become zeros before the products read them.  (Both
// warpgroups zero the shared B boxes: the same zeros, written twice.)
__device__ __forceinline__ void zero_tail(unsigned char* stage, const Plan& p,
                                          int wgi, int kr) {
  using namespace wg;
  const int tid = threadIdx.x & 127;
  const int chunks = (BK - kr) * (BOX * 2 / 16);   // 16-byte chunks a box
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int i = 0; i < 1 + B_BOXES; ++i) {
    const int box = i == 0 ? wgi : A_BOXES + i - 1;
    if (i > 0 && !(p.b_on >> (i - 1) & 1)) continue;
    uint4* rows = reinterpret_cast<uint4*>(stage + box * BOX_BYTES +
                                           kr * BOX * 2);
    for (int c = tid; c < chunks; c += 128) rows[c] = z;
  }
  hopper::fence_proxy_async();
  hopper::named_barrier_sync(1 + wgi, 128);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(wg::THREADS, wg::MIN_BLOCKS)
    gmm_wgmma(const __grid_constant__ CUtensorMap ta,
              const __grid_constant__ CUtensorMap tb, const Args a,
              int m_tiles, int n_tiles, int items) {
  using namespace wg;
  constexpr int A_MN = MODE == DW, B_MN = MODE != DX;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // boxes start on 1024 bytes (the 128-byte swizzle's period)
  const uint32_t pad = (1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023;
  unsigned char* tiles = smem_raw + pad;   // [STAGES][A boxes, B boxes]
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // the warp, broadcast from lane 0 so the compiler sees it uniform
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x & 31;

  if (warp == CONSUMER_WARPS) {
    // Producer: one thread keeps the ring full, item after item.
    if (lane == 0) {
      hopper::prefetch_map(&ta);
      hopper::prefetch_map(&tb);
      uint32_t it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const Plan p = plan<MODE>(a, item, m_tiles, n_tiles);
        const uint32_t bytes = (__popc(p.a_on) + __popc(p.b_on)) * BOX_BYTES;
        for (int kt = 0; kt < p.k_tiles; ++kt, ++it) {
          const int s = it % STAGES;
          hopper::mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(full + s, bytes);
          unsigned char* st = tiles + s * STAGE_BYTES;
          const int k0 = kt * BK;
          for (int i = 0; i < A_BOXES; ++i) {
            if (!(p.a_on >> i & 1)) continue;
            if (A_MN)
              hopper::tma_load(st + i * BOX_BYTES, &ta, full + s,
                               p.m0 + BOX * i, k0, p.e);
            else
              hopper::tma_load(st + i * BOX_BYTES, &ta, full + s, k0,
                               p.m0 + BOX * i, p.e);
          }
          for (int j = 0; j < B_BOXES; ++j) {
            if (!(p.b_on >> j & 1)) continue;
            unsigned char* dst = st + (A_BOXES + j) * BOX_BYTES;
            if (B_MN)
              hopper::tma_load(dst, &tb, full + s, p.n0 + BOX * j, k0, p.e);
            else
              hopper::tma_load(dst, &tb, full + s, k0, p.n0 + BOX * j, p.e);
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wgi owns the tile's rows m0 + 64 wgi ...
  const int wgi = warp / 4;
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + s);
  };
  uint32_t it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Plan p = plan<MODE>(a, item, m_tiles, n_tiles);
    const bool mine = p.a_on >> wgi & 1;   // rows of its own to multiply
    float acc[BN / 2];
#pragma unroll
    for (int n = 0; n < BN / 2; ++n) acc[n] = 0.f;
    int prev = -1;
    for (int kt = 0; kt < p.k_tiles; ++kt, ++it) {
      const int s = it % STAGES;
      hopper::mbar_wait(full + s, (it / STAGES) & 1);
      if (!mine) {            // its rows lie past the occupied ones (or M)
        release(s);
        continue;
      }
      unsigned char* st = tiles + s * STAGE_BYTES;
      if (MODE == DW && (kt + 1) * BK > p.live)
        zero_tail(st, p, wgi, p.live - kt * BK);
      __syncwarp();
      hopper::wgmma_fence();
      const uint64_t da = hopper::smem_desc(st + wgi * BOX_BYTES,
                                            A_MN ? BOX_BYTES : 0, 1024, 128);
      const uint64_t db = hopper::smem_desc(st + A_BOXES * BOX_BYTES,
                                            B_MN ? BOX_BYTES : 0, 1024, 128);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        // a k16 step: 16 rows (2048 bytes) of an MN-major box, 32 bytes of
        // a K-major one
        hopper::wgmma_ss<T, BN, B_MN, A_MN>(acc, da + (A_MN ? 128 : 2) * kk,
                                            db + (B_MN ? 128 : 2) * kk, 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();      // the previous k tile's products are done
      if (prev >= 0) release(prev);
      prev = s;
    }
    hopper::wgmma_wait<0>();        // on every path, so ptxas sees acc done
    if (prev >= 0) release(prev);
    hopper::fence_regs(acc);
    store_tile<T, MODE>(acc, a, p, wgi, warp, lane);
  }
}

// A rank-3 map over an operand stored (E, rows, cols) with element strides
// (e_stride, row_stride) and unit stride on cols: dims (cols, rows, E),
// 64 x 64 boxes.  A dim of size 1 is never stepped, so it takes any valid
// stride; a stride TMA cannot take (not a positive multiple of 16 bytes
// below 2^40) is refused.
inline cudaError_t encode_operand(CUtensorMap* map, bool bf16, const void* ptr,
                                  int E, int rows, int cols,
                                  long long e_stride, long long row_stride) {
  const uint64_t dims[3] = {static_cast<uint64_t>(cols),
                            static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(E)};
  const long long steps[2] = {row_stride, e_stride};
  const uint64_t filler = (2ull * cols + 15) / 16 * 16 * rows;
  uint64_t strides[2];
  for (int i = 0; i < 2; ++i) {
    const long long bytes = steps[i] * 2;
    if (dims[i + 1] == 1)
      strides[i] = i == 0 ? (2ull * cols + 15) / 16 * 16 : filler;
    else if (bytes <= 0 || bytes % 16 || bytes >= (1ll << 40))
      return cudaErrorInvalidValue;
    else
      strides[i] = static_cast<uint64_t>(bytes);
  }
  const uint32_t box[3] = {wg::BOX, wg::BOX, 1};
  return hopper::encode_map16(map, bf16, 3, ptr, dims, strides, box);
}

template <typename T, int MODE>
cudaError_t launch_wgmma(const Args& a, int E, cudaStream_t stream) {
  using namespace wg;
  auto kernel = gmm_wgmma<T, MODE>;
  static unsigned long long smem_set = 0;
  cudaError_t err = tc::allow_smem(kernel, SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap maps[2];
  // A stored (E, M, K), or (E, K, M) in DW; B (E, K, N), or (E, N, K) in DX
  err = MODE == DW
            ? encode_operand(&maps[0], bf16, a.a, E, a.K, a.M, a.as_e, a.as_k)
            : encode_operand(&maps[0], bf16, a.a, E, a.M, a.K, a.as_e, a.as_m);
  if (err == cudaSuccess)
    err = MODE == DX
              ? encode_operand(&maps[1], bf16, a.b, E, a.N, a.K, a.bs_e, a.bs_n)
              : encode_operand(&maps[1], bf16, a.b, E, a.K, a.N, a.bs_e,
                               a.bs_k);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = tc::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int m_tiles = (a.M + BM - 1) / BM, n_tiles = (a.N + BN - 1) / BN;
  const long long items = (long long)E * m_tiles * n_tiles;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long grid = items < (long long)MIN_BLOCKS * sms
                             ? items : (long long)MIN_BLOCKS * sms;
  kernel<<<static_cast<unsigned>(grid), THREADS, SMEM, stream>>>(
      maps[0], maps[1], a, m_tiles, n_tiles, static_cast<int>(items));
  return cudaGetLastError();
}

// ---------------------------------------------------------------- f16/bf16,
// FWD with small C: batched GEMV

constexpr int GEMV_MAX_C = 8;
constexpr int GV_NT = 512;
constexpr int GV_U = 4;                  // 16-byte loads a thread a batch
constexpr int GV_SMEM_MAX = 48 * 1024;   // no opt-in needed below this

// x's rows padded to 8 elements (2 bytes each), then the partial sums of
// the warps, 8 G columns each
__host__ __device__ constexpr int gemv_smem(int cr, int G, int D) {
  return cr * ((D + 7) / 8 * 8) * 2 + (GV_NT / 32) * cr * 8 * G * 4;
}

template <typename T>
__device__ __forceinline__ uint4 load8(const T* p, int valid) {
  if (valid >= 8) return __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  uint32_t v[4] = {0u, 0u, 0u, 0u};  // the ragged last column group
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < valid) v[j / 2] |= static_cast<uint32_t>(h[j]) << (16 * (j % 2));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// One batch: rows d0 + lanes u of the thread's 8 columns, zero past D.
template <typename T>
__device__ __forceinline__ void load_batch(uint4 (&v)[GV_U], const T* w,
                                           const Args& a, int d0, int lanes,
                                           int n, int valid) {
#pragma unroll
  for (int u = 0; u < GV_U; ++u) {
    const int d = d0 + u * lanes;
    v[u] = d < a.K ? load8(w + d * a.bs_k + n, valid) : make_uint4(0, 0, 0, 0);
  }
}

// One block owns 8 G columns of one expert: G threads side by side read
// one row's 16 G bytes, GV_NT / G such row lanes split D (K here; C is M
// and F is N).
template <typename T, int CR, int G>
__global__ void __launch_bounds__(GV_NT) gmm_fwd_gemv(Args a) {
  constexpr int LANES = GV_NT / G, COLS = 8 * G;
  static_assert(G == 8 || G == 16, "a warp holds 32 / G row lanes");
  extern __shared__ __align__(16) unsigned char gsm_raw[];
  const int DP = (a.K + 7) / 8 * 8;
  T* xs = reinterpret_cast<T*>(gsm_raw);                 // [CR][DP]
  float* red = reinterpret_cast<float*>(xs + CR * DP);   // [warp][CR][COLS]
  const int e = blockIdx.y, n0 = blockIdx.x * COLS;
  const int tid = threadIdx.x, cg = tid % G, rl = tid / G;
  const int live = live_rows(a, e, a.M);
  T* out = static_cast<T*>(a.out) + (long long)e * a.M * a.N;
  if (live == 0) {             // an empty expert: zero columns, no weights
    for (int i = tid; i < a.M * COLS; i += GV_NT) {
      const int c = i / COLS, col = n0 + i % COLS;
      if (col < a.N) out[(long long)c * a.N + col] = from_f<T>(0.f);
    }
    return;
  }
  const T* x = static_cast<const T*>(a.a) + (long long)e * a.as_e;
  const T* w = static_cast<const T*>(a.b) + (long long)e * a.bs_e;

  // x's occupied rows (zero past them and past D) copy into shared memory
  // while the first batch of weights is in flight; the rows past them
  // are never read, and their sums (of zeros) are stored as zeros (a
  // branch around their products cost more than it saved)
  for (int i = tid; i < CR * (DP / 8); i += GV_NT) {
    const int c = i / (DP / 8), k = i % (DP / 8) * 8;
    const bool in = c < live;
    tc::cp_async16(xs + c * DP + k, in ? x + c * a.as_m + k : x,
                   in ? min(8, a.K - k) * 2 : 0);
  }
  tc::cp_async_commit();

  float acc[CR][8];
#pragma unroll
  for (int c = 0; c < CR; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[c][j] = 0.f;
  const int n = n0 + cg * 8, valid = a.N - n;
  constexpr int STEP = LANES * GV_U;
  uint4 cur[GV_U], nxt[GV_U];
  if (valid > 0) load_batch(cur, w, a, rl, LANES, n, valid);
  tc::cp_async_wait<0>();
  __syncthreads();
  if (valid > 0) {
    for (int d0 = rl; d0 < a.K; d0 += STEP) {
      if (d0 + STEP < a.K) load_batch(nxt, w, a, d0 + STEP, LANES, n, valid);
#pragma unroll
      for (int u = 0; u < GV_U; ++u) {
        const int d = d0 + u * LANES;
        if (d < a.K) {
          float f[8];
          tc::unpack8<T>(cur[u], f);
#pragma unroll
          for (int c = 0; c < CR; ++c) {
            const float xv = to_f(xs[c * DP + d]);
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[c][j] = fmaf(xv, f[j], acc[c][j]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < GV_U; ++u) cur[u] = nxt[u];
    }
  }
  // lanes l, l ^ G, ... of a warp hold one column group's row lanes
#pragma unroll
  for (int c = 0; c < CR; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int off = G; off < 32; off *= 2)
        acc[c][j] += __shfl_xor_sync(0xffffffffu, acc[c][j], off);
  const int lane = tid & 31, warp = tid >> 5;
  if (lane < G)
#pragma unroll
    for (int c = 0; c < CR; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        red[(warp * CR + c) * COLS + lane * 8 + j] = acc[c][j];
  __syncthreads();
  for (int i = tid; i < CR * COLS; i += GV_NT) {
    const int c = i / COLS, col = n0 + i % COLS;
    if (c >= a.M || col >= a.N) continue;
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < GV_NT / 32; ++wp)
      s += red[(wp * CR + c) * COLS + i % COLS];
    out[(long long)c * a.N + col] = from_f<T>(c < live ? s : 0.f);
  }
}

// ---------------------------------------------------------------- f32,
// CUDA cores (the first port's kernel), every mode

constexpr int BM = 64;     // rows of M per block
constexpr int BN = 64;     // columns of N per block
constexpr int BK = 32;     // depth of one K tile
constexpr int NT = 256;    // threads per block: a 16 x 16 grid
constexpr int PER = BM * BK / NT;  // A (and B) tile elements each thread loads

static_assert(BM * BK == BK * BN && PER == 8, "tiles are 8 loads a thread");
static_assert(BM == 64 && BN == 64 && NT == 256, "4x4 outputs a thread");

// Loads the K tile at k0: A rows [m0, m0 + rows) and B columns [n0, n0+BN),
// zero outside them and from k_end on.  Element i of a thread is tile
// index tid + i * NT: A (row idx / BK, depth idx % BK), B (depth idx / BN,
// column idx % BN), so a warp reads 32 consecutive elements of a row of
// FWD's operands (DX's w and DW's x are read across their rows).
__device__ __forceinline__ void load_tile(const float* A, const float* B,
                                          const Args& a, int m0, int rows,
                                          int n0, int k0, int k_end, int tid,
                                          float (&ra)[PER], float (&rb)[PER]) {
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = tid + i * NT;
    const int m = idx / BK, k = k0 + idx % BK;
    ra[i] = (m < rows && k < k_end)
                ? A[(long long)(m0 + m) * a.as_m + (long long)k * a.as_k]
                : 0.f;
    const int kk = k0 + idx / BN, n = n0 + idx % BN;
    rb[i] = (kk < k_end && n < a.N)
                ? B[(long long)kk * a.bs_k + (long long)n * a.bs_n]
                : 0.f;
  }
}

__global__ void __launch_bounds__(NT, 2) gmm_fwd(Args a) {
  __shared__ float As[BM][BK + 1];   // padded: a warp reads two rows at once
  __shared__ float Bs[BK][BN];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // rows of this tile that hold entries (the rest are written as zeros),
  // and the depth the sum runs to
  const int live = a.rows_on_k ? a.M : live_rows(a, e, a.M);
  const int k_end = a.rows_on_k ? live_rows(a, e, a.K) : a.K;
  const int rows = min(BM, live - m0);
  const int tile_rows = min(BM, a.M - m0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* A = static_cast<const float*>(a.a) + (long long)e * a.as_e;
  const float* B = static_cast<const float*>(a.b) + (long long)e * a.bs_e;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (rows > 0 && k_end > 0) {       // uniform across the block
    float ra[PER], rb[PER];
    load_tile(A, B, a, m0, rows, n0, 0, k_end, tid, ra, rb);
    for (int k0 = 0; k0 < k_end; k0 += BK) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int idx = tid + i * NT;
        As[idx / BK][idx % BK] = ra[i];
        Bs[idx / BN][idx % BN] = rb[i];
      }
      __syncthreads();
      if (k0 + BK < k_end)  // the next tile's loads fly during these products
        load_tile(A, B, a, m0, rows, n0, k0 + BK, k_end, tid, ra, rb);
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
  }

  float* out = static_cast<float*>(a.out) + ((long long)e * a.M + m0) * a.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty + 16 * i;
    if (m >= tile_rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < a.N) out[(long long)m * a.N + n] = m < rows ? acc[i][j] : 0.f;
    }
  }
}

// ---------------------------------------------------------------- launch

cudaError_t launch_f32(const Args& a, int E, cudaStream_t stream) {
  if (a.M > 65535 * BM) return cudaErrorInvalidValue;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, E);
  gmm_fwd<<<grid, NT, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int CR, int G>
cudaError_t launch_gemv(const Args& a, int E, cudaStream_t stream) {
  const dim3 grid((a.N + 8 * G - 1) / (8 * G), E);
  gmm_fwd_gemv<T, CR, G><<<grid, GV_NT, gemv_smem(CR, G, a.K), stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int CR>
cudaError_t launch_gemv_cr(const Args& a, int E, bool wide,
                           cudaStream_t stream) {
  return wide ? launch_gemv<T, CR, 16>(a, E, stream)
              : launch_gemv<T, CR, 8>(a, E, stream);
}

template <typename T>
cudaError_t launch_tc(const Args& a, int E, int mode, cudaStream_t stream) {
  if (mode == DX) return launch_wgmma<T, DX>(a, E, stream);
  if (mode == DW) return launch_wgmma<T, DW>(a, E, stream);
  const int cr = a.M <= 1 ? 1 : a.M <= 2 ? 2 : a.M <= 4 ? 4 : 8;
  if (a.M <= GEMV_MAX_C) {
    // 128 columns a block where 64 would need more than one wave of two
    // blocks an SM (granite's out product: 512 blocks of 64 columns)
    int sms = 0;
    const cudaError_t err = tc::sm_count(&sms);
    if (err != cudaSuccess) return err;
    const bool wide = (long long)E * ((a.N + 63) / 64) > 2LL * sms &&
                      gemv_smem(cr, 16, a.K) <= GV_SMEM_MAX;
    if (wide || gemv_smem(cr, 8, a.K) <= GV_SMEM_MAX) {
      switch (cr) {
        case 1: return launch_gemv_cr<T, 1>(a, E, wide, stream);
        case 2: return launch_gemv_cr<T, 2>(a, E, wide, stream);
        case 4: return launch_gemv_cr<T, 4>(a, E, wide, stream);
        default: return launch_gemv_cr<T, 8>(a, E, wide, stream);
      }
    }
  }
  return launch_wgmma<T, FWD>(a, E, stream);
}

}  // namespace

// out[e] (M x N) = A[e] (M x K) B[e] (K x N) for e < E, summed in f32.
// mode: 0 = FWD (a = x (E,M,K), b = w (E,K,N)), 1 = DX (a = dy (E,M,K),
// b = w (E,N,K): out = dy w^T), 2 = DW (a = x (E,K,M), b = dy (E,K,N):
// out = x^T dy).  strides: 4 element strides, a (expert, row) and b
// (expert, row) of the stored layouts; the last axis of each has unit
// stride.  rows: E int32 occupied rows (of M, or of K in DW), clamped to
// [0, M] ([0, K]), or null for all.  dtype: 0 = float32, 1 = float16,
// 2 = bfloat16 (a, b and out alike).  out (E,M,N) is contiguous.  Returns
// cudaGetLastError() after the launch (0 on success); launches nothing
// when E, M or N is 0.
extern "C" int repro_torch_gmm(const void* a, const void* b, void* out,
                               const int* rows, int dtype, int mode, int E,
                               int M, int N, int K, const long long* strides,
                               void* stream) {
  if (E < 0 || M < 0 || N < 0 || K < 0 || E > 65535 || mode < FWD ||
      mode > DW)
    return cudaErrorInvalidValue;
  if (E == 0 || M == 0 || N == 0) return cudaSuccess;
  Args args;
  args.a = a;
  args.b = b;
  args.out = out;
  args.rows = rows;
  args.M = M;
  args.N = N;
  args.K = K;
  args.as_e = strides[0];
  args.as_m = mode == DW ? 1 : strides[1];
  args.as_k = mode == DW ? strides[1] : 1;
  args.bs_e = strides[2];
  args.bs_k = mode == DX ? 1 : strides[3];
  args.bs_n = mode == DX ? strides[3] : 1;
  args.rows_on_k = mode == DW;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_f32(args, E, s);
    case 1: return launch_tc<__half>(args, E, mode, s);
    case 2: return launch_tc<__nv_bfloat16>(args, E, mode, s);
    default: return cudaErrorInvalidValue;
  }
}
