// Grouped expert GEMM (K5) for Hopper (sm_90a): the products of a
// mixture-of-experts layer over pairs sorted by expert.
//
// Replaces no TPU kernel: the JAX package has no mixture of experts.  It
// was added for the LFM2-8B-A1B encoder (models/lfm2.py, ops/moe.py),
// whose 22 MoE layers do 68% of its matrix work.  The (token, expert)
// pairs arrive sorted by expert: rows offsets[e] .. offsets[e + 1] of x
// [P, K] go to expert e, and offsets [E + 1] (int32) lie in device memory,
// so no host ever learns the counts and the layer needs no sync.  For
// each expert's rows, with its weight w[e] [N, K] (nn.Linear's layout, K
// contiguous):
//
//   swiglu = 0:  out[r, n] = bf16( Σ_k x[r, k] · w[e][n, k] )         N = out cols
//   swiglu = 1:  g = Σ_k x[r, k] · w[e][j, k],  u = Σ_k x[r, k] · w[e][F + j, k],
//                out[r, j] = bf16( g / (1 + exp(−g)) · u )              N = 2F
//
// with the sums in f32 and one rounding to bf16 at the end (w13 = [w1; w3]
// stacked along N, so the SwiGLU pairs column j with column F + j).
//
// What bounds it: 2·P·N·K operations against the weights once and x and
// out once, so at the rows a deployment gives each expert (tens of
// thousands) it is bound by the tensor cores, 989 TFLOP/s; the weights of
// one layer (470 MB for w13) do not fit in L2, so how often a weight tile
// comes back from device memory decides whether it stays so.  The design:
//
// * Tiles of 128 rows × 256 columns (for the SwiGLU, 128 gate columns and
//   the 128 up columns that pair with them), walked by a persistent grid
//   (a block per SM) in the order (expert, row tile, column tile), column
//   tile fastest: the blocks running at one time cover about 132 / 14
//   row tiles of one expert and every column tile of it, so each row tile
//   of x and the whole expert's weights are read from L2 (a layer's w13
//   passes through device memory about once per 9 row tiles).
// * Each block finds its tiles itself: its first warp turns the offsets
//   into a prefix of row tiles per expert in shared memory (a warp scan),
//   and a tile's expert is a binary search in it.  Rows of a tile past its
//   expert's end are computed (they belong to the next expert, or read as
//   zeros past P) and never written.
// * A producer warp streams 64-deep slices of x and of the two 128-row
//   weight halves by TMA (128-byte swizzle) through a ring of 4 stages
//   with full and empty mbarriers; two consumer warpgroups of 64 rows each
//   run wgmma.m64n128k16 from shared memory into two f32 accumulators of
//   64 registers each, one group in flight while the next stage lands.
// * The epilogue (the SwiGLU in f32, or the plain rounding) is done in
//   registers and stored as bf16 pairs, masked at the expert's last row.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace memvul;

constexpr int kBM = 128;                 // rows per tile: two consumers × 64
constexpr int kHalf = 128;               // columns per accumulator
constexpr int kBK = 64;                  // reduction per stage: one swizzled 128-byte row
constexpr int kStages = 4;
constexpr int kMaxExperts = 256;
constexpr int kThreads = 384;            // producer warpgroup + two consumers
constexpr uint32_t kABytes = kBM * kBK * 2;
constexpr uint32_t kBHalfBytes = kHalf * kBK * 2;
constexpr uint32_t kStageBytes = kABytes + 2 * kBHalfBytes;
constexpr int kSmemBars = kStages * kStageBytes;
constexpr int kSmemPrefix = kSmemBars + 2 * kStages * 8;
constexpr int kSmemBytes = kSmemPrefix + (kMaxExperts + 1) * 4 + 1024;  // + alignment slack
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= 65536, "register file");

// the expert whose row tiles hold global row tile mt: the last e with
// prefix[e] <= mt (experts without rows share their successor's prefix)
__device__ __forceinline__ int expert_of(const int* prefix, int E, int mt) {
  int lo = 0, hi = E;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (prefix[mid] <= mt) lo = mid; else hi = mid;
  }
  return lo;
}

template <bool SWIGLU>
__global__ void __launch_bounds__(kThreads, 1)
grouped_gemm_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap w_map,
                    const int* __restrict__ offsets, __nv_bfloat16* __restrict__ out,
                    int E, int K, int n_rows_w, int n_tiles, int out_stride, int up_rows) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kSmemBars);
  uint64_t* empty = full + kStages;
  int* prefix = reinterpret_cast<int*>(smem + kSmemPrefix);  // [E + 1] row tiles before e

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    tma_prefetch_map(&x_map);
    tma_prefetch_map(&w_map);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  if (threadIdx.x < 32) {
    // row tiles per expert, scanned across the warp: lane l holds experts
    // 8l .. 8l + 7
    constexpr int kPer = kMaxExperts / 32;
    int tiles[kPer];
    int sum = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = lane * kPer + j;
      tiles[j] = e < E ? (__ldg(offsets + e + 1) - __ldg(offsets + e) + kBM - 1) / kBM : 0;
      sum += tiles[j];
    }
    int inclusive = sum;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int up = __shfl_up_sync(0xffffffffu, inclusive, d);
      if (lane >= d) inclusive += up;
    }
    int run = inclusive - sum;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = lane * kPer + j;
      if (e < E) prefix[e] = run;
      run += tiles[j];
    }
    if (lane == 31) prefix[E] = inclusive;
  }
  __syncthreads();

  const int n_k = K / kBK;
  const int total = prefix[E] * n_tiles;

  // the tile's first row, the end of its expert's rows, and the first
  // weight rows of its two halves
  auto locate = [&](int t, int& row0, int& row_end, int& w0, int& w1, int& col0) {
    const int mt = t / n_tiles, nt = t % n_tiles;
    const int e = expert_of(prefix, E, mt);
    row0 = __ldg(offsets + e) + (mt - prefix[e]) * kBM;
    row_end = __ldg(offsets + e + 1);
    if (SWIGLU) {
      w0 = e * n_rows_w + nt * kHalf;
      w1 = w0 + up_rows;
      col0 = nt * kHalf;
    } else {
      w0 = e * n_rows_w + nt * 2 * kHalf;
      w1 = w0 + kHalf;
      col0 = nt * 2 * kHalf;
    }
  };

  if (wg == 0) {
    // -- producer --------------------------------------------------------------
    setmaxnreg_dec<kProducerRegs>();
    if (warp != 0 || lane != 0) return;
    int g = 0;  // stages filled by this block
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      int row0, row_end, w0, w1, col0;
      locate(t, row0, row_end, w0, w1, col0);
      for (int kt = 0; kt < n_k; ++kt, ++g) {
        const int s = g % kStages;
        mbar_wait(&empty[s], ((g / kStages) & 1) ^ 1);  // a stage's first use passes at once
        uint8_t* stage = smem + s * kStageBytes;
        mbar_arrive_expect_tx(&full[s], kStageBytes);
        tma_load_2d(stage, &x_map, &full[s], kt * kBK, row0);
        tma_load_2d(stage + kABytes, &w_map, &full[s], kt * kBK, w0);
        tma_load_2d(stage + kABytes + kBHalfBytes, &w_map, &full[s], kt * kBK, w1);
      }
    }
    return;
  }

  // -- consumers ---------------------------------------------------------------
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;                // which 64 rows of a tile
  const int quad_row = lane / 4;
  const int quad_col = (lane % 4) * 2;
  const WgmmaFlags flags;
  float acc0[64], acc1[64];
  int g = 0;  // stages consumed by this block

  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    int row0, row_end, w0, w1, col0;
    locate(t, row0, row_end, w0, w1, col0);
    for (int kt = 0; kt < n_k; ++kt, ++g) {
      const int s = g % kStages;
      mbar_wait(&full[s], (g / kStages) & 1);
      const uint8_t* stage = smem + s * kStageBytes;
      const uint64_t a = wgmma_desc_sw128(stage + cw * 64 * kBK * 2, 16, 1024);
      const uint64_t b0 = wgmma_desc_sw128(stage + kABytes, 16, 1024);
      const uint64_t b1 = wgmma_desc_sw128(stage + kABytes + kBHalfBytes, 16, 1024);
      const int first = kt == 0 ? flags.off : flags.on;
      fence_regs(acc0);
      fence_regs(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wgmma_m64n128k16_ss(acc0, wgmma_desc_advance(a, kk * 32), wgmma_desc_advance(b0, kk * 32),
                            kk ? flags.on : first);
        wgmma_m64n128k16_ss(acc1, wgmma_desc_advance(a, kk * 32), wgmma_desc_advance(b1, kk * 32),
                            kk ? flags.on : first);
      }
      wgmma_commit();
      // the previous stage's products have landed: give it back
      wgmma_wait<1>();
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(g - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    if (lane == 0) mbar_arrive(&empty[(g - 1) % kStages]);

    const int r0 = row0 + cw * 64 + warp * 16 + quad_row;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + half * 8;
      if (r >= row_end) continue;
      __nv_bfloat16* orow = out + (long long)r * out_stride + col0;
#pragma unroll
      for (int n8 = 0; n8 < kHalf / 8; ++n8) {
        const int i = 4 * n8 + 2 * half;
        const int col = n8 * 8 + quad_col;
        if (SWIGLU) {
          const float g0 = acc0[i], g1 = acc0[i + 1];
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(g0 / (1.f + expf(-g0)) * acc1[i], g1 / (1.f + expf(-g1)) * acc1[i + 1]);
        } else {
          *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(acc0[i], acc0[i + 1]);
          *reinterpret_cast<uint32_t*>(orow + kHalf + col) = pack_bf16(acc1[i], acc1[i + 1]);
        }
      }
    }
  }
}

// A rank-2 bf16 tensor map over a row-major [rows, cols] matrix, read in
// boxes of 128 rows × 64 columns with the 128-byte swizzle; rows past the
// end read as zeros.
bool encode_bf16_matrix(CUtensorMap* map, const void* base, long long rows, int cols) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kBK, 128};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x [P, K] and w [E, N, K] bf16, contiguous, 16-byte aligned; offsets
// int32 [E + 1] on the device (non-decreasing, offsets[E] <= P); out bf16
// [P, swiglu ? N / 2 : N], contiguous.  K a multiple of 64; N a multiple of
// 256 (of 256 for the SwiGLU's 2F as well: F a multiple of 128); E at most
// 256.  Rows past offsets[E] are not written.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue when an argument (or a tensor
// map) is refused.
extern "C" int memvul_grouped_gemm(const void* x, const void* w, const void* offsets,
                                   void* out, long long P, int K, int E, int N, int swiglu,
                                   void* stream) {
  if (P < 1 || K < kBK || K % kBK || E < 1 || E > kMaxExperts || N < 2 * kHalf ||
      N % (2 * kHalf) || (swiglu != 0 && swiglu != 1) || P > INT_MAX ||
      (long long)E * N > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const void* const ptrs[4] = {x, w, offsets, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  CUtensorMap x_map, w_map;
  if (!encode_bf16_matrix(&x_map, x, P, K) || !encode_bf16_matrix(&w_map, w, (long long)E * N, K))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = swiglu ? N / 2 / kHalf : N / (2 * kHalf);
  const int out_stride = swiglu ? N / 2 : N;
  const long long max_tiles = (P / kBM + E) * n_tiles;  // row tiles are at most P/128 + E
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)(max_tiles < sms ? max_tiles : sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (swiglu) {
    err = cudaFuncSetAttribute(grouped_gemm_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    grouped_gemm_kernel<true><<<blocks, kThreads, kSmemBytes, s>>>(
        x_map, w_map, off, o, E, K, N, n_tiles, out_stride, N / 2);
  } else {
    err = cudaFuncSetAttribute(grouped_gemm_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    grouped_gemm_kernel<false><<<blocks, kThreads, kSmemBytes, s>>>(
        x_map, w_map, off, o, E, K, N, n_tiles, out_stride, 0);
  }
  return (int)cudaGetLastError();
}
