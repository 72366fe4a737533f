// The plain ("xla") attention formulation as one kernel for Hopper (sm_90a).
//
// Replaces no TPU kernel.  It replaces XLA's fusion of the JAX package's
// memvul_tpu/ops/attention.py::_xla_attention, which that package leaves to
// the compiler under jit.  Eager PyTorch runs the same formulation
// (ops/attention.py::xla_attention) as an einsum, five elementwise passes
// over the [B, H, Tq, Tk] scores and a second einsum; this kernel keeps the
// scores and the weights on chip.  For q, k, v [B, T, H, 64] bf16 (any
// strides with a contiguous last dim, 16-byte-aligned) and an optional bf16
// key bias [B, Tk], each output row keeps the formulation's rounding points:
//
//   s_j = bf16(q · k_j)           f32 sum (the einsum's bf16 scores)
//   s_j = bf16(s_j / d)           d = sqrt(64) in bf16 = 8, so s_j · 0.125:
//                                 the reciprocal of a power of two is exact
//   s_j = bf16(s_j + bias_j)      in f32, rounded (no bias: no add)
//   w_j = bf16(e_j / Σ e),  e_j = exp(s_j − max s)
//                                 f32 softmax, normalised before it is
//                                 rounded: expf and the IEEE quotient, as
//                                 PyTorch's softmax kernel computes them
//   out = bf16(Σ_j w_j · v_j)     f32 sum
//
// Only the order of the f32 sums differs from the eager formulation.  A row
// whose keys are all masked (bias = finfo(bf16).min) averages its values
// uniformly, as the plain softmax does; keys at or past Tk score −inf and
// add exactly 0.
//
// Tk is at most 512 (kMaxTiles key tiles): a work item's scores then fit
// in shared memory.  Longer keys are not the base configuration's, and
// ops/plain_attention.py routes them to the plain formulation.
//
// What bounds it on this card: q, k and v are read and out is written once,
// 4·B·T·H·64·2 bytes (at 262144 tokens and 12 heads 1.61 GB, 0.48 ms at
// 3.35 TB/s), and the two products take 4·B·H·Tq·Tk·64 operations (at
// T = 512, 412 GFLOP, 0.42 ms at 989 TFLOP/s).  Behind both comes what the
// formulation asks of the CUDA cores, which the products do not hide: per
// score, two expf (one MUFU.EX2 each) and a correctly rounded quotient,
// since the weights are normalised before they are rounded (an online
// softmax would round unnormalised weights), and the score's roundings.
// The design keeps that chain short:
//
// * A block is one consumer warpgroup (64 query rows of one (batch, head) at
//   a time) and one producer warp; two blocks share an SM at Tk = 512, and
//   more at fewer keys, as their shared memory allows, so one block's chain
//   runs while another's products and loads are in flight.  The grid is persistent: block i takes work items
//   i, i + gridDim.x, ... (item = (batch·H + head) · n_qtiles + qtile, so
//   the items running at one time share K and V in L2).
// * The producer streams Q and 64-key tiles of K, then of V, by TMA (rank-4
//   tensor maps over (64, T, H, B), 128-byte swizzle, rows past T read as
//   zeros) into a ring of 4 stages with full and empty mbarriers, in the
//   order the consumer takes them, so the next item's tiles load during this
//   item's last pass.  q, k and v are read through their strides: views of
//   the projections need no copy.
// * Pass 1: S = Q·Kᵀ per tile by wgmma.m64n64k16 (both operands K-major in
//   shared memory).  The rounding chain runs on the accumulator in
//   registers on bf16 pairs, one instruction a pair per step: the scale is
//   an exact bf16x2 product and the bias add a bf16x2 sum rounded once,
//   which equals the formulation's f32 sum rounded to bf16 (rounding
//   through 24 bits to 8 is innocuous, as 24 ≥ 2·8 + 2); the row maxima
//   are bf16x2 maxima.  The item's bias row is staged in shared memory
//   once.  Each thread keeps its own bf16 scores in shared memory (8 KB a
//   tile, 64 KB at 512 keys): no thread reads another's, so no barrier
//   guards them.
// * Pass 2 sums e_j over them in f32.  Pass 3 forms w_j, the quotient by
//   one correction of e_j · RN(1/Σ) (no division's slow path, which masked
//   keys, e_j = 0, would take), packs it as the A fragments of O += W·V
//   (wgmma.m64n64k16 from registers, V MN-major in shared memory) and
//   writes O once, rounded.
// * The launcher asks the CUDA runtime for the SM count and the blocks an SM
//   holds once per device, not at every launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>
#include <mutex>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace memvul;

constexpr int kDim = 64;                // head dim: one 128-byte swizzled row
constexpr int kRows = 64;               // query rows of a work item: one warpgroup
constexpr int kKeys = 64;               // keys of a K or V tile
constexpr int kStages = 4;              // depth of the K/V ring
constexpr int kThreads = 160;           // the consumer warpgroup and the producer warp
constexpr uint32_t kTileBytes = kKeys * kDim * 2;  // a Q, K or V tile: 8 KB
constexpr int kMaxTiles = 8;            // key tiles of a call: its scores fit up to 512 keys
constexpr int kMaxDevices = 64;
constexpr int kWords = 16;              // a thread's bf16 pairs of one 64 × 64 score tile

// dynamic shared memory, from a 1024-byte-aligned base: Q, the ring, the
// scores (a tile's 8 KB per 64 keys), the item's bias row (128 bytes per 64
// keys), then the mbarriers q_full, q_empty, full[kStages],
// empty[kStages]
constexpr int kSmemQ = 0;
constexpr int kSmemRing = kSmemQ + kTileBytes;
constexpr int kSmemScores = kSmemRing + kStages * kTileBytes;
constexpr int kNumBars = 2 + 2 * kStages;

__host__ __device__ constexpr int smem_bias(int tiles) { return kSmemScores + tiles * kTileBytes; }

__host__ __device__ constexpr int smem_bars(int tiles) { return smem_bias(tiles) + tiles * kKeys * 2; }

__host__ __device__ constexpr int smem_bytes(int tiles) {
  return smem_bars(tiles) + kNumBars * 8 + 1024;  // + alignment slack
}

constexpr uint32_t kNegInfPair = 0xff80ff80u;   // bf16 −inf twice
constexpr uint32_t kNegZeroPair = 0x80008000u;  // bf16 −0 twice
constexpr uint32_t kOnePair = 0x3f803f80u;      // bf16 1 twice

__device__ __forceinline__ float low_half(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float high_half(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// a · b + c on bf16 pairs, rounded once
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// e / l rounded as IEEE division rounds it, from r = RN(1/l): one
// correction of the product by its exact residual (Markstein), without
// the division's slow path; quotients below 2^-126 (weights that round to
// bf16 zero or a subnormal no output can see) may differ in their last bit
__device__ __forceinline__ float quotient(float e, float l, float r) {
  const float q = e * r;
  return fmaf(fmaf(-q, l, e), r, q);
}

__global__ void __launch_bounds__(kThreads, 2)
plain_attn_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __nv_bfloat16* __restrict__ bias, long long bias_sb,
                      __nv_bfloat16* __restrict__ out, Strides os, int H, int Tq, int Tk,
                      int n_qtiles, int n_items, float inv_d) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int n_tiles = (Tk + kKeys - 1) / kKeys;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + kSmemQ);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + kSmemRing);
  uint32_t* scores = reinterpret_cast<uint32_t*>(smem + kSmemScores);
  __nv_bfloat16* bias_s = reinterpret_cast<__nv_bfloat16*>(smem + smem_bias(n_tiles));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + smem_bars(n_tiles));
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_full + 2;
  uint64_t* empty = full + kStages;

  if (threadIdx.x == 0) {
    tma_prefetch_map(&q_map);
    tma_prefetch_map(&k_map);
    tma_prefetch_map(&v_map);
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4);  // one arrival per consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // -- producer: one thread of warp 4 ---------------------------------------
    if (threadIdx.x != 128) return;
    int g = 0;  // tiles loaded by this block, over all its items
    auto load = [&](const CUtensorMap* map, int key0, int h, int b) {
      const int s = g % kStages;
      mbar_wait(&empty[s], ((g / kStages) & 1) ^ 1);  // a stage's first use passes at once
      mbar_arrive_expect_tx(&full[s], kTileBytes);
      tma_load_4d(ring + s * kKeys * kDim, map, &full[s], 0, key0, h, b);
      ++g;
    };
    for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n) {
      const int qtile = item % n_qtiles, bh = item / n_qtiles;
      const int b = bh / H, h = bh % H;
      mbar_wait(q_empty, (n & 1) ^ 1);
      mbar_arrive_expect_tx(q_full, kTileBytes);
      tma_load_4d(q_s, &q_map, q_full, 0, qtile * kRows, h, b);
      // the tiles in the order the consumer takes them
      for (int it = 0; it < n_tiles; ++it) load(&k_map, it * kKeys, h, b);
      for (int it = 0; it < n_tiles; ++it) load(&v_map, it * kKeys, h, b);
    }
    return;
  }

  // -- consumer warpgroup --------------------------------------------------------
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad_row = lane / 4;        // accumulator row (and row + 8)
  const int quad_col = (lane % 4) * 2;  // first of each 8-column chunk's pair
  const WgmmaFlags flags;
  float sc[32];         // S of one tile: 8 chunks of 8 keys, m16n8 fragments
  float o[32];          // O: 8 chunks of 8 dims
  uint32_t words[kWords];  // the tile's bf16 scores: [2i] row r, keys 8i + quad_col, +1; [2i + 1] row r + 8
  uint32_t pf[4][4];    // W of one tile as the A fragments of 4 m64n64k16, one per 16 keys
  uint64_t qd[kDim / 16], kd[kDim / 16], vd[kKeys / 16];
  float m0, m1, l0, l1, r0, r1;
  uint32_t mx0, mx1;    // running row maxima as bf16 pairs
  const uint32_t scale2 = pack_bf16(inv_d, inv_d);  // exact: inv_d is a power of two
  int g = 0;  // tiles consumed by this block, over all its items

  auto stage_wait = [&]() -> int {
    const int s = g % kStages;
    mbar_wait(&full[s], (g / kStages) & 1);
    return s;
  };
  auto stage_release = [&](int s) {
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
    ++g;
  };
  // S = Q·Kᵀ of the next K tile in the ring
  auto qk = [&] {
    const int s = stage_wait();
    const uint64_t k_desc = wgmma_desc_sw128(ring + s * kKeys * kDim, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < kDim / 16; ++kk) kd[kk] = wgmma_desc_advance(k_desc, kk * 32);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDim / 16; ++kk)
      wgmma_m64n64k16_ss(sc, qd[kk], kd[kk], kk ? flags.on : flags.off);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    stage_release(s);
  };
  // the rounding chain on S of tile `it`, into words (−inf past Tk), and
  // the row maxima
  auto chain = [&](int it, bool has_bias) {
    const bool partial = (it + 1) * kKeys > Tk;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int key0 = it * kKeys + i * 8 + quad_col;
      const uint32_t bias2 = has_bias ? *reinterpret_cast<const uint32_t*>(bias_s + key0) : 0u;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the einsum's bf16 scores, then / d as the exact product by 1/d
        uint32_t w = fma_bf16x2(pack_bf16(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]), scale2,
                                kNegZeroPair);
        if (has_bias) w = fma_bf16x2(w, kOnePair, bias2);
        if (partial) {
          if (key0 >= Tk) w = (w & 0xffff0000u) | 0xff80u;  // bf16 −inf
          if (key0 + 1 >= Tk) w = (w & 0x0000ffffu) | 0xff800000u;
        }
        words[2 * i + r] = w;
        if (r == 0) mx0 = max_bf16x2(mx0, w);
        else mx1 = max_bf16x2(mx1, w);
      }
    }
  };
  auto row_sum = [&] {
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      l0 += expf(low_half(words[2 * i]) - m0);
      a0 += expf(high_half(words[2 * i]) - m0);
      l1 += expf(low_half(words[2 * i + 1]) - m1);
      a1 += expf(high_half(words[2 * i + 1]) - m1);
    }
    l0 += a0;
    l1 += a1;
  };
  // W = exp(s − max) / Σ, rounded to bf16, as the A fragments of W·V: chunk
  // 2j's pairs in pf[j][0..1], chunk 2j + 1's in pf[j][2..3]
  auto weights = [&] {
#pragma unroll
    for (int p = 0; p < kWords; ++p) {
      const float m = (p & 1) ? m1 : m0, l = (p & 1) ? l1 : l0, r = (p & 1) ? r1 : r0;
      pf[p / 4][p % 4] = pack_bf16(quotient(expf(low_half(words[p]) - m), l, r),
                                   quotient(expf(high_half(words[p]) - m), l, r));
    }
  };
  // O += W·V with the next V tile in the ring (MN-major: 8-key groups 1024
  // bytes apart, 2048 bytes per 16 keys)
  auto pv = [&] {
    const int s = stage_wait();
    const uint64_t v_desc = wgmma_desc_sw128(ring + s * kKeys * kDim, 16, 1024);
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j) vd[j] = wgmma_desc_advance(v_desc, j * 16 * 128);
    fence_regs(o);
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j) fence_regs(pf[j]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j) wgmma_m64n64k16_rs(o, pf[j], vd[j], flags.on);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    stage_release(s);
  };
  // a thread's own score words of tile `it` in shared memory: word p of
  // thread t at (it·16 + p)·128 + t, so a warp's stores are conflict-free
  auto store_words = [&](int it) {
#pragma unroll
    for (int p = 0; p < kWords; ++p) scores[(it * kWords + p) * 128 + tid] = words[p];
  };
  auto load_words = [&](int it) {
#pragma unroll
    for (int p = 0; p < kWords; ++p) words[p] = scores[(it * kWords + p) * 128 + tid];
  };

  for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n) {
    const int qtile = item % n_qtiles, bh = item / n_qtiles;
    const int b = bh / H, h = bh % H;
    const int row0 = qtile * kRows + warp * 16 + quad_row;
    const __nv_bfloat16* brow = bias != nullptr ? bias + b * bias_sb : nullptr;
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    mx0 = mx1 = kNegInfPair;
    l0 = l1 = 0.f;
    if (brow != nullptr) {
      // the item's bias row, zeros past Tk, once every warp is done with the
      // previous item's
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      for (int j = tid; j < n_tiles * kKeys; j += 128)
        bias_s[j] = j < Tk ? brow[j] : __ushort_as_bfloat16(0);
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
    }
    mbar_wait(q_full, n & 1);
    const uint64_t q_desc = wgmma_desc_sw128(q_s, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < kDim / 16; ++kk) qd[kk] = wgmma_desc_advance(q_desc, kk * 32);

    // pass 1: the scores and each row's max
    for (int it = 0; it < n_tiles; ++it) {
      qk();
      chain(it, brow != nullptr);
      store_words(it);
    }
    // a row's columns are spread over its quad
    m0 = fmaxf(low_half(mx0), high_half(mx0));
    m1 = fmaxf(low_half(mx1), high_half(mx1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
    if (lane == 0) mbar_arrive(q_empty);  // Q may take the next item's

    // pass 2: the softmax denominators
    for (int it = 0; it < n_tiles; ++it) {
      load_words(it);
      row_sum();
    }
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    r0 = __frcp_rn(l0);
    r1 = __frcp_rn(l1);

    // pass 3: the normalised weights, rounded, times V
    for (int it = 0; it < n_tiles; ++it) {
      load_words(it);
      weights();
      pv();
    }

    __nv_bfloat16* ob = out + b * os.b + h * os.h;
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const int col = n8 * 8 + quad_col;
      if (row0 < Tq)
        *reinterpret_cast<uint32_t*>(ob + (long long)row0 * os.t + col) =
            pack_bf16(o[4 * n8 + 0], o[4 * n8 + 1]);
      if (row0 + 8 < Tq)
        *reinterpret_cast<uint32_t*>(ob + (long long)(row0 + 8) * os.t + col) =
            pack_bf16(o[4 * n8 + 2], o[4 * n8 + 3]);
    }
  }
}

// the SM count and the blocks an SM holds at each key-tile count, asked of
// the CUDA runtime once per device
struct Occupancy {
  cudaError_t err = cudaSuccess;
  int sms = 0;
  int per_sm[kMaxTiles + 1] = {};
};

const Occupancy& occupancy(int device) {
  static Occupancy table[kMaxDevices];
  static std::once_flag once[kMaxDevices];
  std::call_once(once[device], [device] {
    Occupancy& o = table[device];
    o.err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, device);
    if (o.err == cudaSuccess)
      o.err = cudaFuncSetAttribute(plain_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes(kMaxTiles));
    for (int n = 1; n <= kMaxTiles && o.err == cudaSuccess; ++n)
      o.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.per_sm[n], plain_attn_fwd_kernel,
                                                            kThreads, smem_bytes(n));
  });
  return table[device];
}

int launch(const void* q, const void* k, const void* v, const __nv_bfloat16* bias,
           long long bias_sb, void* out, int B, int H, int Tq, int Tk, Strides qs, Strides ks,
           Strides vs, Strides os, float inv_d, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!encode_bf16_rows(&q_map, q, B, Tq, H, qs, kRows) ||
      !encode_bf16_rows(&k_map, k, B, Tk, H, ks, kKeys) ||
      !encode_bf16_rows(&v_map, v, B, Tk, H, vs, kKeys))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (Tk + kKeys - 1) / kKeys;
  const int n_qtiles = (Tq + kRows - 1) / kRows;
  const long long items = (long long)n_qtiles * B * H;
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const Occupancy& o = occupancy(device);
  if (o.err != cudaSuccess) return (int)o.err;
  if (o.per_sm[n_tiles] < 1) return (int)cudaErrorInvalidConfiguration;
  const long long resident = (long long)o.sms * o.per_sm[n_tiles];
  const int blocks = (int)(items < resident ? items : resident);
  plain_attn_fwd_kernel<<<blocks, kThreads, smem_bytes(n_tiles), stream>>>(
      q_map, k_map, v_map, bias, bias_sb, static_cast<__nv_bfloat16*>(out), os, H, Tq, Tk,
      n_qtiles, (int)items, inv_d);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: bf16 [B, T, H, 64], strides in elements (the last dim
// contiguous), Tk at most 512; bias: bf16 [B, Tk] with row stride bias_sb (0 broadcasts one
// row), or null for no bias; inv_d: 1 / d for the bf16 divisor d, a power of
// two.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue when an argument (or a tensor map) is refused.
extern "C" int memvul_plain_attn_fwd(const void* q, const void* k, const void* v,
                                     const void* bias, void* out, int B, int H, int Tq, int Tk,
                                     long long q_sb, long long q_st, long long q_sh,
                                     long long k_sb, long long k_st, long long k_sh,
                                     long long v_sb, long long v_st, long long v_sh,
                                     long long o_sb, long long o_st, long long o_sh,
                                     long long bias_sb, float inv_d, void* stream) {
  if (B < 0 || H < 1 || Tq < 0 || Tk < 1 || Tk > kMaxTiles * kKeys || bias_sb < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0) return (int)cudaGetLastError();
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh},
      os{o_sb, o_st, o_sh};
  const void* ptrs[4] = {q, k, v, out};
  const Strides all[4] = {qs, ks, vs, os};
  if (!tensor_core_eligible(ptrs, all, 4)) return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* bp = static_cast<const __nv_bfloat16*>(bias);
  return launch(q, k, v, bp, bias_sb, out, B, H, Tq, Tk, qs, ks, vs, os, inv_d,
                static_cast<cudaStream_t>(stream));
}

// dynamic shared memory of a block at Tk keys (at most 512), in bytes
extern "C" int memvul_plain_attn_smem_bytes(int Tk) { return smem_bytes((Tk + kKeys - 1) / kKeys); }
