// Exact blockwise (flash) attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel memvul_tpu/ops/pallas/flash_kernel.py:
// flash_attention (host side _flash_forward, body _flash_fwd_kernel).  For
// q, k, v [B, T, H, Dh] (any strides with a contiguous last dim) and an f32
// additive key bias [B, Tk] (the padding mask), each output row is
//
//   out[b, t, h] = Σ_j p_j · v[b, j, h] / max(Σ_j p_j, 1e-30),
//   p_j = exp(s_j − max_j s_j),  s_j = (q[b, t, h] · k[b, j, h]) · scale + bias[b, j]
//
// with the running max, the denominator and the accumulator in f32, and p
// rounded to the value dtype before the PV product, as the TPU kernel does.
// The score matrix never reaches device memory.  The running max starts at
// the finite f32 minimum and masked keys carry a finite score, so a row
// whose keys are all masked averages its values uniformly instead of giving
// NaN.  Keys at or beyond Tk add exactly 0.
//
// What bounds it on this card: 4·B·H·Tq·Tk·Dh operations against
// 4·B·T·H·Dh elements of q, k, v and out, so from a few hundred keys on it
// is bound by operations, at the bf16 tensor cores' 989 TFLOP/s
// ([64, 4096, 12, 64]: 3.30e12 operations, 3.34 ms).  And at head dim 64 a
// score costs one exp2 on the special-function unit (16 a cycle on an SM)
// for every 256 operations of the tensor cores (4096 a cycle): the softmax
// takes as long as the two products unless it overlaps them.  Two kernels
// share the contract:
//
// * flash_fwd_wgmma_kernel (bf16, head dim 64, 16-byte-aligned bases and
//   strides a nonzero multiple of 8 elements: the main path).  A block
//   works on 64·NC query rows of one (batch, head) at a time and is NC + 1
//   warpgroups, NC = 3 (2 where padding Tq to 192 rows would waste more
//   than 128 rows do, as at T = 256); the grid is persistent (a block per
//   SM, taking work items in turn), so one item's epilogue overlaps the
//   next item's loads:
//   - warpgroup 0 is the producer.  It gives its registers away
//     (setmaxnreg.dec); one thread loads each item's Q (two buffers: this
//     item's and the next's) and streams 128-key tiles of K and V by TMA
//     (rank-4 tensor maps over (Dh, T, H, B), 128-byte swizzle, rows past
//     T read as zeros) into a ring of 3 stages with full and empty
//     mbarriers, and its first warp stages each tile's bias beside them,
//     in log2 units, −inf past Tk;
//   - warpgroups 1..NC are consumers of 64 query rows each
//     (setmaxnreg.inc).  S = Q·Kᵀ is 4 wgmma.m64n128k16 from shared memory
//     (both operands K-major); the online softmax runs on S in registers;
//     P, rounded to bf16, is reused in place as the A operand of
//     O += P·V, 8 wgmma.m64n64k16 with V MN-major in shared memory.  Each
//     consumer issues the next tile's QKᵀ before this tile's PV and runs
//     the next softmax while PV is on the tensor cores.
//   The loads never stall the math (the ring keeps two tiles in flight),
//   each K/V byte brought on chip serves 64·NC rows, and while one
//   consumer warpgroup runs its softmax the others' products keep the
//   tensor cores busy.  The softmax, not the products, bounds the kernel:
//   with three consumers each SM sub-partition has three softmax warps to
//   interleave.
// * flash_fwd_kernel (f32, or other head dims, or unaligned views) does
//   its products on the CUDA cores in f32: one block per (batch·head, 128
//   queries), one thread per query row holding q and its accumulator in
//   registers.  Key and value tiles are staged in shared memory as f32 and
//   read as broadcast float4s (every lane reads the same key), so shared
//   memory serves a warp per load and the FMA pipes stay busy; 16 keys per
//   online-softmax step give 16 independent dot-product chains per thread.
//
// Scores are in log2 units on the wgmma path: s·scale·log2(e) plus the
// bias·log2(e) that the producer staged, clamped at the finite f32
// minimum.  The sum is not clamped again: a masked key's score rounds to
// that minimum unless |s·scale·log2(e)| exceeds about 1e31, and a second
// clamp cost 11% of the kernel's time.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace memvul;

constexpr int kBlockQ = 128;     // threads per block, one query row each
constexpr int kKeysPerStep = 16;  // keys folded per online-softmax step

template <typename T, int HD>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ out, int H, int Tq, int Tk, Strides qs,
                 Strides ks_, Strides vs_, Strides os, long long bias_sb,
                 float scale) {
  constexpr int kBlockK = 4096 / HD;  // 16 KB of f32 per staged tile
  static_assert(HD % 4 == 0, "head dim must be a multiple of 4");
  static_assert(kBlockK % kKeysPerStep == 0, "key tile must hold whole steps");
  __shared__ __align__(16) float k_tile[kBlockK][HD];
  __shared__ __align__(16) float v_tile[kBlockK][HD];
  __shared__ float b_tile[kBlockK];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int row = blockIdx.y * kBlockQ + threadIdx.x;
  const bool live = row < Tq;

  float qr[HD];
  {
    const T* qp = q + b * qs.b + (long long)(live ? row : 0) * qs.t + h * qs.h;
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = to_f32(qp[d]);
  }
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  float m = kF32Min, l = 0.f;

  const T* kb = k + b * ks_.b + h * ks_.h;
  const T* vb = v + b * vs_.b + h * vs_.h;
  const float* bb = bias + b * bias_sb;

  for (int k0 = 0; k0 < Tk; k0 += kBlockK) {
    const int nk = min(kBlockK, Tk - k0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < nk * HD; i += kBlockQ) {
      const int j = i / HD, d = i % HD;
      k_tile[j][d] = to_f32(kb[(long long)(k0 + j) * ks_.t + d]);
      v_tile[j][d] = to_f32(vb[(long long)(k0 + j) * vs_.t + d]);
    }
    for (int j = threadIdx.x; j < nk; j += kBlockQ) b_tile[j] = bb[k0 + j];
    __syncthreads();

    for (int j0 = 0; j0 < nk; j0 += kKeysPerStep) {
      float s[kKeysPerStep];
      float m_new = m;
#pragma unroll
      for (int jj = 0; jj < kKeysPerStep; ++jj) {
        const int j = j0 + jj;
        if (j < nk) {
          const float4* kr = reinterpret_cast<const float4*>(k_tile[j]);
          float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
          for (int d4 = 0; d4 < HD / 4; d4 += 2) {
            const float4 ka = kr[d4];
            dot0 = fmaf(qr[4 * d4 + 0], ka.x, dot0);
            dot0 = fmaf(qr[4 * d4 + 1], ka.y, dot0);
            dot0 = fmaf(qr[4 * d4 + 2], ka.z, dot0);
            dot0 = fmaf(qr[4 * d4 + 3], ka.w, dot0);
            if (d4 + 1 < HD / 4) {
              const float4 kc = kr[d4 + 1];
              dot1 = fmaf(qr[4 * d4 + 4], kc.x, dot1);
              dot1 = fmaf(qr[4 * d4 + 5], kc.y, dot1);
              dot1 = fmaf(qr[4 * d4 + 6], kc.z, dot1);
              dot1 = fmaf(qr[4 * d4 + 7], kc.w, dot1);
            }
          }
          s[jj] = (dot0 + dot1) * scale + b_tile[j];
          m_new = fmaxf(m_new, s[jj]);
        } else {
          s[jj] = kF32Min;
        }
      }
      const float correction = expf(m - m_new);
      l *= correction;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= correction;
#pragma unroll
      for (int jj = 0; jj < kKeysPerStep; ++jj) {
        const int j = j0 + jj;
        if (j < nk) {
          const float p = expf(s[jj] - m_new);
          l += p;
          const float pv = round_to<T>(p);
          const float4* vr = reinterpret_cast<const float4*>(v_tile[j]);
#pragma unroll
          for (int d4 = 0; d4 < HD / 4; ++d4) {
            const float4 va = vr[d4];
            acc[4 * d4 + 0] = fmaf(pv, va.x, acc[4 * d4 + 0]);
            acc[4 * d4 + 1] = fmaf(pv, va.y, acc[4 * d4 + 1]);
            acc[4 * d4 + 2] = fmaf(pv, va.z, acc[4 * d4 + 2]);
            acc[4 * d4 + 3] = fmaf(pv, va.w, acc[4 * d4 + 3]);
          }
        }
      }
      m = m_new;
    }
  }

  if (!live) return;
  const float denom = fmaxf(l, 1e-30f);
  T* op = out + b * os.b + (long long)row * os.t + h * os.h;
#pragma unroll
  for (int d = 0; d < HD; ++d) op[d] = from_f32<T>(acc[d] / denom);
}


// -- wgmma path: bf16 q/k/v with head dim 64 ---------------------------------

constexpr int kWgKeys = 128;     // keys per K/V tile
constexpr int kWgDim = 64;       // head dim: one 128-byte swizzled row
constexpr int kWgStages = 3;     // K/V ring depth
constexpr int kWgQBufs = 2;      // Q of this item and of the next
constexpr uint32_t kWgTileBytes = kWgKeys * kWgDim * 2;
// q_full[], q_empty[], k_full[], v_full[], empty[]
constexpr int kNumBars = 2 * kWgQBufs + 3 * kWgStages;

// A block of NC consumer warpgroups (64 query rows each) and a producer.
template <int NC>
struct WgConfig {
  static constexpr int kRows = 64 * NC;           // query rows per work item
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr uint32_t kQBytes = kRows * kWgDim * 2;
  // shared memory, from a 1024-byte-aligned base
  static constexpr int kSmemQ = 0;
  static constexpr int kSmemK = kSmemQ + kWgQBufs * kQBytes;
  static constexpr int kSmemV = kSmemK + kWgStages * kWgTileBytes;
  static constexpr int kSmemBias = kSmemV + kWgStages * kWgTileBytes;
  static constexpr int kSmemBars = kSmemBias + kWgStages * kWgKeys * 4;
  static constexpr int kSmemBytes = kSmemBars + kNumBars * 8 + 1024;  // + alignment slack
  // the producer's registers given away, the consumers' taken
  static constexpr int kProducerRegs = NC == 2 ? 40 : 24;
  static constexpr int kConsumerRegs = NC == 2 ? 232 : 160;
  static_assert(128 * kProducerRegs + 128 * NC * kConsumerRegs <= 65536, "register file");
};

// A work item is 64·NC query rows of one (batch, head): item = bh · n_qtiles
// + qtile, so the items running at one time share (batch, head) and its K
// and V stay in L2.  The grid is persistent: block i takes items i, i +
// gridDim.x, ... in turn, and the producer loads the next item's Q and
// first tiles while the consumers finish this one and write it out.
template <int NC>
__global__ void __launch_bounds__(WgConfig<NC>::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                       int H, int Tq, int Tk, int n_qtiles, int n_items, Strides os,
                       long long bias_sb, float scale_log2) {
  using C = WgConfig<NC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + C::kSmemQ);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + C::kSmemK);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + C::kSmemV);
  float* bias_s = reinterpret_cast<float*>(smem + C::kSmemBias);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kSmemBars);
  uint64_t* q_empty = q_full + kWgQBufs;
  uint64_t* k_full = q_empty + kWgQBufs;
  uint64_t* v_full = k_full + kWgStages;
  uint64_t* empty = v_full + kWgStages;

  const int n_tiles = (Tk + kWgKeys - 1) / kWgKeys;
  // the warpgroup index through a shuffle, so the compiler knows it is
  // uniform and keeps the wgmma descriptors in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    tma_prefetch_map(&q_map);
    tma_prefetch_map(&k_map);
    tma_prefetch_map(&v_map);
    for (int i = 0; i < kWgQBufs; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 4 * NC);  // one arrival per consumer warp
    }
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&k_full[s], 32);  // the bias warp's lanes, and K's bytes
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 4 * NC);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // -- producer ------------------------------------------------------------
    setmaxnreg_dec<C::kProducerRegs>();
    if (warp != 0) return;
    int g = 0;  // K/V tiles loaded by this block, over all its items
    for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n) {
      const int qtile = item % n_qtiles, bh = item / n_qtiles;
      const int b = bh / H, h = bh % H;
      const int qb = n % kWgQBufs;
      // a Q buffer's first use passes at once, as does a stage's
      mbar_wait(&q_empty[qb], ((n / kWgQBufs) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(&q_full[qb], C::kQBytes);
        tma_load_4d(q_s + qb * C::kRows * kWgDim, &q_map, &q_full[qb], 0, qtile * C::kRows, h, b);
      }
      const float* bb = bias + b * bias_sb;
      for (int it = 0; it < n_tiles; ++it, ++g) {
        const int s = g % kWgStages;
        mbar_wait(&empty[s], ((g / kWgStages) & 1) ^ 1);
        const int k0 = it * kWgKeys;
        if (lane == 0) {  // the copies first, so the bias load overlaps them
          mbar_expect_tx(&k_full[s], kWgTileBytes);
          tma_load_4d(k_s + s * kWgKeys * kWgDim, &k_map, &k_full[s], 0, k0, h, b);
          mbar_arrive_expect_tx(&v_full[s], kWgTileBytes);
          tma_load_4d(v_s + s * kWgKeys * kWgDim, &v_map, &v_full[s], 0, k0, h, b);
        }
        float* bs = bias_s + s * kWgKeys;
        for (int j = lane; j < kWgKeys; j += 32) {
          const int key = k0 + j;
          bs[j] = key < Tk ? fmaxf(__ldg(bb + key) * kLog2e, kF32Min) : -CUDART_INF_F;
        }
        mbar_arrive(&k_full[s]);  // this lane's bias is staged
      }
    }
    return;
  }

  // -- consumers ---------------------------------------------------------------
  setmaxnreg_inc<C::kConsumerRegs>();
  const int cw = wg - 1;                 // which 64 rows of an item
  const int quad_row = lane / 4;         // accumulator row (and row + 8)
  const int quad_col = (lane % 4) * 2;   // first of each 8-column chunk's pair

  float o[32];        // O: 8 chunks of 8 dims, m16n8 fragments
  float m0 = kF32Min, m1 = kF32Min, l0 = 0.f, l1 = 0.f;  // m in log2 units
  float sc[64];       // S: this warp's 16 rows × 128 keys, 16 chunks of 8 keys
  uint32_t pf[8][4];  // P of the tile in PV: bf16 A fragments, one per 16 keys
  float corr0, corr1;
  int g = 0;          // K/V tiles consumed by this block before this item

  const WgmmaFlags flags;
  // K-major Q and K: 8-row groups 1024 bytes apart, 32 bytes per 16 dims
  uint64_t qd[kWgDim / 16], kd[kWgDim / 16];
  auto q_descs = [&](int qb) {
    const uint64_t q_desc =
        wgmma_desc_sw128(q_s + (qb * C::kRows + cw * 64) * kWgDim, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < kWgDim / 16; ++kk) qd[kk] = wgmma_desc_advance(q_desc, kk * 32);
  };
  auto k_descs = [&](int it) {
    const int s = (g + it) % kWgStages;
    const uint64_t k_desc = wgmma_desc_sw128(k_s + s * kWgKeys * kWgDim, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < kWgDim / 16; ++kk) kd[kk] = wgmma_desc_advance(k_desc, kk * 32);
  };
  auto issue_qk = [&] {
#pragma unroll
    for (int kk = 0; kk < kWgDim / 16; ++kk)
      wgmma_m64n128k16_ss(sc, qd[kk], kd[kk], kk ? flags.on : flags.off);
    wgmma_commit();
  };
  // The online-softmax step of tile `it` on S, in place: scores in log2
  // units, s·scale·log2(e) plus the staged bias, which the producer
  // clamped at the finite minimum (so a masked score rounds to that
  // minimum and a fully masked row averages uniformly); keys past Tk
  // (staged bias −inf, only in the last tile) at −inf, so they add 0.
  // Updates m and l, sets the rescale of O, and leaves p in S.  The f32 p
  // feeds the denominators.
  auto softmax = [&](int it) {
    const float* bs = bias_s + ((g + it) % kWgStages) * kWgKeys;
    const bool partial = (it + 1) * kWgKeys > Tk;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float2 bk = *reinterpret_cast<const float2*>(bs + i * 8 + quad_col);
      float s0 = fmaf(sc[4 * i + 0], scale_log2, bk.x);
      float s1 = fmaf(sc[4 * i + 1], scale_log2, bk.y);
      float s2 = fmaf(sc[4 * i + 2], scale_log2, bk.x);
      float s3 = fmaf(sc[4 * i + 3], scale_log2, bk.y);
      if (partial) {
        if (bk.x == -CUDART_INF_F) s0 = s2 = -CUDART_INF_F;
        if (bk.y == -CUDART_INF_F) s1 = s3 = -CUDART_INF_F;
      }
      sc[4 * i + 0] = s0;
      sc[4 * i + 1] = s1;
      sc[4 * i + 2] = s2;
      sc[4 * i + 3] = s3;
      mx0 = fmaxf(mx0, fmaxf(s0, s1));
      mx1 = fmaxf(mx1, fmaxf(s2, s3));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    corr0 = exp2_approx(m0 - mx0);
    corr1 = exp2_approx(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= corr0;
    l1 *= corr1;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      sc[4 * i + 0] = exp2_approx(sc[4 * i + 0] - mx0);
      sc[4 * i + 1] = exp2_approx(sc[4 * i + 1] - mx0);
      sc[4 * i + 2] = exp2_approx(sc[4 * i + 2] - mx1);
      sc[4 * i + 3] = exp2_approx(sc[4 * i + 3] - mx1);
      l0 += sc[4 * i + 0] + sc[4 * i + 1];
      l1 += sc[4 * i + 2] + sc[4 * i + 3];
    }
  };
  // P rounded to bf16 as A fragments of m64n64k16, one per 16 keys: chunk
  // 2j in pf[j][0..1], chunk 2j + 1 in pf[j][2..3]
  auto pack_p = [&] {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      pf[i / 2][(i % 2) * 2 + 0] = pack_bf16(sc[4 * i + 0], sc[4 * i + 1]);
      pf[i / 2][(i % 2) * 2 + 1] = pack_bf16(sc[4 * i + 2], sc[4 * i + 3]);
    }
  };
  auto rescale_o = [&] {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[4 * n + 0] *= corr0;
      o[4 * n + 1] *= corr0;
      o[4 * n + 2] *= corr1;
      o[4 * n + 3] *= corr1;
    }
  };
  // MN-major V: 8-key groups 1024 bytes apart, 2048 bytes per 16 keys
  uint64_t vd[kWgKeys / 16];
  auto v_descs = [&](int it) {
    const int s = (g + it) % kWgStages;
    const uint64_t v_desc = wgmma_desc_sw128(v_s + s * kWgKeys * kWgDim, 16, 1024);
#pragma unroll
    for (int j = 0; j < kWgKeys / 16; ++j) vd[j] = wgmma_desc_advance(v_desc, j * 16 * 128);
  };
  auto issue_pv = [&] {
#pragma unroll
    for (int j = 0; j < kWgKeys / 16; ++j) wgmma_m64n64k16_rs(o, pf[j], vd[j], flags.on);
    wgmma_commit();
  };
  // S, P and O as ordinary instructions left them, before a batch's fence
  auto pin_inputs = [&] {
    fence_regs(sc);
    fence_regs(o);
#pragma unroll
    for (int j = 0; j < 8; ++j) fence_regs(pf[j]);
  };
  auto wait_k = [&](int it) {
    mbar_wait(&k_full[(g + it) % kWgStages], ((g + it) / kWgStages) & 1);
  };
  auto wait_v = [&](int it) {
    mbar_wait(&v_full[(g + it) % kWgStages], ((g + it) / kWgStages) & 1);
  };
  auto release = [&](int it) {
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(&empty[(g + it) % kWgStages]);  // this warp is done with the stage
  };

  for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n) {
    const int qtile = item % n_qtiles, bh = item / n_qtiles;
    const int b = bh / H, h = bh % H;
    const int qb = n % kWgQBufs;
    const int row0 = qtile * C::kRows + cw * 64 + warp * 16 + quad_row;
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    m0 = m1 = kF32Min;
    l0 = l1 = 0.f;
    q_descs(qb);

    // Pipelined: QKᵀ of tile it + 1 is issued just before PV of tile it,
    // and while PV runs on the tensor cores the next softmax is computed
    // in S; P is packed from it only once PV has landed, since ptxas would
    // otherwise share P's registers between the two tiles and serialize
    // every wgmma.  O is rescaled to the running max before each PV.
    // Every register input of the two products is ready before the first
    // is issued, and every iteration has the same two commit groups, so
    // ptxas can see which one each wait retires and keeps the products
    // asynchronous.
    mbar_wait(&q_full[qb], (n / kWgQBufs) & 1);
    wait_k(0);
    k_descs(0);
    pin_inputs();
    wgmma_fence();
    issue_qk();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0);
    pack_p();
    for (int it = 0; it + 1 < n_tiles; ++it) {
      wait_k(it + 1);
      wait_v(it);
      k_descs(it + 1);
      v_descs(it);
      rescale_o();
      pin_inputs();
      wgmma_fence();
      issue_qk();
      issue_pv();
      wgmma_wait<1>();  // QKᵀ of it + 1 has landed; PV of it may still run
      fence_regs(sc);
      softmax(it + 1);
      release(it);
      pack_p();  // PV of it no longer reads pf
    }
    wait_v(n_tiles - 1);
    v_descs(n_tiles - 1);
    rescale_o();
    pin_inputs();
    wgmma_fence();
    issue_pv();
    release(n_tiles - 1);
    g += n_tiles;
    // every QKᵀ of this item has landed: its Q buffer may take item n + 2's
    if (lane == 0) mbar_arrive(&q_empty[qb]);

    // each thread summed its own columns; the quad holds the whole row
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* ob = out + b * os.b + h * os.h;
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const int col = n8 * 8 + quad_col;
      if (row0 < Tq)
        *reinterpret_cast<uint32_t*>(ob + (long long)row0 * os.t + col) =
            pack_bf16(o[4 * n8 + 0] / d0, o[4 * n8 + 1] / d0);
      if (row0 + 8 < Tq)
        *reinterpret_cast<uint32_t*>(ob + (long long)(row0 + 8) * os.t + col) =
            pack_bf16(o[4 * n8 + 2] / d1, o[4 * n8 + 3] / d1);
    }
  }
}

// Three consumer warpgroups (192 rows an item) keep three softmax warps on
// each SM sub-partition to hide one another's latency, and serve 192 rows
// from each K/V tile; they are taken unless padding Tq to 192 rows costs
// more than 1/8 over padding it to 128 (T = 256: 384 rows against 256).
int wgmma_consumers(int Tq) {
  const long long rows2 = (Tq + 127LL) / 128 * 128, rows3 = (Tq + 191LL) / 192 * 192;
  return rows3 * 8 <= rows2 * 9 ? 3 : 2;
}

template <int NC>
int launch_wgmma(const void* q, const void* k, const void* v, const float* bias, void* out,
                 int B, int H, int Tq, int Tk, Strides qs, Strides ks, Strides vs, Strides os,
                 long long bias_sb, float scale, cudaStream_t stream) {
  using C = WgConfig<NC>;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_bf16_rows(&q_map, q, B, Tq, H, qs, C::kRows) ||
      !encode_bf16_rows(&k_map, k, B, Tk, H, ks, kWgKeys) ||
      !encode_bf16_rows(&v_map, v, B, Tk, H, vs, kWgKeys))
    return (int)cudaErrorInvalidValue;
  const int n_qtiles = (Tq + C::kRows - 1) / C::kRows;
  const long long items = (long long)n_qtiles * B * H;
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<NC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)(items < sms ? items : sms);  // one resident block per SM
  flash_fwd_wgmma_kernel<NC><<<blocks, C::kThreads, C::kSmemBytes, stream>>>(
      q_map, k_map, v_map, bias, static_cast<__nv_bfloat16*>(out), H, Tq, Tk, n_qtiles,
      (int)items, os, bias_sb, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, const float* bias,
            void* out, int B, int H, int Tq, int Tk, Strides qs, Strides ks,
            Strides vs, Strides os, long long bias_sb, float scale,
            cudaStream_t stream) {
  const dim3 grid(B * H, (Tq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T, HD><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), H, Tq, Tk, qs, ks,
      vs, os, bias_sb, scale);
}

template <typename T>
int dispatch_head_dim(int D, const void* q, const void* k, const void* v,
                      const float* bias, void* out, int B, int H, int Tq,
                      int Tk, Strides qs, Strides ks, Strides vs, Strides os,
                      long long bias_sb, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: launch<T, 16>(q, k, v, bias, out, B, H, Tq, Tk, qs, ks, vs, os, bias_sb, scale, stream); break;
    case 32: launch<T, 32>(q, k, v, bias, out, B, H, Tq, Tk, qs, ks, vs, os, bias_sb, scale, stream); break;
    case 64: launch<T, 64>(q, k, v, bias, out, B, H, Tq, Tk, qs, ks, vs, os, bias_sb, scale, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, for the
// [B, T, H, Dh] layout (the last dim contiguous); bias is f32 [B, Tk] with
// row stride bias_sb.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue when an argument (or a tensor map) is refused.
extern "C" int memvul_flash_fwd(const void* q, const void* k, const void* v,
                                const void* bias, void* out, int B, int H,
                                int Tq, int Tk, int D, long long q_sb,
                                long long q_st, long long q_sh, long long k_sb,
                                long long k_st, long long k_sh, long long v_sb,
                                long long v_st, long long v_sh, long long o_sb,
                                long long o_st, long long o_sh,
                                long long bias_sb, float scale, int dtype,
                                void* stream) {
  if (B < 0 || H < 1 || Tq < 0 || Tk < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0) return (int)cudaGetLastError();
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh},
      os{o_sb, o_st, o_sh};
  const float* bp = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[4] = {q, k, v, out};
  const Strides all[4] = {qs, ks, vs, os};
  if (dtype == 1 && D == kWgDim && tensor_core_eligible(ptrs, all, 4)) {
    return wgmma_consumers(Tq) == 3
               ? launch_wgmma<3>(q, k, v, bp, out, B, H, Tq, Tk, qs, ks, vs, os, bias_sb, scale, s)
               : launch_wgmma<2>(q, k, v, bp, out, B, H, Tq, Tk, qs, ks, vs, os, bias_sb, scale, s);
  }
  if (dtype == 0)
    return dispatch_head_dim<float>(D, q, k, v, bp, out, B, H, Tq, Tk, qs, ks, vs, os, bias_sb, scale, s);
  return dispatch_head_dim<__nv_bfloat16>(D, q, k, v, bp, out, B, H, Tq, Tk, qs, ks, vs, os, bias_sb, scale, s);
}

// dynamic shared memory of the wgmma kernel's block with `consumers`
// consumer warpgroups (2 or 3), in bytes; 0 for any other count
extern "C" int memvul_flash_fwd_wgmma_smem_bytes(int consumers) {
  return consumers == 2 ? WgConfig<2>::kSmemBytes
                        : consumers == 3 ? WgConfig<3>::kSmemBytes : 0;
}
