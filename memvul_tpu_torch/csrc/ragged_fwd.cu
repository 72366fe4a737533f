// Segment-masked exact attention forward for Hopper (sm_90a): the packed
// (ragged) serve path.
//
// Replaces the TPU kernel memvul_tpu/ops/pallas/ragged_attention.py:
// ragged_flash_attention (host side; body _ragged_fwd_kernel).  Many
// requests are packed end to end into one [B, T] token row, and
// segment_ids [B, T] (int32) say which request each position belongs to,
// 0 marking dead padding.  Query i sees key j iff
//
//   seg[i] == seg[j] && seg[j] > 0,
//
// and each output row is
//
//   out[b, i, h] = Σ_j p_j · v[b, j, h] / max(Σ_j p_j, 1e-30),
//   p_j = exp(s_j − max_j s_j),  s_j = (q[b, i, h] · k[b, j, h]) · scale
//
// for visible keys and the finite f32 minimum for masked ones, with the
// running max starting at that minimum, the max, the denominator and the
// accumulator in f32, and p rounded to the value dtype before the PV
// product, as the TPU kernel does.  A live row's masked keys then add
// exactly 0 (exp(min − m) = 0 once a visible key has been seen, and the
// rescale wipes what they added before one), and a dead row averages what
// it saw, so every output stays finite and a dead row's value can never
// poison a live one through 0 · NaN in the next layer.
//
// What bounds it on this card.  Dense, the work is 4·B·H·T²·Dh operations
// against 4·B·T·H·Dh elements of bytes (q, k, v in, out back), so at the
// serve path's [1, 2048, 12, 64] it is bound by operations, like flash
// attention.  But only pairs inside one segment do work that counts:
// 4·H·Σ_seg lenᵢ²·Dh operations, which for a pack of 16 requests of a few
// hundred tokens is some 10x less than the dense count, and then the
// bytes bound it.  The design therefore skips whole key tiles:
//
// * tile_ranges_kernel writes, for every 64-position tile of every row,
//   the [min, max] of its live segment ids, once per pack: every layer
//   of the encoder reads the same table;
// * each query tile visits only the key tiles whose range meets its own.
//   That test is exact for any layout of ids (not only the packer's
//   ascending one, and with ids that skip values): a skipped tile holds no
//   key of any live query's segment, so all its scores would have been
//   masked.  A query tile with no live id visits nothing and writes 0.
//
// Two kernels share that contract:
//
// * ragged_fwd_wgmma_kernel (bf16, head dim 64, 16-byte aligned, strides a
//   nonzero multiple of 8 elements: the serve path) loads by TMA, runs QKᵀ
//   and PV with wgmma, a producer thread streaming the visited K/V tiles
//   through an mbarrier ring to a consumer warpgroup, with exp2.  Masked
//   scores take −2^126, a finite score the scale (log2(e)/8 at head dim 64)
//   can never overflow to −inf (−inf − (−inf) would be NaN) and whose
//   scaled value is exact, so a row that sees nothing averages uniformly;
//   keys past T get −inf and add exactly 0.  A refused tensor map is an
//   error, never a fallback.
// * ragged_fwd_kernel (f32, head dims 16/32, or unaligned views) does its
//   products on the CUDA cores in f32, one thread per query row, and skips
//   a key tile when none of its ids falls in the query tile's live range.
//
// The shared device helpers are in common.cuh, the Hopper pieces (TMA,
// mbarriers, wgmma) in hopper.cuh.

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

constexpr int kTile = 64;         // positions per entry of the range table
constexpr int kMaxTiles = 2048;   // visit-mask capacity: T ≤ 131072
constexpr int kRangeWarps = 8;    // tiles per block of tile_ranges_kernel

// ranges[b · n_tiles + t] = (min, max) of the ids > 0 in positions
// [64t, 64t + 64) of row b, or (INT_MAX, 0) when there is none.  One warp
// per tile.
__global__ void __launch_bounds__(kRangeWarps * 32)
tile_ranges_kernel(const int* __restrict__ seg, long long seg_sb, int T,
                   int n_tiles, int2* __restrict__ ranges) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.x * kRangeWarps + threadIdx.x / 32;
  if (t >= n_tiles) return;  // uniform across the warp
  const int* sb = seg + b * seg_sb;
  int lo = INT_MAX, hi = 0;
  for (int j = t * kTile + lane; j < min(T, (t + 1) * kTile); j += 32) {
    const int s = sb[j];
    if (s > 0) {
      lo = min(lo, s);
      hi = max(hi, s);
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (lane == 0) ranges[(long long)b * n_tiles + t] = make_int2(lo, hi);
}

// -- CUDA-core path: f32, head dims 16/32, unaligned views ------------------
//
// flash_fwd.cu's CUDA-core kernel's design: one block per (batch·head, 128 queries),
// one thread per query row with q and its accumulator in registers, K/V
// tiles staged in shared memory as f32 and read as broadcast float4s.  The
// key tile's segment ids are staged with it; before its K/V is loaded the
// block tests (one __syncthreads_or) whether any of them lies in the query
// tile's live range, and skips the tile if none does.

constexpr int kBlockQ = 128;
constexpr int kKeysPerStep = 16;

template <typename T, int HD>
__global__ void __launch_bounds__(kBlockQ)
ragged_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ seg,
                  T* __restrict__ out, int H, int Tn, Strides qs, Strides ks_,
                  Strides vs_, Strides os, long long seg_sb, float scale) {
  constexpr int kBlockK = 4096 / HD;  // 16 KB of f32 per staged tile
  static_assert(HD % 4 == 0, "head dim must be a multiple of 4");
  static_assert(kBlockK % kKeysPerStep == 0, "key tile must hold whole steps");
  __shared__ __align__(16) float k_tile[kBlockK][HD];
  __shared__ __align__(16) float v_tile[kBlockK][HD];
  __shared__ int s_tile[kBlockK];
  __shared__ int q_lo, q_hi;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int row = blockIdx.y * kBlockQ + threadIdx.x;
  const bool live = row < Tn;
  const int* sb = seg + b * seg_sb;
  const int qseg = live ? sb[row] : 0;

  if (threadIdx.x == 0) {
    q_lo = INT_MAX;
    q_hi = 0;
  }
  __syncthreads();
  if (qseg > 0) {
    atomicMin(&q_lo, qseg);
    atomicMax(&q_hi, qseg);
  }
  __syncthreads();
  const int lo = q_lo, hi = q_hi;  // an empty range (INT_MAX, 0) meets nothing

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

  for (int k0 = 0; k0 < Tn; k0 += kBlockK) {
    const int nk = min(kBlockK, Tn - k0);
    __syncthreads();  // the previous tile is consumed
    bool hit = false;
    for (int j = threadIdx.x; j < nk; j += kBlockQ) {
      const int s = sb[k0 + j];
      s_tile[j] = s;
      hit |= s >= lo && s <= hi;
    }
    if (!__syncthreads_or(hit)) continue;  // no key of a live query's segment
    for (int i = threadIdx.x; i < nk * HD; i += kBlockQ) {
      const int j = i / HD, d = i % HD;
      k_tile[j][d] = to_f32(kb[(long long)(k0 + j) * ks_.t + d]);
      v_tile[j][d] = to_f32(vb[(long long)(k0 + j) * vs_.t + d]);
    }
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
          const bool visible = s_tile[j] == qseg && qseg > 0;
          s[jj] = visible ? (dot0 + dot1) * scale : kF32Min;
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
//
// A block owns one 64-row query tile of one (batch, head): a consumer
// warpgroup (warps 0-3) and a producer warp (warp 4).  All five warps
// build the block's visit mask from the range table (one ballot per 32 key
// tiles; the table's loads and the rows' ids in one round trip).  A query
// tile with no live id then writes 0 and stops; otherwise one thread loads
// Q and streams the visited K/V tiles, in ascending order, by TMA through
// a ring of kRgStages stages with full and empty mbarriers, each tile's
// segment ids beside K by TMA too, so no copy waits on a register.  The
// consumer runs S = Q·Kᵀ as wgmma from shared memory (both K-major), the
// segment test and the online softmax in registers, and O += P·V as wgmma
// with P from registers and V MN-major; it issues the next tile's QKᵀ
// before this tile's PV, as flash_fwd_wgmma_kernel does, and walks the
// visit mask as the producer does to know which keys of the last tile lie
// past T.  A block is small (160 threads, about 60 KB of shared memory),
// so three run on an SM and a pack's blocks are resident at once: the time
// is the longest visit list's chain, not a queue of blocks, and the blocks
// are numbered query tile first so that one long request's tiles land on
// different SMs.  The grid is B·H·ceil(T / 64) whatever the ids, so the
// launch can be captured in a CUDA graph.

constexpr int kRgKeys = 64;      // keys per K/V tile (64 or 128)
constexpr int kRgDim = 64;       // head dim: one 128-byte swizzled row
constexpr int kRgRows = 64;      // query rows per block: one range-table tile
constexpr int kRgStages = 3;     // K/V ring depth
constexpr int kRgThreads = 160;  // a consumer warpgroup and a producer warp
// a masked raw score: a power of two, so its product with the scale is
// exact, and a row that sees no key gets p = 2^0 = 1 for every key it
// visited (a uniform average), never an exponent's rounding residue
constexpr float kMaskedRaw = -0x1p126f;
static_assert(kRgRows == kTile, "a query tile is an entry of the range table");

template <int KT>
struct RgConfig {
  static_assert(KT == 64 || KT == 128, "key tiles of 64 or 128 keys");
  static constexpr uint32_t kQBytes = kRgRows * kRgDim * 2;
  static constexpr uint32_t kTileBytes = KT * kRgDim * 2;
  // shared memory, from a 1024-byte-aligned base
  static constexpr int kSmemQ = 0;
  static constexpr int kSmemK = kSmemQ + kQBytes;
  static constexpr int kSmemV = kSmemK + kRgStages * kTileBytes;
  static constexpr int kSmemSeg = kSmemV + kRgStages * kTileBytes;
  static constexpr int kSmemVisit = kSmemSeg + kRgStages * KT * 4;
  static constexpr int kSmemBars = kSmemVisit + kMaxTiles / 32 * 4;
  // q_full, k_full[], v_full[], empty[]
  static constexpr int kSmemBytes = kSmemBars + (1 + 3 * kRgStages) * 8 + 1024;
  static constexpr int kMinBlocks = KT == 64 ? 3 : 2;
};

// S[64×KT] (+)= Q[64×16] · K[16×KT], both K-major in shared memory
template <int KT>
__device__ __forceinline__ void wgmma_qk(float (&d)[KT / 2], uint64_t desc_q, uint64_t desc_k,
                                         int accumulate) {
  if constexpr (KT == 64)
    wgmma_m64n64k16_ss(d, desc_q, desc_k, accumulate);
  else
    wgmma_m64n128k16_ss(d, desc_q, desc_k, accumulate);
}

template <int KT>
__global__ void __launch_bounds__(kRgThreads, RgConfig<KT>::kMinBlocks)
ragged_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap seg_map,
                        const int* __restrict__ seg, const int2* __restrict__ ranges,
                        __nv_bfloat16* __restrict__ out, int B, int H, int Tn, int n_qtiles,
                        Strides os, long long seg_sb, float scale_log2) {
  using C = RgConfig<KT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + C::kSmemQ);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + C::kSmemK);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + C::kSmemV);
  int* seg_s = reinterpret_cast<int*>(smem + C::kSmemSeg);
  uint32_t* visit = reinterpret_cast<uint32_t*>(smem + C::kSmemVisit);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kSmemBars);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kRgStages;
  uint64_t* empty = v_full + kRgStages;

  // block i takes query tile i / (B·H) of row b, head h: the blocks of one
  // query tile (whose visit lists are alike) are spread over the SMs, not
  // the tiles of one long request gathered on a few
  const int qtile = blockIdx.x / (B * H), b = blockIdx.x % (B * H) / H, h = blockIdx.x % H;
  // the warp index through a shuffle, so the compiler knows it is uniform
  // and keeps the wgmma descriptors in uniform registers
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int* sb = seg + b * seg_sb;
  const int n_rtiles = (Tn + kTile - 1) / kTile;  // entries of the range table
  const int n_ktiles = (Tn + KT - 1) / KT;
  const int n_words = (n_ktiles + 31) / 32;
  const int2* rb = ranges + (long long)b * n_rtiles;
  // One round trip of loads before the rest: this tile's live range, every
  // range the visit mask tests against it, and a consumer thread's rows'
  // ids.
  const int2 qr = rb[qtile];  // (INT_MAX, 0) when the tile has no live id
  const int quad_row = lane / 4;        // accumulator row (and row + 8)
  const int quad_col = (lane % 4) * 2;  // first of each 8-column chunk's pair
  const int row0 = qtile * kRgRows + (warp % 4) * 16 + quad_row;
  int qv0 = row0 < Tn ? sb[row0] : 0, qv1 = row0 + 8 < Tn ? sb[row0 + 8] : 0;  // used late
  // key tile u is visited iff the live range of one of its range-table
  // tiles meets this query tile's; an empty range meets nothing
  for (int w = warp; w < n_words; w += kRgThreads / 32) {
    const int u = w * 32 + lane;
    bool hit = false;
    for (int r = u * (KT / kTile); u < n_ktiles && r < min((u + 1) * (KT / kTile), n_rtiles); ++r) {
      const int2 kr = rb[r];
      hit |= kr.x <= qr.y && qr.x <= kr.y;
    }
    const uint32_t mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) visit[w] = mask;
  }
  if (qr.x > qr.y) {  // no live id in this query tile: it writes 0, 16 bytes a thread
    __nv_bfloat16* ob = out + b * os.b + h * os.h;
    for (int i = threadIdx.x; i < kRgRows * kRgDim / 8; i += kRgThreads) {
      const int r = qtile * kRgRows + i / (kRgDim / 8);
      if (r < Tn) *reinterpret_cast<uint4*>(ob + (long long)r * os.t + i % (kRgDim / 8) * 8) = uint4{};
    }
    return;
  }
  if (threadIdx.x == 128) {
    tma_prefetch_map(&q_map);
    tma_prefetch_map(&k_map);
    tma_prefetch_map(&v_map);
    tma_prefetch_map(&seg_map);
    mbar_init(q_full, 1);
    for (int s = 0; s < kRgStages; ++s) {
      mbar_init(&k_full[s], 1);   // K's and the ids' bytes
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 4);    // one arrival per consumer warp
    }
    mbar_fence_init();
    mbar_arrive_expect_tx(q_full, C::kQBytes);
    tma_load_4d(q_s, &q_map, q_full, 0, qtile * kRgRows, h, b);
  }
  __syncthreads();  // the barriers are initialised and the visit mask complete

  if (warp == 4) {
    // -- producer: one thread issues every copy ---------------------------------
    if (lane != 0) return;
    int it = 0;
    for (int w = 0; w < n_words; ++w) {
      for (uint32_t mask = visit[w]; mask; mask &= mask - 1, ++it) {
        const int k0 = (w * 32 + __ffs(mask) - 1) * KT;
        const int s = it % kRgStages;
        mbar_wait(&empty[s], ((it / kRgStages) & 1) ^ 1);  // a first use passes at once
        mbar_arrive_expect_tx(&k_full[s], C::kTileBytes + KT * 4);
        tma_load_4d(k_s + s * KT * kRgDim, &k_map, &k_full[s], 0, k0, h, b);
        tma_load_2d(seg_s + s * KT, &seg_map, &k_full[s], b * seg_sb + k0, 0);
        mbar_arrive_expect_tx(&v_full[s], C::kTileBytes);
        tma_load_4d(v_s + s * KT * kRgDim, &v_map, &v_full[s], 0, k0, h, b);
      }
    }
    return;
  }

  // -- consumer ----------------------------------------------------------------
  __nv_bfloat16* ob = out + b * os.b + h * os.h;
  int n_tiles = 0;  // at least the query tile's own
  for (int w = 0; w < n_words; ++w) n_tiles += __popc(visit[w]);
  // the first key of each visited tile, in the producer's order
  int visit_word = 0;
  uint32_t visit_left = visit[0];
  auto next_k0 = [&] {
    while (!visit_left) visit_left = visit[++visit_word];
    const int k0 = (visit_word * 32 + __ffs(visit_left) - 1) * KT;
    visit_left &= visit_left - 1;
    return k0;
  };
  // a row's id, or INT_MIN for a dead row (or one past T): no staged id
  // (≥ 0) equals it, so a dead row sees nothing
  qv0 = qv0 > 0 ? qv0 : INT_MIN;
  qv1 = qv1 > 0 ? qv1 : INT_MIN;

  float o[32];              // O: 8 chunks of 8 dims, m16n8 fragments
  float m0 = kMaskedRaw, m1 = kMaskedRaw, l0 = 0.f, l1 = 0.f;  // m over raw scores
  float sc[KT / 2];         // S: this warp's 16 rows × KT keys, chunks of 8 keys
  uint32_t pf[KT / 16][4];  // P of the tile in PV: bf16 A fragments, one per 16 keys
  float corr0, corr1;
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  const WgmmaFlags flags;
  // K-major Q and K: 8-row groups 1024 bytes apart, 32 bytes per 16 dims
  uint64_t qd[kRgDim / 16], kd[kRgDim / 16];
  {
    const uint64_t q_desc = wgmma_desc_sw128(q_s, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < kRgDim / 16; ++kk) qd[kk] = wgmma_desc_advance(q_desc, kk * 32);
  }
  auto k_descs = [&](int it) {
    const uint64_t k_desc = wgmma_desc_sw128(k_s + (it % kRgStages) * KT * kRgDim, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < kRgDim / 16; ++kk) kd[kk] = wgmma_desc_advance(k_desc, kk * 32);
  };
  auto issue_qk = [&] {
#pragma unroll
    for (int kk = 0; kk < kRgDim / 16; ++kk)
      wgmma_qk<KT>(sc, qd[kk], kd[kk], kk ? flags.on : flags.off);
    wgmma_commit();
  };
  // The online-softmax step of tile `it` on S, in place.  The segment test
  // and the running max work on raw scores q·k: a visible key keeps its
  // score; a masked key takes kMaskedRaw, finite after the scaling by
  // log2(e)/8 (head dim 64), so no −inf − (−inf) can arise, and 0 beside
  // any visible key; a key past T (only in the last tile; its staged id is
  // another row's, or 0) takes −inf and adds exactly 0.  p = 2^(s·c − m·c)
  // with c = scale·log2(e) is one FFMA and one exp2 a score.  Updates m and
  // l, sets the rescale of O and leaves p in S.
  auto softmax = [&](int it) {
    const int* ss = seg_s + (it % kRgStages) * KT;
    const int k0 = next_k0();
    const bool partial = k0 + KT > Tn;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < KT / 8; ++i) {
      const int2 ks = *reinterpret_cast<const int2*>(ss + i * 8 + quad_col);
      float s0 = ks.x == qv0 ? sc[4 * i + 0] : kMaskedRaw;
      float s1 = ks.y == qv0 ? sc[4 * i + 1] : kMaskedRaw;
      float s2 = ks.x == qv1 ? sc[4 * i + 2] : kMaskedRaw;
      float s3 = ks.y == qv1 ? sc[4 * i + 3] : kMaskedRaw;
      if (partial) {
        const int key = k0 + i * 8 + quad_col;
        if (key >= Tn) s0 = s2 = -CUDART_INF_F;
        if (key + 1 >= Tn) s1 = s3 = -CUDART_INF_F;
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
    corr0 = exp2_approx((m0 - mx0) * scale_log2);
    corr1 = exp2_approx((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    l0 *= corr0;
    l1 *= corr1;
    const float top0 = mx0 * scale_log2, top1 = mx1 * scale_log2;
#pragma unroll
    for (int i = 0; i < KT / 8; ++i) {
      sc[4 * i + 0] = exp2_approx(fmaf(sc[4 * i + 0], scale_log2, -top0));
      sc[4 * i + 1] = exp2_approx(fmaf(sc[4 * i + 1], scale_log2, -top0));
      sc[4 * i + 2] = exp2_approx(fmaf(sc[4 * i + 2], scale_log2, -top1));
      sc[4 * i + 3] = exp2_approx(fmaf(sc[4 * i + 3], scale_log2, -top1));
      l0 += sc[4 * i + 0] + sc[4 * i + 1];
      l1 += sc[4 * i + 2] + sc[4 * i + 3];
    }
  };
  // P rounded to bf16 as A fragments of m64n64k16, one per 16 keys
  auto pack_p = [&] {
#pragma unroll
    for (int i = 0; i < KT / 8; ++i) {
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
  uint64_t vd[KT / 16];
  auto v_descs = [&](int it) {
    const uint64_t v_desc = wgmma_desc_sw128(v_s + (it % kRgStages) * KT * kRgDim, 16, 1024);
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) vd[j] = wgmma_desc_advance(v_desc, j * 16 * 128);
  };
  auto issue_pv = [&] {
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) wgmma_m64n64k16_rs(o, pf[j], vd[j], flags.on);
    wgmma_commit();
  };
  // S, P and O as ordinary instructions left them, before a batch's fence
  auto pin_inputs = [&] {
    fence_regs(sc);
    fence_regs(o);
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) fence_regs(pf[j]);
  };
  auto wait_k = [&](int it) { mbar_wait(&k_full[it % kRgStages], (it / kRgStages) & 1); };
  auto wait_v = [&](int it) { mbar_wait(&v_full[it % kRgStages], (it / kRgStages) & 1); };
  auto release = [&](int it) {
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(&empty[it % kRgStages]);  // this warp is done with the stage
  };

  // The pipeline of flash_fwd_wgmma_kernel: QKᵀ of tile it + 1 is issued
  // just before PV of tile it, and the next softmax runs while PV is on the
  // tensor cores; P is packed only once PV has landed.
  mbar_wait(q_full, 0);
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

  // each thread summed its own columns; the quad holds the whole row.  A
  // dead row averaged what it saw, so it is finite too.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n8 = 0; n8 < 8; ++n8) {
    const int col = n8 * 8 + quad_col;
    if (row0 < Tn)
      *reinterpret_cast<uint32_t*>(ob + (long long)row0 * os.t + col) =
          pack_bf16(o[4 * n8 + 0] * inv0, o[4 * n8 + 1] * inv0);
    if (row0 + 8 < Tn)
      *reinterpret_cast<uint32_t*>(ob + (long long)(row0 + 8) * os.t + col) =
          pack_bf16(o[4 * n8 + 2] * inv1, o[4 * n8 + 3] * inv1);
  }
}

int launch_wgmma(const void* q, const void* k, const void* v, const int* seg, const int2* ranges,
                 void* out, int B, int H, int Tn, Strides qs, Strides ks, Strides vs, Strides os,
                 long long seg_sb, float scale, cudaStream_t stream) {
  using C = RgConfig<kRgKeys>;
  CUtensorMap q_map, k_map, v_map, seg_map;
  if (!encode_bf16_rows(&q_map, q, B, Tn, H, qs, kRgRows) ||
      !encode_bf16_rows(&k_map, k, B, Tn, H, ks, kRgKeys) ||
      !encode_bf16_rows(&v_map, v, B, Tn, H, vs, kRgKeys) ||
      !encode_i32_run(&seg_map, seg, (B - 1) * seg_sb + Tn, kRgKeys))
    return (int)cudaErrorInvalidValue;
  const int n_qtiles = (Tn + kRgRows - 1) / kRgRows;
  const long long blocks = (long long)n_qtiles * B * H;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      ragged_fwd_wgmma_kernel<kRgKeys>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  ragged_fwd_wgmma_kernel<kRgKeys><<<(int)blocks, kRgThreads, C::kSmemBytes, stream>>>(
      q_map, k_map, v_map, seg_map, seg, ranges, static_cast<__nv_bfloat16*>(out), B, H, Tn,
      n_qtiles, os,
      seg_sb, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, const int* seg,
            void* out, int B, int H, int Tn, Strides qs, Strides ks,
            Strides vs, Strides os, long long seg_sb, float scale,
            cudaStream_t stream) {
  const dim3 grid(B * H, (Tn + kBlockQ - 1) / kBlockQ);
  ragged_fwd_kernel<T, HD><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, static_cast<T*>(out), H, Tn, qs, ks, vs,
      os, seg_sb, scale);
}

template <typename T>
int dispatch_head_dim(int D, const void* q, const void* k, const void* v,
                      const int* seg, void* out, int B, int H, int Tn,
                      Strides qs, Strides ks, Strides vs, Strides os,
                      long long seg_sb, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: launch<T, 16>(q, k, v, seg, out, B, H, Tn, qs, ks, vs, os, seg_sb, scale, stream); break;
    case 32: launch<T, 32>(q, k, v, seg, out, B, H, Tn, qs, ks, vs, os, seg_sb, scale, stream); break;
    case 64: launch<T, 64>(q, k, v, seg, out, B, H, Tn, qs, ks, vs, os, seg_sb, scale, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Fills `ranges`, int32 [B, ceil(T / 64), 2], with the live-id range of
// every 64-position tile of the int32 segment ids [B, T] (row stride
// seg_sb).  One table serves every layer of a pack.  Returns
// cudaGetLastError() after the launch.
extern "C" int memvul_ragged_tile_ranges(const void* seg, void* ranges, int B, int T,
                                         long long seg_sb, void* stream) {
  if (B < 0 || T < 0 || T > kMaxTiles * kTile || B > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return (int)cudaGetLastError();
  const int n_tiles = (T + kTile - 1) / kTile;
  tile_ranges_kernel<<<dim3((n_tiles + kRangeWarps - 1) / kRangeWarps, B), kRangeWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seg), seg_sb, T, n_tiles, static_cast<int2*>(ranges));
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, for the
// [B, T, H, Dh] layout (the last dim contiguous); segment ids are int32
// [B, T] with row stride seg_sb.  `ranges` is the table that
// memvul_ragged_tile_ranges filled for these ids; the wgmma path reads it.
// Returns cudaGetLastError() after the launch.
extern "C" int memvul_ragged_fwd(const void* q, const void* k, const void* v,
                                 const void* seg, const void* ranges, void* out,
                                 int B, int H, int T, int D, long long q_sb,
                                 long long q_st, long long q_sh, long long k_sb,
                                 long long k_st, long long k_sh, long long v_sb,
                                 long long v_st, long long v_sh, long long o_sb,
                                 long long o_st, long long o_sh,
                                 long long seg_sb, float scale, int dtype,
                                 void* stream) {
  if (B < 0 || H < 1 || T < 0 || T > kMaxTiles * kTile || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return (int)cudaGetLastError();
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh},
      os{o_sb, o_st, o_sh};
  const int* sp = static_cast<const int*>(seg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[4] = {q, k, v, out};
  const Strides all[4] = {qs, ks, vs, os};
  if (dtype == 1 && D == kRgDim && tensor_core_eligible(ptrs, all, 4))
    return launch_wgmma(q, k, v, sp, static_cast<const int2*>(ranges), out, B, H, T, qs, ks, vs,
                        os, seg_sb, scale, s);
  if (dtype == 0)
    return dispatch_head_dim<float>(D, q, k, v, sp, out, B, H, T, qs, ks, vs, os, seg_sb, scale, s);
  return dispatch_head_dim<__nv_bfloat16>(D, q, k, v, sp, out, B, H, T, qs, ks, vs, os, seg_sb, scale, s);
}
