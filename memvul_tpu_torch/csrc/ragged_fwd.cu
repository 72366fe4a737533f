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
// * ragged_fwd_mma_kernel (bf16, head dim 64, 16-byte aligned, strides a
//   nonzero multiple of 8 elements: the serve path) runs QKᵀ and PV on the
//   tensor cores with mma.sync, K/V tiles double buffered by cp.async, in
//   log2 units with exp2.  Masked scores
//   are set to the finite minimum AFTER the log2(e) scaling, so the scale
//   can never overflow them to −inf (−inf − (−inf) would be NaN); keys
//   past T get −inf and add exactly 0.
// * ragged_fwd_kernel (f32, head dims 16/32, or unaligned views) does its
//   products on the CUDA cores in f32, one thread per query row, and skips
//   a key tile when none of its ids falls in the query tile's live range.
//
// The shared device helpers are in common.cuh.  wgmma and TMA (hopper.cuh,
// as flash_fwd.cu's kernel uses them) and a varlen grid that launches only
// the visited tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

#include "common.cuh"

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

// -- tensor-core path: bf16 q/k/v with head dim 64 ---------------------------
//
// A FlashAttention-2 layout on mma.sync.m16n8k16: 4 warps own
// 64 query rows (one range-table tile), 16 per warp, Q in registers as A
// fragments; 64-key tiles of K and V land in shared memory by cp.async,
// double buffered, rows padded by 8 elements for conflict-free ldmatrix.
// The key tile's segment ids are staged beside them.  The tiles to visit
// are a bit mask in shared memory, built once from the range table with
// one ballot per 32 tiles; the pipeline walks its set bits in ascending
// order, so the next visited tile is always in flight while this one is
// multiplied.  Each thread owns two query rows and keeps their segment ids
// in registers.

constexpr int kMmaRows = 64;     // query rows per block (4 warps × 16)
constexpr int kMmaKeys = 64;     // keys per staged tile
constexpr int kMmaThreads = 128;
constexpr int kMmaDim = 64;
constexpr int kMmaPad = 8;
static_assert(kMmaRows == kTile && kMmaKeys == kTile,
              "query and key tiles are entries of the range table");

__global__ void __launch_bounds__(kMmaThreads)
ragged_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ seg,
                      const int2* __restrict__ ranges,
                      __nv_bfloat16* __restrict__ out, int H, int Tn,
                      Strides qs, Strides ks_, Strides vs_, Strides os,
                      long long seg_sb, float scale) {
  __shared__ __align__(16) __nv_bfloat16 k_tile[2][kMmaKeys][kMmaDim + kMmaPad];
  __shared__ __align__(16) __nv_bfloat16 v_tile[2][kMmaKeys][kMmaDim + kMmaPad];
  __shared__ int k_seg[2][kMmaKeys];
  __shared__ uint32_t visit[kMaxTiles / 32];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad_row = lane / 4;        // fragment row (and B-operand column)
  const int quad_col = (lane % 4) * 2;  // first of the fragment's column pair
  const int mat = lane / 8, mat_row = lane % 8;  // ldmatrix: matrix and row
  const int row0 = blockIdx.y * kMmaRows + warp * 16 + quad_row;  // and row0 + 8
  const float neg_inf = -CUDART_INF_F;
  const float scale_log2 = scale * kLog2e;
  const int* sb = seg + b * seg_sb;
  const int n_tiles = (Tn + kTile - 1) / kTile;
  const int n_words = (n_tiles + 31) / 32;
  const int2* rb = ranges + (long long)b * n_tiles;

  // the key tiles whose live range meets this query tile's
  {
    const int2 qr = rb[blockIdx.y];
    for (int w = warp; w < n_words; w += kMmaThreads / 32) {
      const int t = w * 32 + lane;
      bool hit = false;
      if (t < n_tiles) {
        const int2 kr = rb[t];
        hit = kr.x <= qr.y && qr.x <= kr.y;
      }
      const uint32_t mask = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) visit[w] = mask;
    }
  }
  // the first visited tile at or after `from`, or n_tiles
  auto next_tile = [&](int from) {
    for (int w = from >> 5; w < n_words; ++w) {
      uint32_t mask = visit[w];
      if (w == (from >> 5)) mask &= 0xffffffffu << (from & 31);
      if (mask) return w * 32 + __ffs(mask) - 1;
    }
    return n_tiles;
  };

  const int qs0 = row0 < Tn ? sb[row0] : 0;
  const int qs1 = row0 + 8 < Tn ? sb[row0 + 8] : 0;
  uint32_t qf[4][4];  // A fragments of Q, one per 16-dim step
  {
    const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
    const __nv_bfloat16* q0 = qb + (long long)min(row0, Tn - 1) * qs.t;
    const __nv_bfloat16* q1 = qb + (long long)min(row0 + 8, Tn - 1) * qs.t;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = kk * 16 + quad_col;
      qf[kk][0] = load_pair(q0 + c);
      qf[kk][1] = load_pair(q1 + c);
      qf[kk][2] = load_pair(q0 + c + 8);
      qf[kk][3] = load_pair(q1 + c + 8);
    }
  }
  float o[8][4];  // output accumulators: 8 tiles of 8 dims
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kF32Min, kF32Min}, l[2] = {0.f, 0.f};  // m in log2 units

  const __nv_bfloat16* kb = k + b * ks_.b + h * ks_.h;
  const __nv_bfloat16* vb = v + b * vs_.b + h * vs_.h;

  auto load_tile = [&](int tile, int buf) {
    const int k0 = tile * kMmaKeys;
    const int nk = min(kMmaKeys, Tn - k0);
    for (int c = threadIdx.x; c < kMmaKeys * kMmaDim / 8; c += kMmaThreads) {
      const int j = c / (kMmaDim / 8), d8 = (c % (kMmaDim / 8)) * 8;
      const bool in = j < nk;
      const long long key = in ? k0 + j : 0;
      cp_async16(&k_tile[buf][j][d8], kb + key * ks_.t + d8, in);
      cp_async16(&v_tile[buf][j][d8], vb + key * vs_.t + d8, in);
    }
    // −1 marks a key past T: its score is −inf, so it adds exactly 0
    for (int j = threadIdx.x; j < kMmaKeys; j += kMmaThreads)
      k_seg[buf][j] = j < nk ? sb[k0 + j] : -1;
  };

  __syncthreads();  // the visit mask is complete
  int cur = next_tile(0);
  if (cur < n_tiles) {
    load_tile(cur, 0);
    cp_async_commit();
  }
  for (int buf = 0; cur < n_tiles; buf ^= 1) {
    const int nxt = next_tile(cur + 1);
    if (nxt < n_tiles) {
      load_tile(nxt, buf ^ 1);  // that buffer was released at the end of the last step
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `cur` is visible to every warp

    float s[8][4];  // this warp's 16 rows × 64 keys of S, in 8 tiles of 8 keys
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {  // two 16-dim steps per ldmatrix.x4
        uint32_t kf[4];
        ldmatrix_x4(kf, &k_tile[buf][t * 8 + mat_row][(kp * 2 + mat / 2) * 16 + (mat % 2) * 8]);
        mma_16816(s[t], qf[kp * 2], kf[0], kf[1]);
        mma_16816(s[t], qf[kp * 2 + 1], kf[2], kf[3]);
      }
    }
    float mx0 = m[0], mx1 = m[1];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kseg = k_seg[buf][t * 8 + quad_col + e];
        // masked keys take the finite minimum (or −inf past T) after the
        // log2(e) scaling, never through it
        const float masked = kseg < 0 ? neg_inf : kF32Min;
        s[t][e] = kseg == qs0 && kseg > 0 ? s[t][e] * scale_log2 : masked;
        s[t][2 + e] = kseg == qs1 && kseg > 0 ? s[t][2 + e] * scale_log2 : masked;
        mx0 = fmaxf(mx0, s[t][e]);
        mx1 = fmaxf(mx1, s[t][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float corr0 = exp2f(m[0] - mx0), corr1 = exp2f(m[1] - mx1);
    m[0] = mx0;
    m[1] = mx1;
    l[0] *= corr0;
    l[1] *= corr1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[n][0] *= corr0;
      o[n][1] *= corr0;
      o[n][2] *= corr1;
      o[n][3] *= corr1;
    }
    uint32_t pf[4][4];  // A fragments of P (bf16), one per 16-key step
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float p0 = exp2f(s[t][0] - mx0), p1 = exp2f(s[t][1] - mx0);
      const float p2 = exp2f(s[t][2] - mx1), p3 = exp2f(s[t][3] - mx1);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[t / 2][(t % 2) * 2 + 0] = pack_bf16(p0, p1);
      pf[t / 2][(t % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {      // 16-key steps
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // two 8-dim tiles per ldmatrix.x4.trans
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &v_tile[buf][j * 16 + (mat % 2) * 8 + mat_row][(np * 2 + mat / 2) * 8]);
        mma_16816(o[np * 2], pf[j], vf[0], vf[1]);
        mma_16816(o[np * 2 + 1], pf[j], vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer `buf`
    cur = nxt;
  }

  // each thread summed its own columns; the quad holds the whole row.  A
  // row that visited nothing has l = 0 and writes 0 / 1e-30 = 0.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float d0 = fmaxf(l[0], 1e-30f), d1 = fmaxf(l[1], 1e-30f);
  __nv_bfloat16* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + quad_col;
    if (row0 < Tn)
      *reinterpret_cast<uint32_t*>(ob + (long long)row0 * os.t + col) =
          pack_bf16(o[n][0] / d0, o[n][1] / d0);
    if (row0 + 8 < Tn)
      *reinterpret_cast<uint32_t*>(ob + (long long)(row0 + 8) * os.t + col) =
          pack_bf16(o[n][2] / d1, o[n][3] / d1);
  }
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
  if (B < 0 || T < 0 || T > kMaxTiles * kTile) return (int)cudaErrorInvalidValue;
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
// memvul_ragged_tile_ranges filled for these ids; the tensor-core path
// reads it.  Returns cudaGetLastError() after the launch.
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
  if (dtype == 1 && D == kMmaDim && tensor_core_eligible(ptrs, all, 4)) {
    const int n_tiles = (T + kTile - 1) / kTile;
    ragged_fwd_mma_kernel<<<dim3(B * H, n_tiles), kMmaThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), sp, static_cast<const int2*>(ranges),
        static_cast<__nv_bfloat16*>(out),
        H, T, qs, ks, vs, os, seg_sb, scale);
    return (int)cudaGetLastError();
  }
  if (dtype == 0)
    return dispatch_head_dim<float>(D, q, k, v, sp, out, B, H, T, qs, ks, vs, os, seg_sb, scale, s);
  return dispatch_head_dim<__nv_bfloat16>(D, q, k, v, sp, out, B, H, T, qs, ks, vs, os, seg_sb, scale, s);
}
