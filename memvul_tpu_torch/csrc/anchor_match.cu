// Fused anchor-bank match for Hopper (sm_90a).
//
// Replaces the TPU kernel memvul_tpu/ops/pallas/anchor_match.py:
// fused_anchor_match (body _anchor_match_kernel).  It computes
//
//   out[b, a, c] = u[b]·Wu[:, c] + v[a]·Wv[:, c] + Σ_d |u[b, d] − v[a, d]|·Wd[d, c]
//
// for u [B, D], v [A, D] and the bias-free pair kernel W [3D, C] = [Wu; Wv; Wd],
// accumulating in f32 and writing [B, A, C] in the input dtype.
//
// What bounds it on this card: the |u − v| term is not a matrix product, so
// it runs on the CUDA cores: one FADD (the |·| is an operand modifier) and
// C FFMAs per (b, a, d), (C + 1)·B·A·D FP32 instructions, against under a
// megabyte of input.  At the main path's B = 1024 (A = 129, D = 512, C = 2)
// that is about 6 µs of the card's FP32 pipes; at the serve pack's B = 16 it
// is 0.1 µs, and the floor there is the launch and one pass over D.
//
// What the design does about it:
//
// * each thread owns a register tile of 4 reports × RA anchors (RA ≤ 4) and
//   their C sums, and reads u and v as float4s of 4 dims from shared memory,
//   staged as f32; the lanes of a warp sharing a report read one address,
//   so a warp's u and v loads are one wavefront each and each loaded value
//   serves RA or 4 pairs: the FP32 pipes, not shared memory, set the rate;
// * a block is 8 warps over one tile of 16 reports × 32 anchors; the
//   warps split D, and a cluster of up to 8 blocks splits it further, so
//   the grid fills the card at B = 16 as at B = 1024.  The partial sums are
//   reduced in a fixed order, in shared memory across the warps and then
//   through distributed shared memory across the cluster, so two runs give
//   the same bits;
// * the last anchor tile is only as wide as it must be: at A = 129 it holds
//   8 anchor lanes (RA = 1) for the one anchor left, a quarter of a full
//   tile's work;
// * the row terms u·Wu and v·Wv are reduced with the pair sums, each warp
//   taking its slice of D.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using namespace memvul;
namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRB = 4;                 // reports per thread
constexpr int kTileB = 4 * kRB;        // reports per tile: 4 lane rows
constexpr int kMaxRA = 4;              // anchors per thread
constexpr int kTileA = 8 * kMaxRA;     // anchors per full tile: 8 lane columns
constexpr int kRows = kTileB + kTileA;
constexpr int kMaxClasses = 4;
constexpr int kMaxSplit = 8;           // blocks of a cluster, each a share of D
constexpr int kBlocksPerSm = 2;        // the grid's aim when it splits D
constexpr int kMaxBlockDims = 256;     // a block's share of D at most, where D allows

// floats of one warp's partial sums: the pair sums, then the row terms
template <int RA, int C>
struct Partials {
  static constexpr int kPairs = kRB * RA * C;                        // per lane
  static constexpr int kRowTasks = (kTileB + 8 * RA) * C;           // per warp
  static constexpr int kPerLane = kPairs + (kRowTasks + 31) / 32;
  static constexpr int kWarpFloats = kPerLane * 32;
};

// dynamic shared memory of a block whose warps take `ds` dims each, in
// floats: the staged tiles, or later the warps' partial sums
template <int C>
int smem_floats(int ds) {
  const int db = kWarps * ds;
  const int staged = kRows * (db + 4) + 3 * db * C;
  const int partials = kWarps * Partials<kMaxRA, C>::kWarpFloats;
  return staged > partials ? staged : partials;
}

// four consecutive elements as f32 (f32: 16-byte aligned; bf16: 8-byte)
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}

__device__ __forceinline__ float elem(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// One tile of 16 reports × 8·RA anchors, this block's share of D.
template <typename T, int C, int RA>
__device__ __forceinline__ void match_tile(const T* __restrict__ u, const T* __restrict__ v,
                                           const T* __restrict__ w, T* __restrict__ out, int B,
                                           int A, int D, int ds, bool vec4, float* smem) {
  using P = Partials<RA, C>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank(), split = cluster.num_blocks();
  const int db = kWarps * ds;  // this block's dims, from d_block
  const int d_block = rank * db;
  const int row = db + 4;      // ≡ 4 (mod 32) floats: 8 rows meet 8 bank quads
  constexpr int kLiveRows = kTileB + 8 * RA;
  float* us = smem;                  // [16 reports][row], then [8·RA anchors][row]
  float* ws = smem + kRows * row;    // [3][db][C]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b0 = blockIdx.y * kTileB, a0 = blockIdx.z * kTileA;

  if (vec4) {  // four elements a load: D % 4 == 0 and aligned bases
#pragma unroll 4
    for (int i = tid; i < kLiveRows * db / 4; i += kThreads) {
      const int r = i / (db / 4), d = i % (db / 4) * 4, gd = d_block + d;
      const bool is_u = r < kTileB;
      const int g = is_u ? b0 + r : a0 + r - kTileB;
      const bool in = gd < D && g < (is_u ? B : A);
      *reinterpret_cast<float4*>(us + r * row + d) =
          in ? load4((is_u ? u : v) + (size_t)g * D + gd) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll 2
    for (int i = tid; i < 3 * db * C / 4; i += kThreads) {
      const int part = i / (db * C / 4), rem = i % (db * C / 4) * 4;
      const bool in = (size_t)d_block * C + rem < (size_t)D * C;
      *reinterpret_cast<float4*>(ws + 4 * i) =
          in ? load4(w + ((size_t)part * D + d_block) * C + rem) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = tid; i < kLiveRows * db; i += kThreads) {
      const int r = i / db, d = i % db, gd = d_block + d;
      const bool is_u = r < kTileB;
      const int g = is_u ? b0 + r : a0 + r - kTileB;
      const bool in = gd < D && g < (is_u ? B : A);
      us[r * row + d] = in ? to_f32((is_u ? u : v)[(size_t)g * D + gd]) : 0.f;
    }
    for (int i = tid; i < 3 * db * C; i += kThreads) {
      const int part = i / (db * C), rem = i % (db * C), gd = d_block + rem / C;
      ws[i] = gd < D ? to_f32(w[((size_t)part * D + gd) * C + rem % C]) : 0.f;
    }
  }
  __syncthreads();

  const int ly = lane / 8, lx = lane % 8;  // reports ly + 4i, anchors lx + 8j
  const int d_lo = warp * ds;
  float acc[kRB][RA][C];
#pragma unroll
  for (int i = 0; i < kRB; ++i)
#pragma unroll
    for (int j = 0; j < RA; ++j)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][j][c] = 0.f;
  const float* vs = us + kTileB * row;
  for (int d = d_lo; d < d_lo + ds; d += 4) {
    float4 uu[kRB], vv[RA], wq[C];
#pragma unroll
    for (int i = 0; i < kRB; ++i) uu[i] = *reinterpret_cast<const float4*>(us + (ly + 4 * i) * row + d);
#pragma unroll
    for (int j = 0; j < RA; ++j) vv[j] = *reinterpret_cast<const float4*>(vs + (lx + 8 * j) * row + d);
#pragma unroll
    for (int k = 0; k < C; ++k) wq[k] = reinterpret_cast<const float4*>(ws + (2 * db + d) * C)[k];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < kRB; ++i)
#pragma unroll
        for (int j = 0; j < RA; ++j) {
          const float diff = fabsf(elem(uu[i], e) - elem(vv[j], e));
#pragma unroll
          for (int c = 0; c < C; ++c)
            acc[i][j][c] = fmaf(diff, elem(wq[(e * C + c) / 4], (e * C + c) % 4), acc[i][j][c]);
        }
  }
  // the row terms of this warp's slice: task t is (row t / C, class t % C)
  float rows[P::kPerLane - P::kPairs];
#pragma unroll
  for (int k = 0; k < P::kPerLane - P::kPairs; ++k) {
    const int t = k * 32 + lane;
    float s = 0.f;
    if (t < P::kRowTasks) {
      const int r = t / C, c = t % C, part = r < kTileB ? 0 : 1;
      for (int d = d_lo; d < d_lo + ds; ++d) s = fmaf(us[r * row + d], ws[(part * db + d) * C + c], s);
    }
    rows[k] = s;
  }
  __syncthreads();  // the staged tiles are consumed: the space takes the partials

  // warp partials at [warp][k][lane], summed over the warps in order into
  // warp 0's place
  float* part = smem + warp * P::kWarpFloats + lane;
#pragma unroll
  for (int i = 0; i < kRB; ++i)
#pragma unroll
    for (int j = 0; j < RA; ++j)
#pragma unroll
      for (int c = 0; c < C; ++c) part[((i * RA + j) * C + c) * 32] = acc[i][j][c];
#pragma unroll
  for (int k = 0; k < P::kPerLane - P::kPairs; ++k) part[(P::kPairs + k) * 32] = rows[k];
  __syncthreads();
  for (int e = tid; e < P::kWarpFloats; e += kThreads) {
    float s = smem[e];
    for (int x = 1; x < kWarps; ++x) s += smem[x * P::kWarpFloats + e];
    smem[e] = s;
  }
  cluster.sync();  // every block's sums are complete and visible to the cluster

  // The cluster's sums, each in rank order: every block first sums the row
  // terms (row task t sits at pairs·32 + t) into its warp 1's place, then
  // its share of the pairs, loading every rank's partial before adding.
  float* row_terms = smem + P::kWarpFloats;
  auto cluster_sum = [&](int e) {
    float parts[kMaxSplit];
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)
      parts[r] = r < split ? cluster.map_shared_rank(smem, r)[e] : 0.f;
    float s = parts[0];
#pragma unroll
    for (int r = 1; r < kMaxSplit; ++r) s += parts[r];
    return s;
  };
  for (int t = tid; t < P::kRowTasks; t += kThreads) row_terms[t] = cluster_sum(P::kPairs * 32 + t);
  __syncthreads();
  for (int e = rank * kThreads + tid; e < P::kPairs * 32; e += split * kThreads) {
    const int k = e / 32, l = e % 32;
    const int c = k % C, j = (k / C) % RA, i = k / (C * RA);
    const int rb = l / 8 + 4 * i, ra = l % 8 + 8 * j;
    const int b = b0 + rb, a = a0 + ra;
    if (b >= B || a >= A) continue;
    const float s = cluster_sum(e) + row_terms[rb * C + c] + row_terms[(kTileB + ra) * C + c];
    out[((size_t)b * A + a) * C + c] = from_f32<T>(s);
  }
  cluster.sync();  // no block leaves while another still reads its sums
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
anchor_match_kernel(const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
                    T* __restrict__ out, int B, int A, int D, int ds, bool vec4) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // anchor lanes' registers this tile needs: 4 but in the last tile
  const int ra = min(kMaxRA, (A - (int)blockIdx.z * kTileA + 7) / 8);
  switch (ra) {
    case 4: match_tile<T, C, 4>(u, v, w, out, B, A, D, ds, vec4, smem); break;
    case 3: match_tile<T, C, 3>(u, v, w, out, B, A, D, ds, vec4, smem); break;
    case 2: match_tile<T, C, 2>(u, v, w, out, B, A, D, ds, vec4, smem); break;
    default: match_tile<T, C, 1>(u, v, w, out, B, A, D, ds, vec4, smem); break;
  }
}

// The cluster size: doubled (up to 8, while each warp keeps at least 4
// dims of D) as long as the grid has fewer than kBlocksPerSm blocks per SM
// or a block's share of D is over kMaxBlockDims (which keeps its shared
// memory near 56 KB, so three blocks share an SM).
int split_for(long long tiles, int D, int sms) {
  const int d_padded = (D + 31) / 32 * 32;
  int split = 1;
  while (split < kMaxSplit && kWarps * 4 * split * 2 <= d_padded &&
         (tiles * split < (long long)kBlocksPerSm * sms || d_padded > kMaxBlockDims * split))
    split *= 2;
  return split;
}

template <typename T, int C>
int launch_classes(const void* u, const void* v, const void* w, void* out, int B, int A, int D,
                   cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int n_b = (B + kTileB - 1) / kTileB, n_a = (A + kTileA - 1) / kTileA;
  if (n_b > 65535 || n_a > 65535) return (int)cudaErrorInvalidValue;
  const int split = split_for((long long)n_b * n_a, D, sms);
  const int per_warp = (D + kWarps * split - 1) / (kWarps * split);
  const int ds = (per_warp + 3) / 4 * 4;
  const size_t smem = (size_t)smem_floats<C>(ds) * sizeof(float);
  const bool vec4 = D % 4 == 0 && (reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(v) |
                                   reinterpret_cast<uintptr_t>(w)) % 16 == 0;
  err = cudaFuncSetAttribute(anchor_match_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, n_b, n_a);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, anchor_match_kernel<T, C>, static_cast<const T*>(u),
                                 static_cast<const T*>(v), static_cast<const T*>(w),
                                 static_cast<T*>(out), B, A, D, ds, vec4);
}

template <typename T>
int launch(const void* u, const void* v, const void* w, void* out, int B, int A, int D, int C,
           cudaStream_t stream) {
  switch (C) {
    case 1: return launch_classes<T, 1>(u, v, w, out, B, A, D, stream);
    case 2: return launch_classes<T, 2>(u, v, w, out, B, A, D, stream);
    case 3: return launch_classes<T, 3>(u, v, w, out, B, A, D, stream);
    default: return launch_classes<T, 4>(u, v, w, out, B, A, D, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  All tensors contiguous: u [B, D],
// v [A, D], w [3D, C], out [B, A, C].  Returns the launch's error, or
// cudaGetLastError() after it (cudaErrorInvalidValue for arguments the
// kernel does not take).
extern "C" int memvul_anchor_match(const void* u, const void* v, const void* w,
                                   void* out, int B, int A, int D, int C,
                                   int dtype, void* stream) {
  if (B < 0 || A < 0 || D < 1 || C < 1 || C > kMaxClasses || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = dtype == 0 ? launch<float>(u, v, w, out, B, A, D, C, s)
                             : launch<__nv_bfloat16>(u, v, w, out, B, A, D, C, s);
  return err ? err : (int)cudaGetLastError();
}

extern "C" const char* memvul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
