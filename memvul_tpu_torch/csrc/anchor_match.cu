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
// it runs as an FMA reduction on the CUDA cores: about 4·B·A·D operations
// against under a megabyte of input.  At the main path's shapes (B up to
// 1024, A = 129, D = 512) that is the non-tensor f32 rate, never the memory.
//
// What the design does about it: one block owns a 32×32 tile of (b, a)
// pairs and walks D in chunks of 64 staged in shared memory as f32, so each
// u, v and weight element is read from device memory once per block and
// the [B, A, D] abs-diff lives only in registers.  Each thread owns four
// (b, a) pairs and keeps their C sums in registers.  The row terms u·Wu and
// v·Wv are computed once per row of the tile, not once per pair.  The v tile
// is padded by one column so the 32 lanes of a warp (32 anchors) hit 32
// different banks; u and the weights are broadcast reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using namespace memvul;

constexpr int kTileB = 32;
constexpr int kTileA = 32;
constexpr int kTileD = 64;
constexpr int kThreads = 256;
constexpr int kRowStep = kThreads / kTileA;       // 8
constexpr int kRowsPerThread = kTileB / kRowStep;  // 4
constexpr int kMaxClasses = 4;

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
anchor_match_kernel(const T* __restrict__ u, const T* __restrict__ v,
                    const T* __restrict__ w, T* __restrict__ out,
                    int B, int A, int D) {
  __shared__ float us[kTileB][kTileD + 1];
  __shared__ float vs[kTileA][kTileD + 1];
  __shared__ float ws[3][C][kTileD];
  __shared__ float term_u[kTileB][C];
  __shared__ float term_v[kTileA][C];

  const int tid = threadIdx.x;
  const int tx = tid % kTileA;  // anchor within the tile (one per lane)
  const int ty = tid / kTileA;  // first report row of this thread
  const int b0 = blockIdx.x * kTileB;
  const int a0 = blockIdx.y * kTileA;

  float acc[kRowsPerThread][C];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;

  // row terms: threads [0, 32·C) own one (row, class) of u·Wu, threads
  // [128, 128 + 32·C) one of v·Wv
  const bool owns_u_term = tid < kTileB * C;
  const bool owns_v_term = tid >= 128 && tid < 128 + kTileA * C;
  const int term_row = owns_u_term ? tid / C : (tid - 128) / C;
  const int term_c = owns_u_term ? tid % C : (tid - 128) % C;
  float row_acc = 0.f;

  for (int d0 = 0; d0 < D; d0 += kTileD) {
    for (int i = tid; i < kTileB * kTileD; i += kThreads) {
      const int r = i / kTileD, d = i % kTileD;
      const int gb = b0 + r, gd = d0 + d;
      us[r][d] = (gb < B && gd < D) ? to_f32(u[(size_t)gb * D + gd]) : 0.f;
    }
    for (int i = tid; i < kTileA * kTileD; i += kThreads) {
      const int r = i / kTileD, d = i % kTileD;
      const int ga = a0 + r, gd = d0 + d;
      vs[r][d] = (ga < A && gd < D) ? to_f32(v[(size_t)ga * D + gd]) : 0.f;
    }
    for (int i = tid; i < 3 * C * kTileD; i += kThreads) {
      const int part = i / (C * kTileD);
      const int c = (i / kTileD) % C;
      const int d = i % kTileD;
      const int gd = d0 + d;
      ws[part][c][d] = gd < D ? to_f32(w[((size_t)part * D + gd) * C + c]) : 0.f;
    }
    __syncthreads();

#pragma unroll 8
    for (int d = 0; d < kTileD; ++d) {
      const float vv = vs[tx][d];
      float wd[C];
#pragma unroll
      for (int c = 0; c < C; ++c) wd[c] = ws[2][c][d];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float diff = fabsf(us[ty + r * kRowStep][d] - vv);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = fmaf(diff, wd[c], acc[r][c]);
      }
    }
    if (owns_u_term) {
#pragma unroll 8
      for (int d = 0; d < kTileD; ++d)
        row_acc = fmaf(us[term_row][d], ws[0][term_c][d], row_acc);
    } else if (owns_v_term) {
#pragma unroll 8
      for (int d = 0; d < kTileD; ++d)
        row_acc = fmaf(vs[term_row][d], ws[1][term_c][d], row_acc);
    }
    __syncthreads();
  }

  if (owns_u_term) term_u[term_row][term_c] = row_acc;
  if (owns_v_term) term_v[term_row][term_c] = row_acc;
  __syncthreads();

  const int a = a0 + tx;
  if (a >= A) return;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = ty + r * kRowStep;
    const int b = b0 + row;
    if (b >= B) continue;
    T* dst = out + ((size_t)b * A + a) * C;
#pragma unroll
    for (int c = 0; c < C; ++c)
      dst[c] = from_f32<T>(acc[r][c] + term_u[row][c] + term_v[tx][c]);
  }
}

template <typename T>
void launch(const void* u, const void* v, const void* w, void* out, int B,
            int A, int D, int C, cudaStream_t stream) {
  const dim3 grid((B + kTileB - 1) / kTileB, (A + kTileA - 1) / kTileA);
  const T* up = static_cast<const T*>(u);
  const T* vp = static_cast<const T*>(v);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  switch (C) {
    case 1: anchor_match_kernel<T, 1><<<grid, kThreads, 0, stream>>>(up, vp, wp, op, B, A, D); break;
    case 2: anchor_match_kernel<T, 2><<<grid, kThreads, 0, stream>>>(up, vp, wp, op, B, A, D); break;
    case 3: anchor_match_kernel<T, 3><<<grid, kThreads, 0, stream>>>(up, vp, wp, op, B, A, D); break;
    default: anchor_match_kernel<T, 4><<<grid, kThreads, 0, stream>>>(up, vp, wp, op, B, A, D); break;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  All tensors contiguous: u [B, D],
// v [A, D], w [3D, C], out [B, A, C].  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int memvul_anchor_match(const void* u, const void* v, const void* w,
                                   void* out, int B, int A, int D, int C,
                                   int dtype, void* stream) {
  if (B < 0 || A < 0 || D < 1 || C < 1 || C > kMaxClasses || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(u, v, w, out, B, A, D, C, s);
  else
    launch<__nv_bfloat16>(u, v, w, out, B, A, D, C, s);
  return (int)cudaGetLastError();
}

extern "C" const char* memvul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
