// Device helpers shared by the port's CUDA sources: element conversions,
// the [B, T, H, Dh] stride triple, packing bf16 pairs, the shared-memory
// address, exp2 on the special-function unit, and the alignment test of
// the tensor-core paths.  Every helper is defined here once; the kernels'
// sources include this header.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace memvul {

constexpr float kF32Min = -3.402823466e38f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// p as the PV product sees it: rounded to the value dtype
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// two floats as a bf16 pair, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the special-function unit (−inf gives 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The tensor-core paths read 16-byte chunks by TMA: every base
// 16-byte aligned, every stride a nonzero multiple of 8 elements.
inline bool tensor_core_eligible(const void* const* ptrs, const Strides* strides, int n) {
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
    const Strides& s = strides[i];
    if (s.b % 8 || s.t % 8 || s.h % 8 || s.b <= 0 || s.t <= 0 || s.h <= 0) return false;
  }
  return true;
}

}  // namespace memvul
