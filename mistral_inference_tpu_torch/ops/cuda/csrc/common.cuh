// Helpers shared by the attention kernels: element loads, bf16 rounding,
// warp and block reductions. Device code only; no PyTorch headers, so each
// kernel source builds with nvcc alone into a library with a C interface.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mit {

// Finite "minus infinity": a fully-masked row keeps m = kNegInf and l = 0
// and never produces a NaN (the convention merge_attention_parts relies on).
constexpr float kNegInf = -1e30f;
constexpr int kHeadDim = 128;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Eight consecutive elements -> fp32. The pointer is 16-byte aligned for
// bf16 and 8-byte aligned for int8 (rows are whole 128-element heads).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(c[i]);
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

// Reductions over `width` consecutive lanes (a power of two <= 32).
__device__ __forceinline__ float group_max(float x, int width) {
  for (int off = width / 2; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, width));
  return x;
}

__device__ __forceinline__ float group_sum(float x, int width) {
  for (int off = width / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off, width);
  return x;
}

}  // namespace mit
