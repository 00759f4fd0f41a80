// Helpers shared by the kernels: exact integer-to-float and e4m3-to-float
// conversion, warp reductions, the tensor-core fragment helpers
// (mma.sync m16n8k16, ldmatrix, staging into bf16 shared memory) and
// asynchronous copies into shared memory. Device code only; no PyTorch
// headers, so each kernel source builds with nvcc alone into a library with a
// C interface.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace mit {

// Finite "minus infinity": a fully-masked row keeps m = kNegInf and l = 0
// and never produces a NaN (the convention merge_attention_parts relies on).
constexpr float kNegInf = -1e30f;
constexpr int kHeadDim = 128;

// Two e4m3 values, packed low byte first -> fp32, through Hopper's paired
// convert to f16 (cvt.rn.f16x2.e4m3x2). Every e4m3 value is exact in f16 and
// in fp32, so the conversion is exact.
__device__ __forceinline__ float2 e4m3x2_to_float2(uint32_t two) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two & 0xFFFFu), __NV_E4M3);
  return __half22float2(__half2(h));
}

// Eight e4m3 values in the two words of raw -> fp32.
__device__ __forceinline__ void e4m3x8_to_float(uint2 raw, float* out) {
  const float2 a = e4m3x2_to_float2(raw.x), b = e4m3x2_to_float2(raw.x >> 16);
  const float2 c = e4m3x2_to_float2(raw.y), d = e4m3x2_to_float2(raw.y >> 16);
  out[0] = a.x, out[1] = a.y, out[2] = b.x, out[3] = b.y;
  out[4] = c.x, out[5] = c.y, out[6] = d.x, out[7] = d.y;
}

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

// Four integers held in the bytes of u, each offset by `bias` (u = v + bias in
// [0, 255]) -> fp32, exactly, without the slow integer-to-float unit: the byte
// becomes the low mantissa bits of 2^23 as an fp32, and (2^23 + u) - (2^23 +
// bias) = v. For int8 bytes u = w ^ 0x80808080 with bias 128; for nibbles n
// held one per byte, u = n ^ 0x08080808 with bias 8, which sign-extends them
// ((n ^ 8) - 8 is (v << 28) >> 28 of a low nibble and v >> 4 of a high one).
__device__ __forceinline__ void biased_bytes_to_float(uint32_t u, float bias, float* f) {
  const float magic = 8388608.f + bias;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - magic;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - magic;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - magic;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - magic;
}

// ---- tensor cores: mma.sync m16n8k16, bf16 in, fp32 accumulate ----

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Eight consecutive bf16 -> shared memory (16 bytes).
__device__ __forceinline__ void stage8(const __nv_bfloat16* src, __nv_bfloat16* dst) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

// ---- asynchronous copies, global -> shared, 16 bytes (both 16-byte aligned) ----

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src));
}

// The copies started since the last commit become one group; a wait returns
// when all but the newest kPending groups of this thread have landed.
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Raise a kernel's dynamic shared-memory limit to `bytes`, once per device
// (`done`: the caller's mask of devices already set, one per kernel), not
// by a cudaFuncSetAttribute call on each of a generate()'s many launches.
inline cudaError_t smem_limit_once(const void* kern, int bytes, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// The number of SMs of the current device (cached per device).
inline cudaError_t sm_count(int* n) {
  static std::atomic<int> counts[32];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && counts[dev].load() > 0) {
    *n = counts[dev].load();
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 32) counts[dev].store(*n);
  return err;
}

}  // namespace mit
