// K9: the Mamba2 SSD decode step, one layer of a stacked state, in place.
//
// Replaces mistral_inference_tpu/ops/pallas/ssd_step.py::fused_ssd_step_stacked
// (kernel _ssd_step_stacked_kernel) and its depth-1 wrapper fused_ssd_step.
//
// Function, per row b, head h (group g = h / (nh / ng)), state row p and
// state column d:
//
//     h'[p, d] = h[p, d] * a[b, h] + dtx[b, h, p] * B[b, g, d]
//     y[b, h, p] = sum_d h'[p, d] * C[b, g, d]
//
// a = exp(dt A) and dtx = dt x come from the caller in fp32; B and C are
// (B, ng, ds) fp32; the state is (L, B, nh, hd, ds) fp32 or bf16, and the
// caller offsets its pointer to layer li, so no layer is copied and the other
// layers are never touched. y is (B, nh, hd) fp32.
//
// Bits: h' is computed in fp32 as __fadd_rn(__fmul_rn(h, a), __fmul_rn(dtx, b)),
// so nvcc cannot contract it into an FMA: it has the bits of the plain
// h * a + dtx * b evaluated op by op. A bf16 state is widened exactly, and
// h' rounds once, at the store (__float2bfloat16_rn). A dead row (dt = 0, so
// a = 1 and dtx = 0) stores h * 1 + 0 = h, its own bits. y is summed from the
// fp32 h' in another order than the plain version's: it differs by summation
// order only.
//
// What bounds it on the H100: bytes. The state is read once and written once
// (2 x 16.8 MB at Codestral-Mamba's nh = 128, hd = 64, ds = 128 and B = 4 in
// fp32); the operands besides it are kilobytes. There is nothing for tensor
// cores, TMA or wgmma to do. Design: one block per (head, row), 128 threads;
// B's and C's group vector is the head's (indexed, not repeated per head as
// the TPU's operands are). Each warp owns state rows p = warp * kRows + ...,
// kRows rows at a time so that each lane has kRows 16-byte loads in flight;
// its lanes stream ds with four consecutive columns each (float4 for fp32,
// 8 bytes for bf16), and the warp reduces h' . C with shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mit {

constexpr int kSsdThreads = 128;
constexpr int kSsdWarps = kSsdThreads / 32;
constexpr int kSsdRows = 4;  // state rows a warp loads before it computes

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x;
  v[1] = r.y;
  v[2] = r.z;
  v[3] = r.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 lo = __bfloat1622float2(h[0]);
  const float2 hi = __bfloat1622float2(h[1]);
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 h[2];
  h[0] = __halves2bfloat162(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
  h[1] = __halves2bfloat162(__float2bfloat16_rn(v[2]), __float2bfloat16_rn(v[3]));
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kSsdThreads) ssd_step_kernel(
    const float* __restrict__ a, const float* __restrict__ dtx, const float* __restrict__ Bm,
    const float* __restrict__ Cm, T* __restrict__ state, float* __restrict__ y, int nh, int hd,
    int ds, int ng) {
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int g = head / (nh / ng);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t bh = static_cast<size_t>(b) * nh + head;
  const float av = a[bh];
  const float* Bg = Bm + (static_cast<size_t>(b) * ng + g) * ds;
  const float* Cg = Cm + (static_cast<size_t>(b) * ng + g) * ds;
  const float* xr = dtx + bh * hd;
  T* hh = state + bh * hd * ds;
  float* yr = y + bh * hd;
  const int n4 = ds / 4;

  for (int p0 = warp * kSsdRows; p0 < hd; p0 += kSsdWarps * kSsdRows) {
    float acc[kSsdRows];
    float xv[kSsdRows];
#pragma unroll
    for (int r = 0; r < kSsdRows; ++r) {
      acc[r] = 0.f;
      xv[r] = p0 + r < hd ? xr[p0 + r] : 0.f;
    }
    for (int c = lane; c < n4; c += 32) {
      float bv[4], cv[4], hv[kSsdRows][4];
      load4(Bg + 4 * c, bv);
      load4(Cg + 4 * c, cv);
#pragma unroll
      for (int r = 0; r < kSsdRows; ++r)
        if (p0 + r < hd) load4(hh + static_cast<size_t>(p0 + r) * ds + 4 * c, hv[r]);
#pragma unroll
      for (int r = 0; r < kSsdRows; ++r) {
        if (p0 + r >= hd) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hv[r][i] = __fadd_rn(__fmul_rn(hv[r][i], av), __fmul_rn(xv[r], bv[i]));
          acc[r] = __fmaf_rn(hv[r][i], cv[i], acc[r]);
        }
        store4(hh + static_cast<size_t>(p0 + r) * ds + 4 * c, hv[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kSsdRows; ++r) {
      const float s = warp_sum(acc[r]);
      if (lane == 0 && p0 + r < hd) yr[p0 + r] = s;
    }
  }
}

}  // namespace mit

// One layer's step. `state` points at layer li of the (L, B, nh, hd, ds)
// stack (the caller adds the offset); bf16_state selects its element type.
// Returns the CUDA error of the launch, cudaErrorInvalidValue for shapes the
// kernel does not take (ds % 4 != 0, ng not dividing nh, empty shapes).
extern "C" int ssd_step(const void* a, const void* dtx, const void* Bm, const void* Cm,
                        void* state, void* y, int batch, int nh, int hd, int ds, int ng,
                        int bf16_state, void* stream) {
  using namespace mit;
  if (batch < 1 || batch > 65535 || nh < 1 || hd < 1 || ds < 4 || ds % 4 || ng < 1 || nh % ng)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(nh, batch);
  const auto* ap = static_cast<const float*>(a);
  const auto* xp = static_cast<const float*>(dtx);
  const auto* bp = static_cast<const float*>(Bm);
  const auto* cp = static_cast<const float*>(Cm);
  auto* yp = static_cast<float*>(y);
  if (bf16_state)
    ssd_step_kernel<__nv_bfloat16><<<grid, kSsdThreads, 0, st>>>(
        ap, xp, bp, cp, static_cast<__nv_bfloat16*>(state), yp, nh, hd, ds, ng);
  else
    ssd_step_kernel<float><<<grid, kSsdThreads, 0, st>>>(ap, xp, bp, cp,
                                                         static_cast<float*>(state), yp, nh, hd,
                                                         ds, ng);
  return cudaGetLastError();
}
