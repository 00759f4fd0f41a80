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
// fp32, 2 x 8.4 MB in bf16); the operands besides it are kilobytes. There is
// nothing for tensor cores, TMA or wgmma to do. What the design does about
// it is to keep many of those bytes in flight: one block per (head, row), 128
// threads, 512 blocks at that shape, all resident on the 132 SMs (four an
// SM). The head's state is a row-major run of 16-byte pieces (four fp32 or
// eight bf16 columns); thread t takes pieces t, t + 128, ... and issues the
// loads of a round of its pieces before the round's first store: all 8 of
// its bf16 pieces (128 bytes, the head's 16 KB in flight a block), 4 fp32
// pieces a round (64 bytes). More fp32 pieces a round were faster only
// after a flush that leaves L2 dirty and slower in the decode step, which
// finds L2 clean. A thread's pieces are the same columns
// of every row it holds, so B's and C's values are loaded once; the ds / 4
// (fp32) or ds / 8 (bf16) threads that share a row reduce h' . C with
// shuffles, every row's sum at once. B's and C's group vector is the
// head's (indexed, not repeated per head as the TPU's operands are). A shape
// whose row is not a power-of-two number of pieces up to 32 (ds = 12, say;
// for a bf16 state any ds that is not a multiple of 8) takes a plain loop: a
// thread per state row, four columns at a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mit {

constexpr int kSsdThreads = 128;

// kCols consecutive state elements <-> fp32 (one 16-byte piece, or 8 bytes
// for four bf16).
__device__ __forceinline__ void load_piece(const float* p, float* v) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
}

__device__ __forceinline__ void bf16_words(const uint32_t* w, int n, float* v) {
  for (int i = 0; i < n; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

template <int kCols>
__device__ __forceinline__ void load_piece(const __nv_bfloat16* p, float* v) {
  if (kCols == 8) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
    bf16_words(w, 4, v);
  } else {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {r.x, r.y};
    bf16_words(w, 2, v);
  }
}

template <int kCols>
__device__ __forceinline__ void load_piece(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < kCols; i += 4) load_piece(p + i, v + i);
}

template <int kCols>
__device__ __forceinline__ void store_piece(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < kCols; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __halves2bfloat162(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int kCols>
__device__ __forceinline__ void store_piece(__nv_bfloat16* p, const float* v) {
  if (kCols == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                                              bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
}

// h' of kCols elements, op by op (no contraction), and their dot with C.
template <int kCols>
__device__ __forceinline__ float update(float* h, float av, float xv, const float* bv,
                                        const float* cv) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    h[i] = __fadd_rn(__fmul_rn(h[i], av), __fmul_rn(xv, bv[i]));
    acc = __fmaf_rn(h[i], cv[i], acc);
  }
  return acc;
}

// The head's state in pieces of kCols columns, R = ds / kCols pieces a row (a
// power of two up to 32, so thread t holds piece t % R of every row it
// takes); kLoads pieces a thread in flight at once.
template <typename T, int kCols, int kLoads>
__global__ void __launch_bounds__(kSsdThreads, 4) ssd_step_kernel(
    const float* __restrict__ a, const float* __restrict__ dtx, const float* __restrict__ Bm,
    const float* __restrict__ Cm, T* __restrict__ state, float* __restrict__ y, int nh, int hd,
    int ds, int ng) {
  const int head = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int g = head / (nh / ng);
  const size_t bh = static_cast<size_t>(b) * nh + head;
  const int R = ds / kCols, pieces = hd * R, c = tid & (R - 1);
  const int lr = __ffs(R) - 1;  // p / R = p >> lr
  const float av = a[bh];
  const float* xr = dtx + bh * hd;
  T* hh = state + bh * hd * ds;
  float* yr = y + bh * hd;
  float bv[kCols], cv[kCols];
  load_piece<kCols>(Bm + (static_cast<size_t>(b) * ng + g) * ds + c * kCols, bv);
  load_piece<kCols>(Cm + (static_cast<size_t>(b) * ng + g) * ds + c * kCols, cv);

  // Every thread runs every round, so that all lanes take part in the shuffles.
  for (int base = tid; base - tid < pieces; base += kSsdThreads * kLoads) {
    float hv[kLoads][kCols], xv[kLoads], dot[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int p = base + i * kSsdThreads;
      if (p < pieces) {
        load_piece<kCols>(hh + static_cast<size_t>(p) * kCols, hv[i]);
        xv[i] = xr[p >> lr];
      }
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int p = base + i * kSsdThreads;
      dot[i] = 0.f;
      if (p < pieces) {
        dot[i] = update<kCols>(hv[i], av, xv[i], bv, cv);
        store_piece<kCols>(hh + static_cast<size_t>(p) * kCols, hv[i]);
      }
    }
    // h' . C over the R threads of each row, every row's sum at once.
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      if (off < R) {
#pragma unroll
        for (int i = 0; i < kLoads; ++i) dot[i] += __shfl_xor_sync(0xffffffffu, dot[i], off);
      }
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int p = base + i * kSsdThreads;
      if (c == 0 && p < pieces) yr[p >> lr] = dot[i];
    }
  }
}

// Any ds % 4 == 0: a thread per state row, four columns at a time.
template <typename T>
__global__ void __launch_bounds__(kSsdThreads) ssd_step_rows_kernel(
    const float* __restrict__ a, const float* __restrict__ dtx, const float* __restrict__ Bm,
    const float* __restrict__ Cm, T* __restrict__ state, float* __restrict__ y, int nh, int hd,
    int ds, int ng) {
  const int head = blockIdx.x, b = blockIdx.y;
  const int g = head / (nh / ng);
  const size_t bh = static_cast<size_t>(b) * nh + head;
  const float av = a[bh];
  const float* Bg = Bm + (static_cast<size_t>(b) * ng + g) * ds;
  const float* Cg = Cm + (static_cast<size_t>(b) * ng + g) * ds;
  for (int p = threadIdx.x; p < hd; p += kSsdThreads) {
    T* row = state + (bh * hd + p) * ds;
    const float xv = dtx[bh * hd + p];
    float acc = 0.f;
    for (int d = 0; d < ds; d += 4) {
      float hv[4], bv[4], cv[4];
      load_piece<4>(row + d, hv);
      load_piece<4>(Bg + d, bv);
      load_piece<4>(Cg + d, cv);
      acc += update<4>(hv, av, xv, bv, cv);
      store_piece<4>(row + d, hv);
    }
    y[bh * hd + p] = acc;
  }
}

}  // namespace mit

// Whether a row of ds columns is a power-of-two number of kCols pieces, up to
// 32: the shapes the piece kernel takes.
static bool pow2_pieces(int ds, int cols) {
  const int r = ds / cols;
  return r >= 1 && r <= 32 && (r & (r - 1)) == 0;
}

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
  auto* hf = static_cast<float*>(state);
  auto* hb = static_cast<__nv_bfloat16*>(state);
  if (!bf16_state) {
    if (pow2_pieces(ds, 4))
      ssd_step_kernel<float, 4, 4><<<grid, kSsdThreads, 0, st>>>(ap, xp, bp, cp, hf, yp, nh, hd,
                                                                  ds, ng);
    else
      ssd_step_rows_kernel<float><<<grid, kSsdThreads, 0, st>>>(ap, xp, bp, cp, hf, yp, nh, hd,
                                                                ds, ng);
  } else if (ds % 8 == 0 && pow2_pieces(ds, 8)) {
    ssd_step_kernel<__nv_bfloat16, 8, 8><<<grid, kSsdThreads, 0, st>>>(ap, xp, bp, cp, hb, yp, nh,
                                                                       hd, ds, ng);
  } else {
    ssd_step_rows_kernel<__nv_bfloat16><<<grid, kSsdThreads, 0, st>>>(ap, xp, bp, cp, hb, yp, nh,
                                                                      hd, ds, ng);
  }
  return cudaGetLastError();
}
