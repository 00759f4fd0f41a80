// K3: x @ dequant(q) for a weight-only quantized linear at decode row counts.
//
// Replaces mistral_inference_tpu/ops/pallas/matmul_quant.py::matmul_quant and
// ::matmul_quant_stacked (kernels _mm_kernel, _mm_kernel_2d,
// _mm_kernel_2d_int4 and their _stacked forms). The stacked form is this same
// kernel: its caller offsets the weight and scale pointers to layer li of the
// (L, ...) stack, so no layer is ever copied.
//
// Function: x (M, K) bf16; q int8 (K, N), or int4 packed (K / 2, N) in
// split-halves layout; scale fp32 (K / g, N); out (M, N) bf16. The function,
// its rounding points, the block's design and what bounds it on the H100 are
// set out in dequant_dot.cuh, which holds the device code: this source is the
// one-weight case, grid (column block, reduction split, row block). The
// reduction is split over blocks so that wo and w2, whose N / 128 column
// blocks alone would leave most of the 132 SMs idle, still fill the card.
#include "dequant_dot.cuh"

namespace mit {

template <int kMode>
__global__ void __launch_bounds__(kMqThreads) matmul_quant_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, float* __restrict__ part,
    __nv_bfloat16* __restrict__ out, int M, int K, int N, int g, int units, int upb) {
  dequant_dot_block<kMode>(x, q, scale, part, out, M, K, N, g, units, upb,
                           blockIdx.x * kMqCols, blockIdx.y, blockIdx.z * kMqRows,
                           static_cast<size_t>(M) * N);
}

__global__ void __launch_bounds__(256) matmul_quant_reduce_kernel(
    const float* __restrict__ part, __nv_bfloat16* __restrict__ out, int splits, size_t MN) {
  dequant_dot_reduce(part, out, splits, MN);
}

// The blocks before the split, from which the split is chosen. Up to
// kMqSameSplitRows rows count as one row block, so a row's sums are split and
// added in the same order at 4 rows (a decode step) as at 20 or 32 (a
// speculative verify chunk) and its result has the same bits: the verify
// forward then picks the tokens plain decoding picks. More row blocks than
// that shrink the split, as the card is full without it.
constexpr int kMqSameSplitRows = 32;

inline int mq_blocks(int M, int N) {
  return (N / kMqCols) * (M <= kMqSameSplitRows ? 1 : mq_row_blocks(M));
}

}  // namespace mit

// The number of reduction splits the launch below will use, so that the
// caller can size the workspace: part holds splits * M * N floats when
// splits > 1 and is not touched otherwise. 0 for shapes the kernel refuses.
extern "C" int matmul_quant_splits(int M, int K, int N, int ng, int bits) {
  if (!mit::mq_shapes_ok(M, K, N, ng, bits)) return 0;
  const int units = mit::mq_units(ng, bits);
  const int upb = mit::mq_units_per_block(mit::mq_blocks(M, N), units);
  return (units + upb - 1) / upb;
}

extern "C" int matmul_quant_bf16(const void* x, const void* q, const void* scale, void* out,
                                 void* part, int M, int K, int N, int ng, int bits,
                                 void* stream) {
  using namespace mit;
  if (!mq_shapes_ok(M, K, N, ng, bits)) return cudaErrorInvalidValue;
  const int units = mq_units(ng, bits);
  const int upb = mq_units_per_block(mq_blocks(M, N), units);
  const int splits = (units + upb - 1) / upb;
  if (splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(N / kMqCols, splits, mq_row_blocks(M));
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = static_cast<const float*>(scale);
  float* pp = splits > 1 ? static_cast<float*>(part) : nullptr;
  auto* op = static_cast<__nv_bfloat16*>(out);
  const int g = K / ng;
  if (bits == 8)
    matmul_quant_kernel<kModeInt8><<<grid, kMqThreads, 0, st>>>(xp, qp, sp, pp, op, M, K, N, g,
                                                              units, upb);
  else if (ng % 2 == 0)
    matmul_quant_kernel<kModeInt4Paired><<<grid, kMqThreads, 0, st>>>(xp, qp, sp, pp, op, M, K,
                                                                    N, g, units, upb);
  else
    matmul_quant_kernel<kModeInt4Single><<<grid, kMqThreads, 0, st>>>(xp, qp, sp, pp, op, M, K,
                                                                    N, g, units, upb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t MN = static_cast<size_t>(M) * N;
  matmul_quant_reduce_kernel<<<static_cast<unsigned>((MN + 255) / 256), 256, 0, st>>>(pp, op,
                                                                                     splits, MN);
  return cudaGetLastError();
}
