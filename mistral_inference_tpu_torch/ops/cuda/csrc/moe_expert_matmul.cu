// K8: per expert e, buf[e] (C, K) @ dequant(W[e]) (K, N): the grouped
// (per-expert) dequant-matmul of the MoE decode step.
//
// Replaces mistral_inference_tpu/ops/pallas/moe_matmul.py::moe_matmul_quant
// (kernel _kernel) and ::moe_matmul_quant_stacked (kernel _kernel_stacked).
// The stacked form is this same kernel: its caller offsets the weight and
// scale pointers to layer li of the (L, E, ...) stack, so no layer is copied.
//
// Function: x (E, C, K) bf16, the experts' capacity buffers; q int8 (E, K, N),
// or int4 packed (E, K / 2, N) in split-halves layout; scale fp32 (E, K / g,
// N); out (E, C, N) bf16. out[e] is the grouped-dequant product of x[e] and
// expert e's weight, with the rounding points of dequant_dot.cuh (those of K3
// and K5: fp32 dot per group, the scale after the dot, fp32 sum over groups,
// one rounding to bf16), which decode == prefill leans on.
//
// Design: the TPU kernel stages a whole (C, K) buffer and a (K, TN) weight
// tile in fast memory, which 227 KB of shared memory cannot hold. The work is
// K3's (a few rows against a streamed integer weight) with one more axis, so
// this is K3's block (dequant_dot.cuh) on the grid (column block, reduction
// split, expert x row block): one launch for all experts, partial sums of a
// split reduction added in split order by a second kernel, no atomics, the
// same bits on every run. A block whose x rows are all zero over its slice
// of the reduction writes zeros and reads no weight: with top-2 of 8 experts
// and 4 tokens about a third of the experts hold no row, and at a capacity
// above 4 only the row blocks that hold rows stream their expert's weight.
//
// What bounds it on the H100: bytes, the stored weights and scales of the
// experts that hold at least one row, over 3.35 TB/s (at C = 4 a weight byte
// does 8 or 16 flops). Each row block of an expert re-reads that expert's
// weight, so a capacity near 128 costs up to 32 times the bytes.
#include "dequant_dot.cuh"

namespace mit {

template <int kMode>
__global__ void __launch_bounds__(kMqThreads) moe_expert_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, float* __restrict__ part,
    __nv_bfloat16* __restrict__ out, int E, int C, int K, int N, int g, int stored, int units,
    int upb, int row_blocks) {
  const int e = blockIdx.z / row_blocks, rb = blockIdx.z - e * row_blocks;
  const size_t rows = static_cast<size_t>(e) * C;  // rows of x and out before expert e
  dequant_dot_block<kMode, true>(
      x + rows * K, q + static_cast<size_t>(e) * stored * N,
      scale + static_cast<size_t>(e) * (K / g) * N, part == nullptr ? nullptr : part + rows * N,
      out + rows * N, C, K, N, g, units, upb, blockIdx.x * kMqCols, blockIdx.y, rb * kMqRows,
      static_cast<size_t>(E) * C * N);
}

__global__ void __launch_bounds__(256) moe_expert_matmul_reduce_kernel(
    const float* __restrict__ part, __nv_bfloat16* __restrict__ out, int splits, size_t MN) {
  dequant_dot_reduce(part, out, splits, MN);
}

inline int moe_blocks(int E, int C, int N) { return (N / kMqCols) * E * mq_row_blocks(C); }

}  // namespace mit

// The number of reduction splits the launch below will use: part holds
// splits * E * C * N floats when splits > 1 and is not touched otherwise.
// 0 for shapes the kernel refuses.
extern "C" int moe_matmul_quant_splits(int E, int C, int K, int N, int ng, int bits) {
  if (!mit::mq_shapes_ok(E, C, K, N, ng, bits)) return 0;
  const int units = mit::mq_units(ng, bits);
  const int upb = mit::mq_units_per_block(mit::moe_blocks(E, C, N), units);
  return (units + upb - 1) / upb;
}

extern "C" int moe_matmul_quant_bf16(const void* x, const void* q, const void* scale, void* out,
                                     void* part, int E, int C, int K, int N, int ng, int bits,
                                     void* stream) {
  using namespace mit;
  if (!mq_shapes_ok(E, C, K, N, ng, bits)) return cudaErrorInvalidValue;
  const int units = mq_units(ng, bits);
  const int upb = mq_units_per_block(moe_blocks(E, C, N), units);
  const int splits = (units + upb - 1) / upb;
  if (splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_blocks = mq_row_blocks(C);
  const dim3 grid(N / kMqCols, splits, E * row_blocks);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = static_cast<const float*>(scale);
  float* pp = splits > 1 ? static_cast<float*>(part) : nullptr;
  auto* op = static_cast<__nv_bfloat16*>(out);
  const int g = K / ng, stored = bits == 4 ? K / 2 : K;
  if (bits == 8)
    moe_expert_matmul_kernel<kModeInt8><<<grid, kMqThreads, 0, st>>>(
        xp, qp, sp, pp, op, E, C, K, N, g, stored, units, upb, row_blocks);
  else if (ng % 2 == 0)
    moe_expert_matmul_kernel<kModeInt4Paired><<<grid, kMqThreads, 0, st>>>(
        xp, qp, sp, pp, op, E, C, K, N, g, stored, units, upb, row_blocks);
  else
    moe_expert_matmul_kernel<kModeInt4Single><<<grid, kMqThreads, 0, st>>>(
        xp, qp, sp, pp, op, E, C, K, N, g, stored, units, upb, row_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t MN = static_cast<size_t>(E) * C * N;
  moe_expert_matmul_reduce_kernel<<<static_cast<unsigned>((MN + 255) / 256), 256, 0, st>>>(
      pp, op, splits, MN);
  return cudaGetLastError();
}
