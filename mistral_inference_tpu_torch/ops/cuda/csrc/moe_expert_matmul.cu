// K8: per expert e, buf[e] (C, K) @ dequant(W[e]) (K, N): the grouped
// (per-expert) dequant-matmul of the MoE decode step.
//
// Replaces mistral_inference_tpu/ops/pallas/moe_matmul.py::moe_matmul_quant
// (kernel _kernel) and ::moe_matmul_quant_stacked (kernel _kernel_stacked).
// The stacked form is this same kernel: its caller offsets the weight and
// scale pointers to layer li of the (L, E, ...) stack, so no layer is copied.
//
// Function: x (E, C, K) bf16, the experts' capacity buffers (C <= 128); q
// int8 (E, K, N), or int4 packed (E, K / 2, N) in split-halves layout (byte
// row r holds element r in its low nibble and r + K / 2 in its high one);
// scale fp32 (E, K / g, N); out (E, C, N) bf16. out[e] is the grouped-dequant
// product of x[e] and expert e's weight, with the rounding points of K3 and
// K5: the integer weight is exact in bf16, each group's dot is summed in
// fp32, the scale multiplies the fp32 partial after the dot, the groups are
// summed in fp32 in a fixed order, one rounding to bf16.
//
// Design: the TPU kernel stages a whole (C, K) buffer and a (K, TN) weight
// tile in fast memory. Here each block takes one expert, a panel of columns
// and one slice of the reduction, and every capacity row of the expert, so
// each live expert's weight is read once whatever C is. The device loop is
// dequant_mma.cuh's (shared with K3): mma.sync m16n8k16 with the weight as A
// assembled by byte permutes, the capacity rows as n-tiles of 8, a
// three-stage cp.async ring, partials added in split order across a
// thread-block cluster. What K8 adds:
//
// - Capacity: the loop's row-count table (launch_rows), as K3's: one to four
//   n-tiles a warp over 128 columns up to 32 rows, two or four row groups
//   over 64 columns above. The column panel narrows; the sums do not change.
// - Empty experts read no weight (the loop's kSkipEmpty): a block first looks
//   at its expert's rows over its slice of the reduction (row 0 first,
//   stopping at the first nonzero); if all are zero (a third of the experts
//   at B = 4, top-2) it contributes zeros and loads nothing.
// - A fixed reduction split: about 1024 stored rows a block, at most 8,
//   chosen from K, N, the group count and the bits alone (never from C or
//   E): a row's bits are the same at C = 4 and C = 128, whichever experts
//   share the step.
//
// What bounds it on the H100: bytes at the main path's C = 4: the stored
// weights and scales of the experts that hold a row over 3.35 TB/s (a weight
// byte does 8 or 16 flops). At C = 128 the products come near the bytes.
#include "dequant_mma.cuh"

namespace mit {
namespace expert {

using namespace dqmma;

constexpr int kSplitRows = 1024;  // stored rows a block takes, about

// Units a block takes: about kSplitRows stored rows, from the shape alone.
inline int units_per_block(int K, int ng, int bits) {
  const int g = K / ng;
  const int units = units_of(ng, bits);
  const int want = min(kMaxSplits, max(1, (units * g + kSplitRows - 1) / kSplitRows));
  return aligned_units(units, g, want);
}

}  // namespace expert
}  // namespace mit

// C at most 128 rows, and the weights dequant_mma.cuh's shapes_ok takes: the
// same rules as moe_matmul.py's expert_shape_ok.
extern "C" int moe_matmul_quant_bf16(const void* x, const void* q, const void* scale, void* out,
                                     int E, int C, int K, int N, int ng, int bits,
                                     void* stream) {
  using namespace mit::expert;
  if (E < 1 || E > 65535 || C < 1 || C > kMaxRows || !shapes_ok(K, N, ng, bits))
    return cudaErrorInvalidValue;
  const long long stored = bits == 4 ? K / 2 : K;
  return launch_bits<true>(static_cast<cudaStream_t>(stream), x, q, scale, out, C, E * C, E, K,
                           N, ng, bits, units_per_block(K, ng, bits), stored * N,
                           static_cast<long long>(ng) * N);
}
