// K3: x @ dequant(q) for a weight-only quantized linear at decode row counts.
//
// Replaces mistral_inference_tpu/ops/pallas/matmul_quant.py::matmul_quant and
// ::matmul_quant_stacked (kernels _mm_kernel, _mm_kernel_2d,
// _mm_kernel_2d_int4 and their _stacked forms). The stacked form is this same
// kernel: its caller offsets the weight and scale pointers to layer li of the
// (L, ...) stack, so no layer is ever copied.
//
// Function: x (M, K) bf16, M <= 256; q int8 (K, N), or int4 packed (K / 2, N)
// in split-halves layout; scale fp32 (K / g, N); out (M, N) bf16, with the
// rounding points of dequant_mma.cuh: each group's dot summed in fp32, the
// scale after the dot, the groups summed in fp32 in a fixed order, one
// rounding to bf16.
//
// Design: the TPU kernel keeps all B rows of x in one block and reads each
// weight tile once. Here the device loop is dequant_mma.cuh's (shared with
// K8): mma.sync m16n8k16 with the weight as A assembled by byte permutes, x's
// rows as n-tiles of 8, a three-stage cp.async ring, the block's scales
// staged with its first chunk. A block holds every row up to 128 (1-4
// n-tiles a warp over 128 columns up to 32 rows; 2 or 4 row groups of 4
// n-tiles over 64 columns above), so the weight is read once; 129-256 rows
// take a second row block, the only case that reads it twice. The grid
// fills the card with one matrix: the reduction split (at most 8, the
// portable cluster) follows K, N, the group count and the bits alone, so
// that about 16 warps an SM run at once at decode row counts; the partials
// add in split order across the cluster through distributed shared memory.
// The split never follows M, so a row has the same bits at 4 rows as among
// 8, 20, 32, 128 or 256: a speculative verify forward picks the tokens plain
// decoding picks. The shapes are K8's: a group of 16 or 32 steps or a
// multiple of 64, and for int4 an even group count.
//
// What bounds it on the H100: bytes. At four rows each weight byte does 8 or
// 16 flops, far under the 295 flop/byte ridge, so the least time is the
// weight's bytes (plus scales) over 3.35 TB/s.
#include "dequant_mma.cuh"

namespace mit {
namespace mq {

using namespace dqmma;

constexpr int kSMs = 132;           // the H100's: the split is the same on every card
constexpr int kTargetWarps = 16;    // warps an SM at decode row counts
constexpr int kMinSplitRows = 128;  // stored rows a split takes at the least

// Units a block takes: the split of the reduction, from the shape alone.
inline int units_per_block(int K, int N, int ng, int bits) {
  const int g = K / ng;
  const int units = units_of(ng, bits);
  // Before the split a grid has N / 32 warps at decode row counts.
  int want = max(1, min(kMaxSplits, kSMs * kTargetWarps / (N / 32)));
  want = max(1, min(want, units * g / kMinSplitRows));
  return aligned_units(units, g, want);
}

}  // namespace mq
}  // namespace mit

// K3 on x (M, K) and one weight, its reduction split that of a weight of
// split_n columns (N, or a shard's whole N); cudaErrorInvalidValue for the
// shapes matmul_quant.py's shape_ok refuses.
extern "C" int matmul_quant_bf16(const void* x, const void* q, const void* scale, void* out,
                                 int M, int K, int N, int ng, int bits, int split_n,
                                 void* stream) {
  using namespace mit::mq;
  if (M < 1 || M > 2 * kMaxRows || !shapes_ok(K, N, ng, bits)) return cudaErrorInvalidValue;
  if (split_n < N || split_n % 128 != 0) return cudaErrorInvalidValue;
  const int C = min(M, kMaxRows);  // rows a block; 129-256 take a second row block
  return launch_bits<false>(static_cast<cudaStream_t>(stream), x, q, scale, out, C, M,
                            (M + C - 1) / C, K, N, ng, bits,
                            units_per_block(K, split_n, ng, bits), 0, 0);
}
