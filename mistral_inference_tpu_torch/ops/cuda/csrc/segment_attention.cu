// K10: the Pixtral vision encoder's segment-masked attention.
//
// Replaces the stock jax.experimental.pallas.ops.tpu.flash_attention
// .flash_attention with SegmentIds that mistral_inference_tpu/models/vision.py
// calls: non-causal softmax(Q K^T D^-1/2) V per (image, head), where a patch
// sees only the patches of its own segment (an image id; the bucket padding
// is a segment of its own). q, k, v and out (B, N, H, 64) bf16, seg (B, N)
// int32. At a full 1024 x 1024 image (N = 4096, 16 heads) it is
// compute-bound: 68.7 GFLOP against 33.5 MB of operands. The tile loop is
// flash_hopper.cuh's at head dim 64, 128 keys a tile, with the segment ids
// in the position slots: a key tile of one image against a query tile of
// the same image is full (no mask), of another image skipped, and only
// tiles that straddle a boundary are masked per element.
#include "flash_hopper.cuh"

extern "C" int flash_attention_seg_bf16(const void* q, const void* k, const void* v,
                                        const void* seg, void* out, int B, int N, int H,
                                        float scale, void* stream) {
  return mit::hopper::launch_flash_hopper<__nv_bfloat16, false, 64, true>(
      q, k, v, nullptr, nullptr, seg, seg, nullptr, nullptr, 0, out, nullptr, nullptr, B, N,
      N, H, H, scale, stream);
}
