// K1: flash attention over a chunk's own bf16 keys and values.
//
// Replaces mistral_inference_tpu/ops/pallas/attention.py::flash_attention
// (kernel _attn_kernel). Used by the first prefill chunk and by every later
// chunk's attention to itself. The tile loop, its numerics and what bounds it
// are described in flash_tile.cuh; here k and v are (B, S, Hkv, D) bf16 and
// there are no scales.
//
// K10: the vision encoder's attention, the same tile loop at head dim 64
// with a segment mask. Replaces the stock
// jax.experimental.pallas.ops.tpu.flash_attention.flash_attention with
// SegmentIds that mistral_inference_tpu/models/vision.py calls: non-causal
// softmax(Q K^T D^-1/2) V per (image, head), where a patch sees only the
// patches of its own segment (an image id; the bucket padding is a segment
// of its own). q, k, v and out (B, N, H, 64) bf16, seg (B, N) int32. At a
// full 1024 x 1024 image (N = 4096, 16 heads) it is compute-bound: 68.7
// GFLOP against 33.5 MB of operands.
#include "flash_tile.cuh"

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    const void* q_pos, const void* kv_pos,
                                    const void* q_valid, const void* kv_valid, int window,
                                    void* out, void* m_out, void* l_out, int B, int T,
                                    int S, int H, int Hkv, float scale, void* stream) {
  return mit::launch_flash_tile<__nv_bfloat16, false>(
      q, k, v, nullptr, nullptr, q_pos, kv_pos, q_valid, kv_valid, window, out, m_out,
      l_out, B, T, S, H, Hkv, scale, stream);
}

extern "C" int flash_attention_seg_bf16(const void* q, const void* k, const void* v,
                                        const void* seg, void* out, int B, int N, int H,
                                        float scale, void* stream) {
  return mit::launch_flash_tile<__nv_bfloat16, false, 64, true>(
      q, k, v, nullptr, nullptr, seg, seg, nullptr, nullptr, 0, out, nullptr, nullptr, B, N,
      N, H, H, scale, stream);
}
