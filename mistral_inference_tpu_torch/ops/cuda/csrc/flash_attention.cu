// K1: flash attention over a chunk's own bf16 keys and values.
//
// Replaces mistral_inference_tpu/ops/pallas/attention.py::flash_attention
// (kernel _attn_kernel). Used by the first prefill chunk and by every later
// chunk's attention to itself. It runs the Hopper tile loop of
// flash_hopper.cuh (wgmma, an asynchronous K/V pipeline, visibility decided
// per tile) in an instantiation of its own (kChunk): keys and values (B, S,
// Hkv, D) are the loop's (B, S, Hkv * D), unscaled; the grid is persistent
// (a block an SM walks items, the next one's loads overlapping the current
// one's end) and the query tiles run last to first, so the long walks of a
// causal chunk start first. Its numerics and what bounds it are described
// there.
#include "flash_hopper.cuh"

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    const void* q_pos, const void* kv_pos,
                                    const void* q_valid, const void* kv_valid, int window,
                                    void* out, void* m_out, void* l_out, int B, int T,
                                    int S, int H, int Hkv, float scale, void* stream) {
  return mit::hopper::launch_flash_hopper<__nv_bfloat16, false, 128, false, true>(
      q, k, v, nullptr, nullptr, q_pos, kv_pos, q_valid, kv_valid, window, out, m_out,
      l_out, B, T, S, H, Hkv, scale, stream);
}
