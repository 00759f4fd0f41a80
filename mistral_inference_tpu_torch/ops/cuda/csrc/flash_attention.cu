// K1: flash attention over a chunk's own bf16 keys and values.
//
// Replaces mistral_inference_tpu/ops/pallas/attention.py::flash_attention
// (kernel _attn_kernel). Used by the first prefill chunk and by every later
// chunk's attention to itself. The tile loop, its numerics and what bounds it
// are described in flash_tile.cuh.
#include "flash_tile.cuh"

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    const void* q_pos, const void* kv_pos,
                                    const void* q_valid, const void* kv_valid, int window,
                                    void* out, void* m_out, void* l_out, int B, int T,
                                    int S, int H, int Hkv, float scale, void* stream) {
  return mit::launch_flash_tile(q, k, v, q_pos, kv_pos, q_valid, kv_valid, window, out,
                                m_out, l_out, B, T, S, H, Hkv, scale, stream);
}
