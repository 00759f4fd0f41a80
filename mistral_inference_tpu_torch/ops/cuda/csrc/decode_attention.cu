// K6: one decode step's attention over layer li of the stacked KV ring, read
// in place and not written, for the decode route that writes the ring with
// cache.update_stacked first.
//
// Replaces mistral_inference_tpu/ops/pallas/attention.py::decode_attention
// (kernel _decode_attn_kernel). Built for an int8 ring and an e4m3
// (float8_e4m3fn) ring, both with fp32 scales per (slot, kv head), and for a
// bf16 ring. q (B, 1, H, D) bf16, the ring (L, B, S, Hkv * D), scales (L, B,
// Hkv, S), q_pos (B,), kv_pos (B, S) int32, kv_valid (B, S) bool, out (B, 1,
// H * D) bf16. One launch of the loop K2 and K7 run too, without their ring
// write: the design (a cluster per batch row and KV head, only visible slots
// streamed through a cp.async pipeline, both products on the tensor cores,
// the partials merged in distributed shared memory), its numerics and what
// bounds it are described in decode_hopper.cuh.
#include "decode_hopper.cuh"

extern "C" int decode_attention_int8(const void* xq, const void* ck, const void* cv,
                                     const void* ks, const void* vs, int li, int window,
                                     const void* q_pos, const void* kv_pos,
                                     const void* kv_valid, void* out, int B, int S, int H,
                                     int Hkv, float scale, void* stream) {
  return mit::decode::launch_decode<int8_t, true>(xq, ck, cv, ks, vs, li, window, q_pos,
                                                  kv_pos, kv_valid, out, B, S, H, Hkv, scale,
                                                  stream);
}

extern "C" int decode_attention_fp8(const void* xq, const void* ck, const void* cv,
                                    const void* ks, const void* vs, int li, int window,
                                    const void* q_pos, const void* kv_pos,
                                    const void* kv_valid, void* out, int B, int S, int H,
                                    int Hkv, float scale, void* stream) {
  return mit::decode::launch_decode<__nv_fp8_e4m3, true>(xq, ck, cv, ks, vs, li, window, q_pos,
                                                         kv_pos, kv_valid, out, B, S, H, Hkv,
                                                         scale, stream);
}

extern "C" int decode_attention_bf16(const void* xq, const void* ck, const void* cv, int li,
                                     int window, const void* q_pos, const void* kv_pos,
                                     const void* kv_valid, void* out, int B, int S, int H,
                                     int Hkv, float scale, void* stream) {
  return mit::decode::launch_decode<__nv_bfloat16, false>(xq, ck, cv, nullptr, nullptr, li,
                                                          window, q_pos, kv_pos, kv_valid, out,
                                                          B, S, H, Hkv, scale, stream);
}
