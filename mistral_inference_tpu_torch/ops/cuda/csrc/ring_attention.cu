// K4: a prefill chunk's queries over one layer's stored ring, with stats.
//
// Replaces mistral_inference_tpu/ops/pallas/attention.py::ring_attention_stats
// (kernel _ring_chunk_kernel). The ring is read in its stored flat-head
// layout (B, S, Hkv * D), int8 or e4m3 (float8_e4m3fn) with fp32 scales
// (B, Hkv, S) applied after the dots, or bf16 without scales. The producer
// warpgroup widens an int8 or e4m3 tile to bf16 exactly on its way into
// shared memory. The returned (out, m, l) merge exactly with K1's stats over
// the chunk itself (merge_attention_parts), which runs the same loop. The
// tile loop (wgmma, an asynchronous K/V pipeline, visibility decided per
// tile), its numerics and
// what bounds it are described in flash_hopper.cuh: at T = 512 queries over
// a 4096-slot ring it is compute-bound, about 85 GFLOP of visible pairs.
#include "flash_hopper.cuh"

extern "C" int ring_attention_stats_int8(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* q_pos, const void* kv_pos,
                                         const void* q_valid, const void* kv_valid,
                                         int window, void* out, void* m_out, void* l_out,
                                         int B, int T, int S, int H, int Hkv, float scale,
                                         void* stream) {
  return mit::hopper::launch_flash_hopper<int8_t, true, 128, false>(q, k, v, k_scale, v_scale, q_pos, kv_pos,
                                              q_valid, kv_valid, window, out, m_out, l_out,
                                              B, T, S, H, Hkv, scale, stream);
}

extern "C" int ring_attention_stats_fp8(const void* q, const void* k, const void* v,
                                        const void* k_scale, const void* v_scale,
                                        const void* q_pos, const void* kv_pos,
                                        const void* q_valid, const void* kv_valid, int window,
                                        void* out, void* m_out, void* l_out, int B, int T,
                                        int S, int H, int Hkv, float scale, void* stream) {
  return mit::hopper::launch_flash_hopper<__nv_fp8_e4m3, true, 128, false>(q, k, v, k_scale, v_scale, q_pos,
                                                     kv_pos, q_valid, kv_valid, window, out,
                                                     m_out, l_out, B, T, S, H, Hkv, scale,
                                                     stream);
}

extern "C" int ring_attention_stats_bf16(const void* q, const void* k, const void* v,
                                         const void* q_pos, const void* kv_pos,
                                         const void* q_valid, const void* kv_valid,
                                         int window, void* out, void* m_out, void* l_out,
                                         int B, int T, int S, int H, int Hkv, float scale,
                                         void* stream) {
  return mit::hopper::launch_flash_hopper<__nv_bfloat16, false, 128, false>(
      q, k, v, nullptr, nullptr, q_pos, kv_pos, q_valid, kv_valid, window, out, m_out,
      l_out, B, T, S, H, Hkv, scale, stream);
}
