// K2: one decode step's ring write and ring-only attention, fused; and K7,
// the write and the attention for the T <= 8 candidate tokens of a
// speculative verify chunk. Both run the cluster decode loop of
// decode_hopper.cuh with its write in front (K6 runs the same loop without
// it), in one launch each: the design, the ring rule of the write, the
// numerics and what bounds them are described there.
//
// K2 replaces mistral_inference_tpu/ops/pallas/attention.py::
// fused_update_decode_attention (kernel _fused_decode_kernel, tile loop
// _fused_tile_attend). K7 replaces ::fused_verify_chunk_attention (kernel
// _fused_verify_kernel): K2 is its T = 1 case. Each is built for an int8
// ring, an e4m3 (float8_e4m3fn) ring, both with fp32 scales per (slot, kv
// head), and a bf16 ring; the TPU kernels take the same three. The TPU
// kernel's 16-slot read-modify-write groups, lane-aligned scale windows and
// DMA semaphores exist because a TPU DMA moves aligned tiles; a CUDA thread
// stores a byte where it wants, so none of that is here.
//
// Function, for T query tokens per row (T = 1 for K2): quantize the chunk's
// K and V per (token, kv head) and write token t into slot write_slot[b] + t
// of layer li of the stacked ring, in place (write_slot = -1 writes nothing
// for that row); then attend each query head of each token over its KV
// head's ring slots with 0 <= q_pos[b, t] - kv_pos < window and kv_valid,
// scales applied after the dots. kv_pos and kv_valid come from
// cache.slot_positions after the write, so query t does not see the
// candidates after it: their positions are larger than its own. The T slots
// never wrap (the caller's precondition: a ring that holds every position it
// has been given), so a candidate that is later rejected stays in its slot,
// hidden by the caller's kv_len, until the real token of that position
// overwrites it. This file must not be built with fast-math: the write's
// divisions are IEEE divisions.
#include "decode_hopper.cuh"

// K2: xq (B, 1, H, D), xk and xv (B, 1, Hkv, D) bf16, write_slot and q_pos
// (B,), out (B, 1, H * D); H / Hkv <= 32.
extern "C" int fused_decode_int8(const void* xq, const void* xk, const void* xv, void* ck,
                                 void* cv, void* ks, void* vs, int li, int window,
                                 const void* write_slot, const void* q_pos,
                                 const void* kv_pos, const void* kv_valid, void* out, int B,
                                 int S, int H, int Hkv, float scale, void* stream) {
  return mit::decode::launch_fused<int8_t, true>(xq, xk, xv, ck, cv, ks, vs, li, window,
                                                 write_slot, q_pos, kv_pos, kv_valid, out, B, 1,
                                                 S, H, Hkv, scale, stream);
}

// The e4m3 ring: the int8 entry points' arguments, KT = __nv_fp8_e4m3.
extern "C" int fused_decode_fp8(const void* xq, const void* xk, const void* xv, void* ck,
                                void* cv, void* ks, void* vs, int li, int window,
                                const void* write_slot, const void* q_pos, const void* kv_pos,
                                const void* kv_valid, void* out, int B, int S, int H, int Hkv,
                                float scale, void* stream) {
  return mit::decode::launch_fused<__nv_fp8_e4m3, true>(xq, xk, xv, ck, cv, ks, vs, li, window,
                                                        write_slot, q_pos, kv_pos, kv_valid, out,
                                                        B, 1, S, H, Hkv, scale, stream);
}

extern "C" int fused_decode_bf16(const void* xq, const void* xk, const void* xv, void* ck,
                                 void* cv, int li, int window, const void* write_slot,
                                 const void* q_pos, const void* kv_pos,
                                 const void* kv_valid, void* out, int B, int S, int H, int Hkv,
                                 float scale, void* stream) {
  return mit::decode::launch_fused<__nv_bfloat16, false>(
      xq, xk, xv, ck, cv, nullptr, nullptr, li, window, write_slot, q_pos, kv_pos, kv_valid,
      out, B, 1, S, H, Hkv, scale, stream);
}

// K7: xq (B, T, H, D), xk and xv (B, T, Hkv, D), write_slot0 (B,), q_pos
// (B, T), out (B, T, H * D); T <= 8 and H / Hkv * T <= 32.
extern "C" int fused_verify_int8(const void* xq, const void* xk, const void* xv, void* ck,
                                 void* cv, void* ks, void* vs, int li, int window,
                                 const void* write_slot0, const void* q_pos,
                                 const void* kv_pos, const void* kv_valid, void* out, int B,
                                 int T, int S, int H, int Hkv, float scale, void* stream) {
  return mit::decode::launch_fused<int8_t, true>(xq, xk, xv, ck, cv, ks, vs, li, window,
                                                 write_slot0, q_pos, kv_pos, kv_valid, out, B, T,
                                                 S, H, Hkv, scale, stream);
}

extern "C" int fused_verify_fp8(const void* xq, const void* xk, const void* xv, void* ck,
                                void* cv, void* ks, void* vs, int li, int window,
                                const void* write_slot0, const void* q_pos, const void* kv_pos,
                                const void* kv_valid, void* out, int B, int T, int S, int H,
                                int Hkv, float scale, void* stream) {
  return mit::decode::launch_fused<__nv_fp8_e4m3, true>(xq, xk, xv, ck, cv, ks, vs, li, window,
                                                        write_slot0, q_pos, kv_pos, kv_valid,
                                                        out, B, T, S, H, Hkv, scale, stream);
}

extern "C" int fused_verify_bf16(const void* xq, const void* xk, const void* xv, void* ck,
                                 void* cv, int li, int window, const void* write_slot0,
                                 const void* q_pos, const void* kv_pos,
                                 const void* kv_valid, void* out, int B, int T, int S, int H,
                                 int Hkv, float scale, void* stream) {
  return mit::decode::launch_fused<__nv_bfloat16, false>(
      xq, xk, xv, ck, cv, nullptr, nullptr, li, window, write_slot0, q_pos, kv_pos, kv_valid,
      out, B, T, S, H, Hkv, scale, stream);
}
