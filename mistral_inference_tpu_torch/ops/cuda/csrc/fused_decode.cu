// K2: one decode step's ring write and ring-only attention, fused; and K6,
// the same attention with no write.
//
// K2 replaces mistral_inference_tpu/ops/pallas/attention.py::
// fused_update_decode_attention (kernel _fused_decode_kernel, tile loop
// _fused_tile_attend). K6 replaces ::decode_attention (kernel
// _decode_attn_kernel) of the same file: it is this kernel instantiated
// without the write (kWrite = false), for the decode route that writes the
// ring with cache.update_stacked first. It takes any kv_pos and kv_valid, so
// it cannot know a row's fill: where K2 stops at min(q_pos + 1, window), K6
// asks each span's 128 slots whether the query sees any of them and skips the
// span if not.
//
// Function, for T = 1: quantize this step's K and V per (token, kv head) and
// write them into slot write_slot[b] of layer li of the stacked ring, in
// place (write_slot = -1 writes nothing); then attend each query head over
// its KV head's ring slots with 0 <= q_pos - kv_pos < window and kv_valid,
// scales applied after the dots. A row's slots at or past its fill
// min(q_pos + 1, window) are never visible (kv_pos and kv_valid come from
// cache.slot_positions after the write) and are skipped.
//
// Design: the ring is cut into spans of kSpan slots, and one block of 128
// threads runs per (span, kv head, batch row), so a B = 4 step over a 4096-slot
// ring fills the card with 1024 blocks; thread d owns head-dim element d. The
// write comes first, made by the one block whose span holds the slot: the
// int8 rule is that of cache._quantize_ring bit for bit (fp32 absmax / 127
// with a floor of 1e-8, IEEE division, rintf = round half to even, clip to
// +-127; this file must not be built with fast-math). A (token, head) scale
// depends only on this block's head, so the block that writes a slot's bytes
// for head j is the only block that ever reads them, and __syncthreads()
// orders the write before the reads: no other block touches this row's
// head-j columns in this span. Each block then streams its span in 32-slot
// tiles through shared memory, skipping slots at or past the row's own fill
// min(q_pos + 1, window); warp w scores heads w and w + 4 (one slot per lane)
// with a running max and sum, and the PV product runs with one output column
// per thread. The block leaves an unnormalized partial (acc, m, l) per query
// head, and a second kernel merges the spans of each (row, head) exactly.
//
// What bounds it on the H100: bytes. Each call reads each row's visible
// slots of K and V once (int8 or bf16) plus scales, and does 4 * D flops per
// (head, slot): about 4 flops per byte, far below the 295 flop/byte ridge.
// Reading each KV head's slots once for all G query heads, and spreading the
// ring over enough blocks to keep every SM loading, is what the design does
// about it.
#include "common.cuh"

namespace mit {

constexpr int kDecThreads = 128;  // one thread per head-dim element
constexpr int kSlots = 32;        // ring slots per tile, one per lane
constexpr int kSpan = 128;        // ring slots per block
constexpr int kMaxGroup = 8;      // query heads per KV head

__device__ __forceinline__ float block_max(float x, float* red) {
  x = group_max(x, 32);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  const float r = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  __syncthreads();
  return r;
}

// Partials: part_acc (B, H, nspan, D) unnormalized sums, part_ml
// (B, H, nspan, 2) running max and sum; a span with no visible slot leaves
// acc = 0, m = kNegInf, l = 0.
template <typename KT, bool kScaled, bool kWrite>
__global__ void __launch_bounds__(kDecThreads) fused_decode_kernel(
    const __nv_bfloat16* __restrict__ xq, const __nv_bfloat16* __restrict__ xk,
    const __nv_bfloat16* __restrict__ xv, KT* ck, KT* cv, float* ks, float* vs, int li,
    int window, const int* __restrict__ write_slot, const int* __restrict__ q_pos,
    const int* __restrict__ kv_pos, const uint8_t* __restrict__ kv_valid,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int B, int S, int H, int Hkv,
    float scale) {
  constexpr int D = kHeadDim;
  const int span = blockIdx.x, nspan = gridDim.x, j = blockIdx.y, b = blockIdx.z;
  const int lo = span * kSpan;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int G = H / Hkv;
  const size_t HD = static_cast<size_t>(Hkv) * D;
  // Layer li, batch row b. The ring is read and written through these plain
  // (non-restrict) pointers, so no load takes the non-coherent path.
  KT* ck_row = ck + (static_cast<size_t>(li) * B + b) * S * HD;
  KT* cv_row = cv + (static_cast<size_t>(li) * B + b) * S * HD;
  float* ks_row = kScaled ? ks + ((static_cast<size_t>(li) * B + b) * Hkv + j) * S : nullptr;
  float* vs_row = kScaled ? vs + ((static_cast<size_t>(li) * B + b) * Hkv + j) * S : nullptr;

  __shared__ float red[4];
  __shared__ float Qs[kMaxGroup][D];
  __shared__ float Ks[kSlots][D + 1];  // +1: conflict-free reads by slot
  __shared__ float Vs[kSlots][D];
  __shared__ float Ps[kMaxGroup][kSlots];
  __shared__ float alpha_s[kMaxGroup];
  __shared__ int kok_s[kSlots];
  __shared__ float ksc_s[kSlots], vsc_s[kSlots];

  // ---- 1. write this step's K/V, by the block whose span holds the slot ----
  const int slot = kWrite ? write_slot[b] : -1;
  if (kWrite && slot >= lo && slot < lo + kSpan) {  // uniform over the block
    const size_t src = (static_cast<size_t>(b) * Hkv + j) * D + tid;
    const size_t dst = static_cast<size_t>(slot) * HD + j * D + tid;
    if constexpr (kScaled) {
      const float xkf = __bfloat162float(xk[src]);
      const float xvf = __bfloat162float(xv[src]);
      const float sk = fmaxf(block_max(fabsf(xkf), red) / 127.f, 1e-8f);
      const float sv = fmaxf(block_max(fabsf(xvf), red) / 127.f, 1e-8f);
      ck_row[dst] = static_cast<int8_t>(fminf(fmaxf(rintf(xkf / sk), -127.f), 127.f));
      cv_row[dst] = static_cast<int8_t>(fminf(fmaxf(rintf(xvf / sv), -127.f), 127.f));
      if (tid == 0) {
        ks_row[slot] = sk;
        vs_row[slot] = sv;
      }
    } else {
      ck_row[dst] = xk[src];
      cv_row[dst] = xv[src];
    }
  }

  // ---- 2. the query heads and this block's live slots ----
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
    if (g < G) Qs[g][tid] = __bfloat162float(xq[(static_cast<size_t>(b) * H + j * G + g) * D + tid]);
  __syncthreads();  // orders the ring write before every read below
  const int qp = q_pos[b];
  int hi = min(lo + kSpan, S);
  if constexpr (kWrite) {
    hi = min(hi, min(qp + 1, window));
  } else {
    static_assert(kSpan == kDecThreads, "one thread asks for each slot of the span");
    const int s = lo + tid;
    bool seen = false;
    if (s < S) {
      const int delta = qp - kv_pos[static_cast<size_t>(b) * S + s];
      seen = kv_valid[static_cast<size_t>(b) * S + s] && delta >= 0 && delta < window;
    }
    if (!__syncthreads_or(seen)) hi = lo;  // an empty partial: acc = 0, m = kNegInf, l = 0
  }

  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;

  // ---- 3. attend over [lo, hi) ----
  for (int s0 = lo; s0 < hi; s0 += kSlots) {
    __syncthreads();  // the previous tile's PV is done with Vs and Ps
    for (int e = tid; e < kSlots * D / 8; e += kDecThreads) {
      const int c = e / (D / 8), d0 = (e % (D / 8)) * 8;
      float xk8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float xv8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (s0 + c < hi) {
        const size_t off = static_cast<size_t>(s0 + c) * HD + j * D + d0;
        load8(ck_row + off, xk8);
        load8(cv_row + off, xv8);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        Ks[c][d0 + i] = xk8[i];
        Vs[c][d0 + i] = xv8[i];
      }
    }
    if (tid < kSlots) {
      const int s = s0 + tid;
      bool ok = false;
      float a = 0.f, bb = 0.f;
      if (s < hi) {
        const int delta = qp - kv_pos[static_cast<size_t>(b) * S + s];
        ok = kv_valid[static_cast<size_t>(b) * S + s] && delta >= 0 && delta < window;
        if (kScaled) {
          a = ks_row[s];
          bb = vs_row[s];
        }
      }
      kok_s[tid] = ok;
      ksc_s[tid] = a;
      vsc_s[tid] = bb;
    }
    __syncthreads();

#pragma unroll
    for (int k2 = 0; k2 < 2; ++k2) {
      const int g = w + 4 * k2;
      if (g < G) {  // uniform over the warp
        float sc = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) sc = fmaf(Qs[g][d], Ks[lane][d], sc);
        sc *= kScaled ? ksc_s[lane] * scale : scale;
        const bool ok = kok_s[lane];
        const float mx = group_max(ok ? sc : kNegInf, 32);
        const float m_new = fmaxf(m_r[k2], mx);
        const float alpha = m_r[k2] > 0.5f * kNegInf ? expf(m_r[k2] - m_new) : 0.f;
        const float p = ok ? expf(sc - m_new) : 0.f;
        l_r[k2] = alpha * l_r[k2] + group_sum(p, 32);
        m_r[k2] = m_new;
        Ps[g][lane] = round_bf16(kScaled ? p * vsc_s[lane] : p);
        if (lane == 0) alpha_s[g] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < G) {
        float a = acc[g] * alpha_s[g];
#pragma unroll 8
        for (int c = 0; c < kSlots; ++c) a = fmaf(Ps[g][c], Vs[c][tid], a);
        acc[g] = a;
      }
    }
  }

  // ---- 4. this span's partial per query head ----
  const size_t head0 = static_cast<size_t>(b) * H + j * G;
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
    if (g < G) part_acc[((head0 + g) * nspan + span) * D + tid] = acc[g];
  if (lane == 0) {
#pragma unroll
    for (int k2 = 0; k2 < 2; ++k2) {
      const int g = w + 4 * k2;
      if (g < G) {
        part_ml[((head0 + g) * nspan + span) * 2] = m_r[k2];
        part_ml[((head0 + g) * nspan + span) * 2 + 1] = l_r[k2];
      }
    }
  }
}

// One block per (query head, row): softmax-weighted merge of the spans'
// partials, out = sum_i e^(m_i - M) acc_i / sum_i e^(m_i - M) l_i, and 0
// for a row that sees no slot.
__global__ void __launch_bounds__(kDecThreads) decode_merge_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    __nv_bfloat16* __restrict__ out, int H, int nspan) {
  constexpr int D = kHeadDim;
  const size_t head = static_cast<size_t>(blockIdx.y) * H + blockIdx.x;
  const float* ml = part_ml + head * nspan * 2;
  float M = kNegInf;
  for (int i = 0; i < nspan; ++i) M = fmaxf(M, ml[2 * i]);
  float L = 0.f, A = 0.f;
  for (int i = 0; i < nspan; ++i) {
    const float l = ml[2 * i + 1];
    if (l > 0.f) {
      const float e = expf(ml[2 * i] - M);
      L += e * l;
      A += e * part_acc[(head * nspan + i) * D + threadIdx.x];
    }
  }
  out[head * D + threadIdx.x] = __float2bfloat16_rn(L > 0.f ? A / L : 0.f);
}

template <typename KT, bool kScaled, bool kWrite>
int launch_fused_decode(const void* xq, const void* xk, const void* xv, void* ck, void* cv,
                        void* ks, void* vs, int li, int window, const void* write_slot,
                        const void* q_pos, const void* kv_pos, const void* kv_valid,
                        void* out, void* part_acc, void* part_ml, int B, int S, int H,
                        int Hkv, float scale, void* stream) {
  if (H % Hkv != 0 || H / Hkv > kMaxGroup) return cudaErrorInvalidValue;
  const int nspan = (S + kSpan - 1) / kSpan;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  fused_decode_kernel<KT, kScaled, kWrite><<<dim3(nspan, Hkv, B), kDecThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(xq), static_cast<const __nv_bfloat16*>(xk),
      static_cast<const __nv_bfloat16*>(xv), static_cast<KT*>(ck), static_cast<KT*>(cv),
      static_cast<float*>(ks), static_cast<float*>(vs), li, window,
      static_cast<const int*>(write_slot), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<const uint8_t*>(kv_valid),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), B, S, H, Hkv, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<<<dim3(H, B), kDecThreads, 0, st>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<__nv_bfloat16*>(out), H, nspan);
  return cudaGetLastError();
}

}  // namespace mit

// Ring slots per block, so that the caller can size the partials:
// part_acc (B, H, nspan, D) and part_ml (B, H, nspan, 2) fp32 with
// nspan = ceil(S / fused_decode_span()).
extern "C" int fused_decode_span() { return mit::kSpan; }

extern "C" int fused_decode_int8(const void* xq, const void* xk, const void* xv, void* ck,
                                 void* cv, void* ks, void* vs, int li, int window,
                                 const void* write_slot, const void* q_pos,
                                 const void* kv_pos, const void* kv_valid, void* out,
                                 void* part_acc, void* part_ml, int B, int S, int H, int Hkv,
                                 float scale, void* stream) {
  return mit::launch_fused_decode<int8_t, true, true>(xq, xk, xv, ck, cv, ks, vs, li, window,
                                                write_slot, q_pos, kv_pos, kv_valid, out,
                                                part_acc, part_ml, B, S, H, Hkv, scale,
                                                stream);
}

extern "C" int fused_decode_bf16(const void* xq, const void* xk, const void* xv, void* ck,
                                 void* cv, int li, int window, const void* write_slot,
                                 const void* q_pos, const void* kv_pos,
                                 const void* kv_valid, void* out, void* part_acc,
                                 void* part_ml, int B, int S, int H, int Hkv, float scale,
                                 void* stream) {
  return mit::launch_fused_decode<__nv_bfloat16, false, true>(
      xq, xk, xv, ck, cv, nullptr, nullptr, li, window, write_slot, q_pos, kv_pos,
      kv_valid, out, part_acc, part_ml, B, S, H, Hkv, scale, stream);
}

// K6: the ring is only read (the pointers are not const because the kernel
// template is shared with the writing instantiation).
extern "C" int decode_attention_int8(const void* xq, void* ck, void* cv, void* ks, void* vs,
                                     int li, int window, const void* q_pos, const void* kv_pos,
                                     const void* kv_valid, void* out, void* part_acc,
                                     void* part_ml, int B, int S, int H, int Hkv, float scale,
                                     void* stream) {
  return mit::launch_fused_decode<int8_t, true, false>(
      xq, nullptr, nullptr, ck, cv, ks, vs, li, window, nullptr, q_pos, kv_pos, kv_valid, out,
      part_acc, part_ml, B, S, H, Hkv, scale, stream);
}

extern "C" int decode_attention_bf16(const void* xq, void* ck, void* cv, int li, int window,
                                     const void* q_pos, const void* kv_pos,
                                     const void* kv_valid, void* out, void* part_acc,
                                     void* part_ml, int B, int S, int H, int Hkv, float scale,
                                     void* stream) {
  return mit::launch_fused_decode<__nv_bfloat16, false, false>(
      xq, nullptr, nullptr, ck, cv, nullptr, nullptr, li, window, nullptr, q_pos, kv_pos,
      kv_valid, out, part_acc, part_ml, B, S, H, Hkv, scale, stream);
}
