// K2: one decode step's ring write and ring-only attention, fused; and K7,
// the write and the attention for the T <= 8 candidate tokens of a
// speculative verify chunk. One kernel template serves the two. (K6, the
// same attention with no write, runs decode_hopper.cuh.)
//
// K2 replaces mistral_inference_tpu/ops/pallas/attention.py::
// fused_update_decode_attention (kernel _fused_decode_kernel, tile loop
// _fused_tile_attend). K7 replaces ::fused_verify_chunk_attention (kernel
// _fused_verify_kernel): K2 is its T = 1 case. Each is instantiated for an
// int8 ring, an e4m3 (float8_e4m3fn) ring, both with fp32 scales per (slot,
// kv head), and a bf16 ring; the TPU kernels take the same three. The TPU kernel's 16-slot
// read-modify-write groups, lane-aligned scale windows and DMA semaphores
// exist because a TPU DMA moves aligned tiles; a CUDA thread stores a byte
// where it wants, so none of that is here.
//
// Function, for T query tokens per row (T = 1 for K2): quantize the
// chunk's K and V per (token, kv head) and write token t into slot
// write_slot[b] + t of layer li of the stacked ring, in place (write_slot =
// -1 writes nothing for that row); then attend each query head of each token
// over its KV head's ring slots with 0 <= q_pos[b, t] - kv_pos < window and
// kv_valid, scales applied after the dots. kv_pos and kv_valid come from
// cache.slot_positions after the write, so a row's slots at or past its fill
// min(q_pos[b, 0] + T, window) are never visible and are skipped, and query
// t does not see the candidates after it: their positions are larger than
// its own. The T slots never wrap (the caller's precondition: a ring that
// holds every position it has been given), so a candidate that is later
// rejected stays in its slot, hidden by the caller's kv_len, until the real
// token of that position overwrites it.
//
// Design: the ring is cut into spans of kSpan slots, and one block of 128
// threads runs per (span, kv head, batch row), so a B = 4 step over a 4096-slot
// ring fills the card with 1024 blocks; thread d owns head-dim element d. The
// write comes first. The T slots can straddle two spans (slot0 = 126, T = 5):
// each block writes those of the T slots that lie in its own span. The
// quantized rings follow cache._quantize_ring bit for bit (RingRule below):
// scale = fp32 absmax / qmax with a floor of 1e-8 and IEEE division (this
// file must not be built with fast-math), then for int8 (qmax 127) rintf =
// round half to even and a clip to +-127, and for e4m3 (qmax 448) x / scale
// converted with round to nearest even, saturating at +-448 as PyTorch's cast
// does; |x / scale| exceeds 448 by a rounding at most. A (token, head) scale depends
// only on this block's head, so the block that writes a slot's bytes for head
// j is the only block that ever reads them, and __syncthreads() orders the
// write before the reads: no other block touches this row's head-j columns in
// this span. Each block then streams its span in 32-slot tiles through shared
// memory, ONCE for all its G * T query rows (row r = t * G + g): warp w
// scores rows w, w + 4, ... (one slot per lane) with a running max and sum per
// row, and the PV product runs with one output column per thread and one
// accumulator per row. The block leaves an unnormalized partial (acc, m, l)
// per query row, and a second kernel merges the spans of each (row, token,
// head) exactly.
//
// Every query row goes through the same spans, the same 32-slot tiles and the
// same sums in the same order whatever T is and whichever warp takes it: a
// slot the row does not see adds an exact 0 to its sums. So query t of a K7
// launch has the bits of a K2 launch at that position over the same ring, and
// greedy speculation can agree with plain greedy decoding token for token.
//
// kRows, the rows a block has room for, is a template parameter (shared
// memory and accumulator registers grow with it), chosen at launch as the
// smallest instantiated value that holds G * T.
//
// What bounds it on the H100: bytes. Each call reads each row's visible
// slots of K and V once (int8, e4m3 or bf16) plus scales, and does 4 * D flops per
// (query row, slot): about 4 * T flops per byte, at most 32, far below the
// 295 flop/byte ridge. Reading each KV head's slots once for all G * T query
// rows (a loop of T single-token launches would read them T times), and
// spreading the ring over enough blocks to keep every SM loading, is what the
// design does about it.
#include "common.cuh"

namespace mit {

constexpr int kDecThreads = 128;  // one thread per head-dim element
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kSlots = 32;        // ring slots per tile, one per lane
constexpr int kSpan = 128;        // ring slots per block
constexpr int kMaxRows = 32;      // query rows (heads per KV head x tokens) per block
constexpr int kMaxTokens = 8;     // tokens of a verify chunk

// The write rule of a quantized ring element type: its qmax, and x / scale
// to the stored value.
template <typename KT>
struct RingRule;

template <>
struct RingRule<int8_t> {
  static constexpr float kQmax = 127.f;
  static __device__ __forceinline__ int8_t quantize(float y) {
    return static_cast<int8_t>(fminf(fmaxf(rintf(y), -127.f), 127.f));
  }
};

template <>
struct RingRule<__nv_fp8_e4m3> {
  static constexpr float kQmax = 448.f;
  static __device__ __forceinline__ __nv_fp8_e4m3 quantize(float y) {
    __nv_fp8_e4m3 q;
    q.__x = __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
    return q;
  }
};

__device__ __forceinline__ float block_max(float x, float* red) {
  x = group_max(x, 32);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  const float r = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  __syncthreads();
  return r;
}

// A block's shared memory. Above 48 KB (kRows = 32) it is dynamic shared
// memory, so every instantiation takes it that way.
template <int kRows>
struct DecodeSmem {
  float Qs[kRows][kHeadDim];
  float Ks[kSlots][kHeadDim + 1];  // +1: conflict-free reads by slot
  float Vs[kSlots][kHeadDim];
  float Ps[kRows][kSlots];
  float alpha[kRows];
  int qpos[kRows];
  int head[kRows];   // (b * T + t) * H + query head, of each row
  int token[kRows];  // t of each row
  int tpos[kMaxTokens];  // q_pos[b, t]
  float red[4];
  int kpos[kSlots];
  int kval[kSlots];
  float ksc[kSlots], vsc[kSlots];
};

// Partials: part_acc (B, T, H, nspan, D) unnormalized sums, part_ml
// (B, T, H, nspan, 2) running max and sum; a span with no visible slot leaves
// acc = 0, m = kNegInf, l = 0.
template <typename KT, bool kScaled, int kRows>
__global__ void __launch_bounds__(kDecThreads) fused_decode_kernel(
    const __nv_bfloat16* __restrict__ xq, const __nv_bfloat16* __restrict__ xk,
    const __nv_bfloat16* __restrict__ xv, KT* ck, KT* cv, float* ks, float* vs, int li,
    int window, const int* __restrict__ write_slot, const int* __restrict__ q_pos,
    const int* __restrict__ kv_pos, const uint8_t* __restrict__ kv_valid,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int B, int T, int S, int H,
    int Hkv, float scale) {
  constexpr int D = kHeadDim;
  constexpr int kRW = kRows / kDecWarps;  // rows per warp
  static_assert(kRows % kDecWarps == 0, "rows are dealt to the warps in turn");
  const int span = blockIdx.x, nspan = gridDim.x, j = blockIdx.y, b = blockIdx.z;
  const int lo = span * kSpan;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int G = H / Hkv;
  const int R = G * T;  // live query rows, r = t * G + g
  const size_t HD = static_cast<size_t>(Hkv) * D;
  // Layer li, batch row b. The ring is read and written through these plain
  // (non-restrict) pointers, so no load takes the non-coherent path.
  KT* ck_row = ck + (static_cast<size_t>(li) * B + b) * S * HD;
  KT* cv_row = cv + (static_cast<size_t>(li) * B + b) * S * HD;
  float* ks_row = kScaled ? ks + ((static_cast<size_t>(li) * B + b) * Hkv + j) * S : nullptr;
  float* vs_row = kScaled ? vs + ((static_cast<size_t>(li) * B + b) * Hkv + j) * S : nullptr;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  DecodeSmem<kRows>& sm = *reinterpret_cast<DecodeSmem<kRows>*>(smem_raw);

  // ---- 1. write the chunk's K/V: each block the slots that lie in its span ----
  const int slot0 = write_slot[b];
  if (slot0 >= 0) {
    for (int t = 0; t < T; ++t) {
      const int slot = slot0 + t;
      if (slot < lo || slot >= lo + kSpan || slot >= S) continue;  // uniform over the block
      const size_t src = ((static_cast<size_t>(b) * T + t) * Hkv + j) * D + tid;
      const size_t dst = static_cast<size_t>(slot) * HD + j * D + tid;
      if constexpr (kScaled) {
        const float xkf = __bfloat162float(xk[src]);
        const float xvf = __bfloat162float(xv[src]);
        using Rule = RingRule<KT>;
        const float sk = fmaxf(block_max(fabsf(xkf), sm.red) / Rule::kQmax, 1e-8f);
        const float sv = fmaxf(block_max(fabsf(xvf), sm.red) / Rule::kQmax, 1e-8f);
        ck_row[dst] = Rule::quantize(xkf / sk);
        cv_row[dst] = Rule::quantize(xvf / sv);
        if (tid == 0) {
          ks_row[slot] = sk;
          vs_row[slot] = sv;
        }
      } else {
        ck_row[dst] = xk[src];
        cv_row[dst] = xv[src];
      }
    }
  }

  // ---- 2. the query rows and this block's live slots ----
  {
    int t = 0, g = 0;  // row r = t * G + g, stepped without a division
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float qv = 0.f;  // rows past R score zeros and are never read back
      if (r < R) {
        const int head = (b * T + t) * H + j * G + g;  // of out and of the partials
        qv = __bfloat162float(xq[static_cast<size_t>(head) * D + tid]);
        if (tid == 0) {
          sm.head[r] = head;
          sm.token[r] = t;
        }
      }
      sm.Qs[r][tid] = qv;
      if (tid == 0) sm.alpha[r] = 1.f;
      if (++g == G) g = 0, ++t;
    }
  }
  if (tid < T) sm.tpos[tid] = q_pos[b * T + tid];
  // Rows past R keep P = 0 and alpha = 1, so their accumulators stay 0.
  for (int e = R * kSlots + tid; e < kRows * kSlots; e += kDecThreads)
    sm.Ps[e / kSlots][e % kSlots] = 0.f;
  __syncthreads();  // orders the ring write before every read below
  // Each row's query position; the tile loop's first barrier publishes it.
  if (tid < R) sm.qpos[tid] = sm.tpos[sm.token[tid]];
  const int qp0 = sm.tpos[0];
  const int hi = min(min(lo + kSpan, S), min(qp0 + T, window));

  float m_r[kRW], l_r[kRW];
#pragma unroll
  for (int k = 0; k < kRW; ++k) m_r[k] = kNegInf, l_r[k] = 0.f;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

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
        sm.Ks[c][d0 + i] = xk8[i];
        sm.Vs[c][d0 + i] = xv8[i];
      }
    }
    if (tid < kSlots) {
      const int s = s0 + tid;
      int pos = 0, ok = 0;
      float a = 0.f, bb = 0.f;
      if (s < hi) {
        pos = kv_pos[static_cast<size_t>(b) * S + s];
        ok = kv_valid[static_cast<size_t>(b) * S + s];
        if (kScaled) {
          a = ks_row[s];
          bb = vs_row[s];
        }
      }
      sm.kpos[tid] = pos;
      sm.kval[tid] = ok;
      sm.ksc[tid] = a;
      sm.vsc[tid] = bb;
    }
    __syncthreads();

    // Scores: this lane's slot against the warp's rows, the slot's K read
    // once for all of them; each row's dot runs over d in order.
    float sc[kRW];
#pragma unroll
    for (int k = 0; k < kRW; ++k) sc[k] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = sm.Ks[lane][d];
#pragma unroll
      for (int k = 0; k < kRW; ++k) sc[k] = fmaf(sm.Qs[w + kDecWarps * k][d], kd, sc[k]);
    }
#pragma unroll
    for (int k = 0; k < kRW; ++k) {
      const int r = w + kDecWarps * k;
      if (r < R) {  // uniform over the warp
        const float s = sc[k] * (kScaled ? sm.ksc[lane] * scale : scale);
        const int delta = sm.qpos[r] - sm.kpos[lane];
        const bool ok = sm.kval[lane] && delta >= 0 && delta < window;
        const float mx = group_max(ok ? s : kNegInf, 32);
        const float m_new = fmaxf(m_r[k], mx);
        const float alpha = m_r[k] > 0.5f * kNegInf ? expf(m_r[k] - m_new) : 0.f;
        const float p = ok ? expf(s - m_new) : 0.f;
        l_r[k] = alpha * l_r[k] + group_sum(p, 32);
        m_r[k] = m_new;
        sm.Ps[r][lane] = round_bf16(kScaled ? p * sm.vsc[lane] : p);
        if (lane == 0) sm.alpha[r] = alpha;
      }
    }
    __syncthreads();

    // PV: this thread's column of V read once per slot for all rows; each
    // row's sum runs over the tile's slots in order.
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] *= sm.alpha[r];
#pragma unroll 8
    for (int c = 0; c < kSlots; ++c) {
      const float vc = sm.Vs[c][tid];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(sm.Ps[r][c], vc, acc[r]);
    }
  }

  // ---- 4. this span's partial per query row ----
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (r < R) part_acc[(static_cast<size_t>(sm.head[r]) * nspan + span) * D + tid] = acc[r];
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kRW; ++k) {
      const int r = w + kDecWarps * k;
      if (r < R) {
        const size_t at = (static_cast<size_t>(sm.head[r]) * nspan + span) * 2;
        part_ml[at] = m_r[k];
        part_ml[at + 1] = l_r[k];
      }
    }
  }
}

// One block per (query head, row and token): softmax-weighted merge of the
// spans' partials, out = sum_i e^(m_i - M) acc_i / sum_i e^(m_i - M) l_i, and
// 0 for a query that sees no slot.
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

template <typename KT, bool kScaled, int kRows>
cudaError_t launch_rows(const void* xq, const void* xk, const void* xv, void* ck, void* cv,
                        void* ks, void* vs, int li, int window, const void* write_slot,
                        const void* q_pos, const void* kv_pos, const void* kv_valid,
                        void* part_acc, void* part_ml, int B, int T, int S, int H, int Hkv,
                        float scale, int nspan, cudaStream_t st) {
  auto kernel = fused_decode_kernel<KT, kScaled, kRows>;
  constexpr size_t smem = sizeof(DecodeSmem<kRows>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(nspan, Hkv, B), kDecThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(xq), static_cast<const __nv_bfloat16*>(xk),
      static_cast<const __nv_bfloat16*>(xv), static_cast<KT*>(ck), static_cast<KT*>(cv),
      static_cast<float*>(ks), static_cast<float*>(vs), li, window,
      static_cast<const int*>(write_slot), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<const uint8_t*>(kv_valid),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), B, T, S, H, Hkv, scale);
  return cudaGetLastError();
}

template <typename KT, bool kScaled>
int launch_fused_decode(const void* xq, const void* xk, const void* xv, void* ck, void* cv,
                        void* ks, void* vs, int li, int window, const void* write_slot,
                        const void* q_pos, const void* kv_pos, const void* kv_valid,
                        void* out, void* part_acc, void* part_ml, int B, int T, int S, int H,
                        int Hkv, float scale, void* stream) {
  if (H % Hkv != 0 || T < 1 || T > kMaxTokens) return cudaErrorInvalidValue;
  const int R = H / Hkv * T;
  if (R > kMaxRows) return cudaErrorInvalidValue;
  const int nspan = (S + kSpan - 1) / kSpan;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define MIT_DECODE_ROWS(n)                                                                   \
  launch_rows<KT, kScaled, n>(xq, xk, xv, ck, cv, ks, vs, li, window, write_slot,   \
                                      q_pos, kv_pos, kv_valid, part_acc, part_ml, B, T, S,  \
                                      H, Hkv, scale, nspan, st)
  if (R <= 4) {
    err = MIT_DECODE_ROWS(4);
  } else if (R <= 8) {
    err = MIT_DECODE_ROWS(8);
  } else if (R <= 16) {
    err = MIT_DECODE_ROWS(16);
  } else if (R <= 20) {
    err = MIT_DECODE_ROWS(20);
  } else {
    err = MIT_DECODE_ROWS(kMaxRows);
  }
#undef MIT_DECODE_ROWS
  if (err != cudaSuccess) return err;
  decode_merge_kernel<<<dim3(H, B * T), kDecThreads, 0, st>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<__nv_bfloat16*>(out), H, nspan);
  return cudaGetLastError();
}

}  // namespace mit

// Ring slots per block, so that the caller can size the partials:
// part_acc (B, T, H, nspan, D) and part_ml (B, T, H, nspan, 2) fp32 with
// nspan = ceil(S / fused_decode_span()).
extern "C" int fused_decode_span() { return mit::kSpan; }

extern "C" int fused_decode_int8(const void* xq, const void* xk, const void* xv, void* ck,
                                 void* cv, void* ks, void* vs, int li, int window,
                                 const void* write_slot, const void* q_pos,
                                 const void* kv_pos, const void* kv_valid, void* out,
                                 void* part_acc, void* part_ml, int B, int S, int H, int Hkv,
                                 float scale, void* stream) {
  return mit::launch_fused_decode<int8_t, true>(xq, xk, xv, ck, cv, ks, vs, li, window,
                                                write_slot, q_pos, kv_pos, kv_valid, out,
                                                part_acc, part_ml, B, 1, S, H, Hkv, scale,
                                                stream);
}

// The e4m3 ring: the int8 entry points' arguments, KT = __nv_fp8_e4m3.
extern "C" int fused_decode_fp8(const void* xq, const void* xk, const void* xv, void* ck,
                                void* cv, void* ks, void* vs, int li, int window,
                                const void* write_slot, const void* q_pos, const void* kv_pos,
                                const void* kv_valid, void* out, void* part_acc,
                                void* part_ml, int B, int S, int H, int Hkv, float scale,
                                void* stream) {
  return mit::launch_fused_decode<__nv_fp8_e4m3, true>(
      xq, xk, xv, ck, cv, ks, vs, li, window, write_slot, q_pos, kv_pos, kv_valid, out,
      part_acc, part_ml, B, 1, S, H, Hkv, scale, stream);
}

extern "C" int fused_decode_bf16(const void* xq, const void* xk, const void* xv, void* ck,
                                 void* cv, int li, int window, const void* write_slot,
                                 const void* q_pos, const void* kv_pos,
                                 const void* kv_valid, void* out, void* part_acc,
                                 void* part_ml, int B, int S, int H, int Hkv, float scale,
                                 void* stream) {
  return mit::launch_fused_decode<__nv_bfloat16, false>(
      xq, xk, xv, ck, cv, nullptr, nullptr, li, window, write_slot, q_pos, kv_pos,
      kv_valid, out, part_acc, part_ml, B, 1, S, H, Hkv, scale, stream);
}

// K7: xq (B, T, H, D), xk and xv (B, T, Hkv, D), write_slot0 (B,), q_pos
// (B, T), out (B, T, H * D); T <= kMaxTokens and H / Hkv * T <= kMaxRows.
extern "C" int fused_verify_int8(const void* xq, const void* xk, const void* xv, void* ck,
                                 void* cv, void* ks, void* vs, int li, int window,
                                 const void* write_slot0, const void* q_pos,
                                 const void* kv_pos, const void* kv_valid, void* out,
                                 void* part_acc, void* part_ml, int B, int T, int S, int H,
                                 int Hkv, float scale, void* stream) {
  return mit::launch_fused_decode<int8_t, true>(xq, xk, xv, ck, cv, ks, vs, li, window,
                                                write_slot0, q_pos, kv_pos, kv_valid, out,
                                                part_acc, part_ml, B, T, S, H, Hkv, scale,
                                                stream);
}

extern "C" int fused_verify_fp8(const void* xq, const void* xk, const void* xv, void* ck,
                                void* cv, void* ks, void* vs, int li, int window,
                                const void* write_slot0, const void* q_pos, const void* kv_pos,
                                const void* kv_valid, void* out, void* part_acc,
                                void* part_ml, int B, int T, int S, int H, int Hkv,
                                float scale, void* stream) {
  return mit::launch_fused_decode<__nv_fp8_e4m3, true>(
      xq, xk, xv, ck, cv, ks, vs, li, window, write_slot0, q_pos, kv_pos, kv_valid, out,
      part_acc, part_ml, B, T, S, H, Hkv, scale, stream);
}

extern "C" int fused_verify_bf16(const void* xq, const void* xk, const void* xv, void* ck,
                                 void* cv, int li, int window, const void* write_slot0,
                                 const void* q_pos, const void* kv_pos,
                                 const void* kv_valid, void* out, void* part_acc,
                                 void* part_ml, int B, int T, int S, int H, int Hkv,
                                 float scale, void* stream) {
  return mit::launch_fused_decode<__nv_bfloat16, false>(
      xq, xk, xv, ck, cv, nullptr, nullptr, li, window, write_slot0, q_pos, kv_pos,
      kv_valid, out, part_acc, part_ml, B, T, S, H, Hkv, scale, stream);
}
