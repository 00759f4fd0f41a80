// Decode attention for Hopper over one layer of the stacked KV ring: the one
// loop of K6 (read only), K2 (one decode step's ring write, then the
// attention) and K7 (the write of a speculative verify chunk's T <= 8
// candidate tokens, then the attention of all T queries).
//
// Function: for each batch row b, token t < T and query head h = j * G + g
// (KV head j, G = H / Hkv), softmax over the visible slots s of layer li of
// (q . k_s) * k_scale[s] * D^-1/2, times v_s * v_scale[s]. A slot is visible
// to token t when kv_valid[b, s] holds and 0 <= q_pos[b, t] - kv_pos[b, s] <
// window; kv_pos and kv_valid may be anything (a wrapped ring, holes), so no
// fill is assumed. A query that sees no slot returns 0. Layouts: q and out (B,
// T, H * D) bf16, the ring (L, B, S, Hkv * D) int8 or e4m3 with fp32 scales
// (L, B, Hkv, S), or bf16 without scales; q_pos (B, T), kv_pos (B, S) int32,
// kv_valid (B, S) bool. K6 has T = 1. Numerics: bf16 products of q and the
// ring's values (every int8 and e4m3 value is a bf16) summed in fp32 on the
// tensor cores, the key scale after the dot, p times the value scale rounded
// to bf16 before the PV product (the contract of the JAX package's
// kernels), the softmax in log2 units.
//
// The write (kWrite: K2, K7) comes first: token t of row b, xk and xv (B, T,
// Hkv, D) bf16, goes to slot write_slot[b] + t of layer li, in place
// (write_slot = -1 writes nothing for the row). The quantized rings follow
// cache._quantize_ring bit for bit (RingRule): scale = max(absmax / qmax,
// 1e-8) with IEEE division (no fast-math), then for int8 (qmax 127) rintf =
// round half to even and a clip to +-127, for e4m3 (qmax 448) a conversion
// with round to nearest even, saturating at +-448 as PyTorch's cast does. The
// caller's kv_pos and kv_valid describe the ring after the write.
//
// What bounds it on the H100: bytes. Each visible slot's K and V head
// segments (128 bytes each for int8 or e4m3, 256 for bf16) are read once for
// the G * T query rows, about 4 * G * T flops per byte against the card's 295
// flop/byte ridge; at B = 4 over a 4096-slot ring the visible ring is about
// 17 MB, 5.2 us at 3.35 TB/s. The walk over it is bound by latency, not by
// arithmetic: a warp's chain of dependent loads. The design keeps bytes in
// flight, spreads the slots over many warps and walks each slot once:
//
// - One thread-block cluster of kCluster blocks per (batch row, KV head).
//   The ring is cut into parts of kChunk = 64 slots at fixed places, and
//   part p goes to warp p % 64 of the cluster (warp p % 8 of block p / 8 %
//   8): at S = 4096 each warp has one part and block k the k-th slice of 512
//   slots. The parts do not depend on S, so a row's bits are the same in a
//   ring of any size (a decode step's ring in the serving engine, or one
//   sized to the prompt). A warp works alone until its walk is over.
// - The write is made by the warp whose part holds the slot: the T slots of
//   a verify chunk may fall to several warps and blocks. A (token, head) row
//   is one warp's work (a lane per four elements, the absmax by shuffles),
//   the loads of all its rows in flight at once; the ring's bytes and scales
//   are stored, fenced, and the warp's reads of them come after a
//   __syncwarp. Every other warp goes straight on.
// - Only visible slots are loaded. A warp reads the positions and validity
//   of up to kChunk of its slots at once and compacts the slots that any
//   token sees into a list in shared memory (ballot and popcount), with a
//   mask of the rows that see each; so holes, a window shorter than the ring
//   and a short fill cost no loads and no arithmetic.
// - The list's K then V stream through one ring of kStages 2 KB stages a
//   warp by cp.async (16 bytes a copy, kStages - 1 transfers in flight; the
//   V transfers start while the softmax runs; a deeper ring for the
//   one-block-an-SM instantiations was slower). Both products run on the
//   tensor cores (mma.sync m16n8k16, bf16 in, fp32 sums), the query rows r =
//   t * G + g as the n dimension in tiles of 8 (kNT tiles of kRG rows; kRG =
//   4 pads a tile of K6's and K2's four heads): S^T = K Q^T with the slots as
//   m and the dimensions as k, the int8 or e4m3 K widened exactly to bf16 in
//   registers; then the chunk's softmax a row tile at a time, a lane per
//   slot; then O^T = V^T P^T with the dimensions as m and the slots as k. A
//   warp holds kNT x 32 fp32 accumulators: one tile keeps K6's two or three
//   blocks an SM, four tiles (K7 at 32 rows) take one block an SM and two
//   waves of clusters at B = 4, but walk the ring once for every row.
// - The partials merge inside the cluster: the block's warps through shared
//   memory, a row tile at a time, then the cluster's blocks through
//   distributed shared memory (block k of the cluster merges rows k, k + 8,
//   ...), in a fixed order. One launch, no partials in device memory.
//
// Determinism, batch invariance and one function for the three kernels: no
// atomics, and every sum runs in an order fixed by the parts, the row's own
// visibility (the lists) and the lanes, so a row's bits do not depend on B,
// on S or on the other rows. A row's products, softmax and merges
// are the same instructions in every instantiation, whatever tile and column
// the row takes (explicit fmaf and __fmul_rn, nothing left to contraction).
// A slot in the list that a row does not see adds an exact 0 to it: its
// logit is -inf, its p is +0, the row's maximum and sum do not move and its
// rescale factor is exactly 1. So K2 gives the bits of K6 over the ring K2
// has written; and, where no window cuts (K7's precondition: a verify ring
// that never wraps), the slots a K2 step at position p + t sees are a prefix
// of each warp's list in a K7 launch, the candidates after t coming after
// them, so K7's query t has the bits of that K2 step, and greedy
// speculation equals plain greedy decoding.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace mit {
namespace decode {

namespace cg = cooperative_groups;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCluster = 8;        // blocks per (batch row, KV head): the portable cluster size
constexpr int kChunk = 64;         // slots a warp compacts at a time, 2 a lane
constexpr int kStageBytes = 2048;  // one transfer: 32 slots x 64 bytes of K, or whole V rows
constexpr int kStages = 3;
constexpr int kPartBytes = 64;     // bytes of a K row a score transfer carries
constexpr int kMaxTokens = 8;      // tokens of a verify chunk
constexpr int kMaxRows = 32;       // query rows (query heads per KV head x tokens)
constexpr float kLog2e = 1.4426950408889634f;

// The write rule of a quantized ring element type: its qmax, and the stored
// byte of x / scale.
template <typename KT>
struct RingRule;

template <>
struct RingRule<int8_t> {
  static constexpr float kQmax = 127.f;
  static __device__ __forceinline__ uint32_t bits(float y) {
    return static_cast<uint8_t>(static_cast<int8_t>(fminf(fmaxf(rintf(y), -127.f), 127.f)));
  }
};

template <>
struct RingRule<__nv_fp8_e4m3> {
  static constexpr float kQmax = 448.f;
  static __device__ __forceinline__ uint32_t bits(float y) {
    return __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
  }
};

// Shared memory of a block whose warps hold kNT tiles of kRG query rows
// (kRows = kRG * kNT). A warp's stage ring holds its output partial, one row
// tile at a time, after the walk. The rows of q, of the dots and of the
// probabilities are padded so that the lanes' fragment accesses do not share
// a bank; a row tile's probabilities take the place of its dots.
template <int kRG, int kNT>
struct Smem {
  static constexpr int kRows = kRG * kNT;
  static constexpr int kQRows = 8 * kNT;         // q rows of the fragments (zeros past kRows)
  static constexpr int kQStride = kHeadDim + 4;  // bf16 elements a q row
  static constexpr int kDStride = kChunk + 4;    // floats a row of dots
  static constexpr int kPStride = kChunk + 8;    // bf16 elements a probability row
  static constexpr int kRing = 0;  // kWarps x kStages x kStageBytes
  static constexpr int kList = kRing + kWarps * kStages * kStageBytes;  // int [kWarps][kChunk]
  static constexpr int kRowm = kList + kWarps * kChunk * 4;  // unsigned [kWarps][kChunk]
  // float dots [kWarps][kRows][kDStride]; a tile's bf16 p [kRG][kPStride] over its dots
  static constexpr int kPv = kRowm + kWarps * kChunk * 4;
  static constexpr int kPvBytes = kRows * kDStride * 4;  // a warp's
  static constexpr int kQ = kPv + kWarps * kPvBytes;   // bf16 q [kQRows][kQStride]
  static constexpr int kWml = kQ + kQRows * kQStride * 2;     // float m, l [kWarps][2][kRows]
  static constexpr int kTpos = kWml + kWarps * 2 * kRows * 4;  // int q_pos[kMaxTokens], lo, hi
  // float m[kRows], l[kRows], acc[kRows][D]
  static constexpr int kBlock = kTpos + (kMaxTokens + 2) * 4;
  static constexpr int kBytes = kBlock + (2 + kHeadDim) * kRows * 4;
  static_assert(8 * kHeadDim * 4 <= kStages * kStageBytes, "a row tile's partial fits a ring");
  static_assert(kPStride * 2 <= kDStride * 4, "a tile's probabilities fit over its dots");
  static_assert(kRows <= kMaxRows && (kNT == 1 || kRG == 8), "whole row tiles");
};

// Four int8 or e4m3 values held in a word -> fp32, exactly.
template <typename KT>
__device__ __forceinline__ void widen_word(uint32_t w, float* f) {
  if constexpr (std::is_same<KT, int8_t>::value) {
    biased_bytes_to_float(w ^ 0x80808080u, 128.f, f);
  } else {
    const float2 a = e4m3x2_to_float2(w), b = e4m3x2_to_float2(w >> 16);
    f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
  }
}

// Two fp32 values exact in bf16 -> a bf16x2 word, the first in the low half.
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Byte k of the words w0 and w1 of int8 or e4m3 values -> their bf16 pair,
// exactly, the first in the low half.
template <typename KT>
__device__ __forceinline__ uint32_t byte_pair(uint32_t w0, uint32_t w1, int k) {
  if constexpr (std::is_same<KT, int8_t>::value) {
    // The biased-float trick of biased_bytes_to_float, one byte of each word.
    constexpr float kMagic = 8388608.f + 128.f;
    const float f0 = __uint_as_float(__byte_perm(w0 ^ 0x80808080u, 0x4B000000u, 0x7650 + k));
    const float f1 = __uint_as_float(__byte_perm(w1 ^ 0x80808080u, 0x4B000000u, 0x7650 + k));
    return pack_exact(f0 - kMagic, f1 - kMagic);
  } else {
    const float2 f = e4m3x2_to_float2(__byte_perm(w0, w1, k | ((4 + k) << 4)));
    return pack_exact(f.x, f.y);
  }
}

// Elements 4s .. 4s + 3 of the 16 bytes w of ring values -> the bf16 pairs
// (4s, 4s + 1) and (4s + 2, 4s + 3), exactly (every int8 and e4m3 value is
// a bf16). s is a constant after unrolling.
template <typename KT>
__device__ __forceinline__ void kstep_pairs(uint4 w, int s, uint32_t& lo, uint32_t& hi) {
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
  if constexpr (sizeof(KT) == 2) {
    lo = v[2 * s];
    hi = v[2 * s + 1];
  } else {
    float f[4];
    widen_word<KT>(v[s], f);
    lo = pack_exact(f[0], f[1]);
    hi = pack_exact(f[2], f[3]);
  }
}

// 2^x on the special-function unit (results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One warp writes one (token, KV head) row of D bf16 values into the ring at
// dst (the row's head segment of its slot), lane l holding elements 4l .. 4l
// + 3 in raw; for a scaled ring quantized by RingRule, its scale to
// *scale_at.
template <typename KT, bool kScaled>
__device__ __forceinline__ void write_row(uint2 raw, unsigned char* dst, float* scale_at,
                                          int lane) {
  if constexpr (!kScaled) {
    *reinterpret_cast<uint2*>(dst + 8 * lane) = raw;
  } else {
    using Rule = RingRule<KT>;
    const float f[4] = {__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xFFFF0000u),
                        __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xFFFF0000u)};
    // absmax is a maximum: any reduction order gives the same scale.
    const float a = group_max(
        fmaxf(fmaxf(fabsf(f[0]), fabsf(f[1])), fmaxf(fabsf(f[2]), fabsf(f[3]))), 32);
    const float s = fmaxf(a / Rule::kQmax, 1e-8f);
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) w |= Rule::bits(f[i] / s) << (8 * i);
    *reinterpret_cast<uint32_t*>(dst + 4 * lane) = w;
    if (lane == 0) *scale_at = s;
  }
}

// kWrite: write the chunk first (K2, K7). A warp holds kNT tiles of kRG query
// rows (kRG = 4 only with one tile).
template <typename KT, bool kScaled, bool kWrite, int kRG, int kNT>
__global__ void __launch_bounds__(kThreads, kNT > 1 ? 1 : kRG <= 4 ? 3 : 2)
    decode_hopper_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ xk,
    const __nv_bfloat16* __restrict__ xv, KT* ck, KT* cv, float* ks, float* vs, int li,
    int window, const int* __restrict__ write_slot, const int* __restrict__ q_pos,
    const int* __restrict__ kv_pos, const uint8_t* __restrict__ kv_valid,
    __nv_bfloat16* __restrict__ out, int B, int T, int S, int H, int Hkv, float scale) {
  using L = Smem<kRG, kNT>;
  constexpr int D = kHeadDim;
  constexpr int kRows = L::kRows;
  constexpr int kRowBytes = D * static_cast<int>(sizeof(KT));
  constexpr int kParts = kRowBytes / kPartBytes;          // score transfers per 32 slots
  constexpr int kVRows = kStageBytes / kRowBytes;         // V rows per transfer
  constexpr int kPartElems = kPartBytes / static_cast<int>(sizeof(KT));
  constexpr int kChunkElems = 16 / static_cast<int>(sizeof(KT));
  constexpr int kSteps = kChunkElems / 4;  // k-steps of 16 dimensions in a 64-byte part
  constexpr int kQStride = L::kQStride, kDStride = L::kDStride, kPStride = L::kPStride;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int j = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int fg = lane >> 2, fc = lane & 3;  // the lane's row and column in an mma fragment
  const int G = H / Hkv;
  const int R = G * T;  // query rows, r = t * G + g
  const size_t HD = static_cast<size_t>(Hkv) * D;
  const size_t lb = static_cast<size_t>(li) * B + b;
  // The ring is written and read through plain pointers: no load of it takes
  // the non-coherent path.
  unsigned char* ck_row = reinterpret_cast<unsigned char*>(ck + lb * S * HD + j * D);
  unsigned char* cv_row = reinterpret_cast<unsigned char*>(cv + lb * S * HD + j * D);
  const int row_stride = Hkv * kRowBytes;  // bytes from slot s to slot s + 1
  float* ks_row = kScaled ? ks + (lb * Hkv + j) * S : nullptr;
  float* vs_row = kScaled ? vs + (lb * Hkv + j) * S : nullptr;
  const int* pos_row = kv_pos + static_cast<size_t>(b) * S;
  const uint8_t* ok_row = kv_valid + static_cast<size_t>(b) * S;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + L::kRing + w * kStages * kStageBytes;
  int* list = reinterpret_cast<int*>(smem_raw + L::kList) + w * kChunk;
  unsigned* rowm = reinterpret_cast<unsigned*>(smem_raw + L::kRowm) + w * kChunk;
  float* pv = reinterpret_cast<float*>(smem_raw + L::kPv + w * L::kPvBytes);  // dots [row][idx]
  // p * v_scale of row tile nt, [kRG][kPStride], over the tile's dots
  auto pbt = [&](int nt) { return reinterpret_cast<__nv_bfloat16*>(pv + nt * kRG * kDStride); };
  const __nv_bfloat16* qb = reinterpret_cast<const __nv_bfloat16*>(smem_raw + L::kQ);
  float* wml = reinterpret_cast<float*>(smem_raw + L::kWml) + w * 2 * kRows;  // m[], l[]
  int* tpos = reinterpret_cast<int*>(smem_raw + L::kTpos);  // q_pos[t], then lo, hi
  float* bml = reinterpret_cast<float*>(smem_raw + L::kBlock);  // m[kRows], l[kRows], acc[][D]

  // The warp's parts of the ring: kChunk slots at fixed places, part p to
  // warp p % (kCluster * kWarps) of the cluster, so that no sum depends on S.
  constexpr int kRound = kCluster * kWarps * kChunk;  // slots from one part of a warp to its next
  const int s_lo = (rank * kWarps + w) * kChunk;      // the warp's first slot
  const float c2 = scale * kLog2e;

  // The positions and validity of a chunk's slots, lane holding slots c0 +
  // lane + 32 i; the first chunk's are on their way while q is staged.
  constexpr int kPer = kChunk / 32;
  int pos[kPer];
  bool see[kPer];
  auto load_vis = [&](int c0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int s = c0 + lane + 32 * i;
      see[i] = s < S && ok_row[s];
      pos[i] = s < S ? pos_row[s] : 0;
    }
  };
  load_vis(s_lo);

  // ---- the write: each slot by the warp whose part holds it ----
  if constexpr (kWrite) {
    const int ws = write_slot[b];
    // Token t is this warp's when its slot lies in one of the warp's parts.
    auto mine = [&](int t) {
      const int slot = ws + t;
      return t < T && slot < S && (slot - s_lo) % kRound < kChunk && slot >= s_lo;
    };
    bool any = false;
#pragma unroll
    for (int t = 0; t < kMaxTokens; ++t) any = any || mine(t);
    if (ws >= 0 && any) {
      // Every row's load is in flight before the first is used.
      uint2 rk[kMaxTokens], rv[kMaxTokens];
#pragma unroll
      for (int t = 0; t < kMaxTokens; ++t) {
        if (mine(t)) {
          const size_t src = (static_cast<size_t>(b * T + t) * Hkv + j) * D + 4 * lane;
          rk[t] = *reinterpret_cast<const uint2*>(xk + src);
          rv[t] = *reinterpret_cast<const uint2*>(xv + src);
        }
      }
#pragma unroll
      for (int t = 0; t < kMaxTokens; ++t) {
        if (mine(t)) {
          const int slot = ws + t;
          write_row<KT, kScaled>(rk[t], ck_row + static_cast<size_t>(slot) * row_stride,
                                 kScaled ? ks_row + slot : nullptr, lane);
          write_row<KT, kScaled>(rv[t], cv_row + static_cast<size_t>(slot) * row_stride,
                                 kScaled ? vs_row + slot : nullptr, lane);
        }
      }
      __threadfence();  // in L2 before this warp's cp.async reads them
    }
    __syncwarp();
  }

  // q of the rows, bf16 [r][d], zeros past R and past kRG in a tile.
  {
    __nv_bfloat16* qw = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::kQ);
    for (int e = tid; e < L::kQRows * D; e += kThreads) {
      const int r8 = e / D, d = e % D;
      const int r = (r8 >> 3) * kRG + (r8 & 7);  // row r8 & 7 of tile r8 >> 3
      __nv_bfloat16 v = __float2bfloat16_rn(0.f);
      if ((r8 & 7) < kRG && r < R) {
        const int t = r / G, g = r - t * G;
        v = q[(static_cast<size_t>(b * T + t) * H + j * G + g) * D + d];
      }
      qw[r8 * kQStride + d] = v;
    }
  }
  if (tid == 0) {
    int lo = q_pos[b * T], hi = lo;
    for (int t = 0; t < T; ++t) {
      const int p = q_pos[b * T + t];
      tpos[t] = p;
      lo = min(lo, p);
      hi = max(hi, p);
    }
    tpos[kMaxTokens] = lo;
    tpos[kMaxTokens + 1] = hi;
  }
  if (lane < kRows) {
    wml[lane] = kNegInf;  // m: running max of the logits (log2 units)
    wml[kRows + lane] = 0.f;  // l: running sum
  }
  __syncthreads();
  // The rows of token t are bits t * G .. t * G + G - 1 of a slot's row mask.
  const unsigned gmask = 0xffffffffu >> (32 - G);

  // oacc[nt]: the PV fragments of row tile nt, O^T (dimension x row): m-tile
  // 2u + h holds dimensions 32u + 4 fg + 2h (c0, c1) and + 1 (c2, c3) of rows
  // 2 fc (c0, c2) and 2 fc + 1 (c1, c3) of the tile.
  float oacc[kNT][8][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[nt][i][e] = 0.f;

  for (int c0 = s_lo; c0 < S; c0 += kRound) {
    // ---- the chunk's slots that any token sees, in slot order, into the
    // list, each with the mask of the rows that see it ----
    if (c0 != s_lo) load_vis(c0);
    const int qlo = tpos[kMaxTokens], qhi = tpos[kMaxTokens + 1];
    int n = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const bool v = see[i] && qhi - pos[i] >= 0 && qlo - pos[i] < window;
      const unsigned mask = __ballot_sync(0xffffffffu, v);
      if (v) {
        const int k = n + __popc(mask & ((1u << lane) - 1u));
        list[k] = c0 + lane + 32 * i;
        unsigned rm = gmask;  // one token: it sees every listed slot
        if (T > 1) {
          rm = 0u;
          for (int t = 0; t < T; ++t) {
            const int delta = tpos[t] - pos[i];
            if (delta >= 0 && delta < window) rm |= gmask << (t * G);
          }
        }
        rowm[k] = rm;
      }
      n += __popc(mask);
    }
    __syncwarp();
    // The scales and row masks of the lane's slots list[lane + 32 i], loaded
    // now, used after the scores.
    float ksr[kPer], vsr[kPer];
    unsigned rmr[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      ksr[i] = vsr[i] = 1.f;
      rmr[i] = 0u;
      if (lane + 32 * i < n) {
        rmr[i] = rowm[lane + 32 * i];
        if (kScaled) {
          ksr[i] = ks_row[list[lane + 32 * i]];
          vsr[i] = vs_row[list[lane + 32 * i]];
        }
      }
    }
    const int groups = (n + 31) / 32;
    const int n_k = groups * kParts;                  // score transfers
    const int n_t = n_k + (n + kVRows - 1) / kVRows;  // then the V transfers

    // Transfer t into stage t % kStages: score transfer t carries part t %
    // kParts of the K rows of slots 32 (t / kParts) ..; a V transfer carries
    // kVRows whole V rows. Four 16-byte copies a lane.
    auto issue = [&](int t) {
      if (t < n_t) {
        unsigned char* stage = ring + (t % kStages) * kStageBytes;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = lane + 32 * k;
          if (t < n_k) {
            const int s = e >> 2, ch = e & 3;
            const int idx = (t / kParts) * 32 + s;
            if (idx < n)
              cp_async16(stage + s * kPartBytes + 16 * (ch ^ ((s >> 1) & 3)),
                         ck_row + list[idx] * row_stride + (t % kParts) * kPartBytes + 16 * ch);
          } else {
            constexpr int kRowChunks = kRowBytes / 16;
            const int s = e / kRowChunks, ch = e % kRowChunks;
            const int idx = (t - n_k) * kVRows + s;
            // Chunks swizzled by the row pair: the PV fragment loads of the
            // four lanes of a row group fall in other banks.
            if (idx < n)
              cp_async16(stage + s * kRowBytes + 16 * (ch ^ (2 * ((s >> 1) & 3))),
                         cv_row + list[idx] * row_stride + 16 * ch);
          }
        }
      }
      cp_async_commit();  // an empty group past the last transfer keeps the count
    };

#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) issue(t);
    // Transfer t has landed in the stage returned (the stage of transfer t
    // - 1 is refilled with transfer t + kStages - 1 first).
    auto landed = [&](int t) {
      __syncwarp();  // every lane is done with the stage refilled next
      issue(t + kStages - 1);
      cp_async_wait<kStages - 1>();
      __syncwarp();  // transfer t, every lane's copies, has landed
      return static_cast<const unsigned char*>(ring + (t % kStages) * kStageBytes);
    };
    {
      // S^T fragments (slot x row) of the 32 slots of the score transfers,
      // per row tile: m-tile mt holds slots 16 mt + fg (c0, c1) and + 8 (c2,
      // c3), rows 2 fc and 2 fc + 1.
      float sacc[2][kNT][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[mt][nt][e] = 0.f;
      for (int t = 0; t < n_k; ++t) {
        const unsigned char* stage = landed(t);
        // Scores: part t % kParts of the 32 slots' dots on the tensor cores,
        // S^T += K Q^T in kSteps k-steps of 16 dimensions. The lane takes
        // chunk fc of its two slots' parts; k-step s holds elements 4s .. 4s
        // + 3 of each lane's chunk (both operands alike).
        const int part = t % kParts;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int s0 = 16 * mt + fg, s1 = s0 + 8;
          const uint4 k0 = *reinterpret_cast<const uint4*>(
              stage + s0 * kPartBytes + 16 * (fc ^ ((s0 >> 1) & 3)));
          const uint4 k1 = *reinterpret_cast<const uint4*>(
              stage + s1 * kPartBytes + 16 * (fc ^ ((s1 >> 1) & 3)));
#pragma unroll
          for (int s = 0; s < kSteps; ++s) {
            uint32_t a[4];
            kstep_pairs<KT>(k0, s, a[0], a[2]);
            kstep_pairs<KT>(k1, s, a[1], a[3]);
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) {
              const uint2 bq = *reinterpret_cast<const uint2*>(
                  qb + (8 * nt + fg) * kQStride + part * kPartElems + kChunkElems * fc + 4 * s);
              mma_bf16(sacc[mt][nt], a, bq.x, bq.y);
            }
          }
        }
        if (part == kParts - 1) {  // the dots are whole: store them, unscaled
          const int base = (t / kParts) * 32;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int idx = base + 16 * mt + 8 * h + fg;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  if (2 * fc + e < kRG && idx < n)
                    pv[(nt * kRG + 2 * fc + e) * kDStride + idx] = sacc[mt][nt][2 * h + e];
                }
              }
#pragma unroll
              for (int e = 0; e < 4; ++e) sacc[mt][nt][e] = 0.f;
            }
          }
        }
      }
    }
    if (n_k > 0) {
      // ---- the chunk's softmax, a row tile at a time: logits, maximum,
      // p * v_scale; a row that does not see a slot takes -inf for it ----
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        float x[kPer][kRG];
#pragma unroll
        for (int i = 0; i < kPer; ++i)
#pragma unroll
          for (int r = 0; r < kRG; ++r)
            x[i][r] = (rmr[i] >> (nt * kRG + r)) & 1u
                          ? __fmul_rn(pv[(nt * kRG + r) * kDStride + lane + 32 * i],
                                      __fmul_rn(ksr[i], c2))
                          : -INFINITY;
        __syncwarp();  // the tile's dots are read: its probabilities go over them
        float mx[kRG], alpha[kRG], mr[kRG];
        bool moved = false;
#pragma unroll
        for (int r = 0; r < kRG; ++r) {
          mx[r] = group_max(fmaxf(x[0][r], x[1][r]), 32);
          const float m_old = wml[nt * kRG + r];
          const float m_new = fmaxf(m_old, mx[r]);
          // Exactly 1 where the row's maximum stays: its sums do not move.
          alpha[r] = m_new == m_old ? 1.f : m_old > 0.5f * kNegInf ? ex2(m_old - m_new) : 0.f;
          moved = moved || m_new != m_old;
          mr[r] = m_new;
        }
        if (moved) {  // uniform over the warp: m is
          float a0 = 1.f, a1 = 1.f;  // the factors of this lane's rows 2 fc, 2 fc + 1
#pragma unroll
          for (int r = 0; r < kRG; ++r) {
            if (r == 2 * fc) a0 = alpha[r];
            if (r == 2 * fc + 1) a1 = alpha[r];
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            oacc[nt][i][0] = __fmul_rn(oacc[nt][i][0], a0);
            oacc[nt][i][1] = __fmul_rn(oacc[nt][i][1], a1);
            oacc[nt][i][2] = __fmul_rn(oacc[nt][i][2], a0);
            oacc[nt][i][3] = __fmul_rn(oacc[nt][i][3], a1);
          }
        }
        // p is +0 where the row does not see the slot and past the list.
        __nv_bfloat16* pbn = pbt(nt);
#pragma unroll
        for (int r = 0; r < kRG; ++r) {
          float ps = 0.f;
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const float p = ex2(x[i][r] - mr[r]);
            ps += p;
            pbn[r * kPStride + lane + 32 * i] = __float2bfloat16_rn(__fmul_rn(p, vsr[i]));
          }
          const float lsum = fmaf(alpha[r], wml[kRows + nt * kRG + r], group_sum(ps, 32));
          __syncwarp();  // every lane has read m and l
          if (lane == 0) {
            wml[nt * kRG + r] = mr[r];
            wml[kRows + nt * kRG + r] = lsum;
          }
        }
      }
      __syncwarp();
    }
    for (int t = n_k; t < n_t; ++t) {
      const unsigned char* stage = landed(t);
      // PV on the tensor cores: O^T += V^T P^T over kVRows slots (one
      // k-step of 16; a bf16 transfer fills half of it). The lane takes
      // slots 2 fc, 2 fc + 1 (and + 8, + 9) and dimensions 32u + 4 fg .. +
      // 3 of each, 4 bytes (8 for bf16) a slot; a slot past the list is
      // zero.
      const int idx0 = (t - n_k) * kVRows;
      const bool lo_ok = idx0 + 2 * fc < n, lo1_ok = idx0 + 2 * fc + 1 < n;
      const bool hi_ok = kVRows > 8 && idx0 + 2 * fc + 8 < n;
      const bool hi1_ok = kVRows > 8 && idx0 + 2 * fc + 9 < n;
      uint32_t pb0[kNT], pb1[kNT];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        pb0[nt] = pb1[nt] = 0u;
        if (fg < kRG) {
          const __nv_bfloat16* prow = pbt(nt) + fg * kPStride + idx0 + 2 * fc;
          pb0[nt] = *reinterpret_cast<const uint32_t*>(prow);
          if (kVRows > 8) pb1[nt] = *reinterpret_cast<const uint32_t*>(prow + 8);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        uint32_t a[2][4];  // m-tiles 2u, 2u + 1
        if constexpr (sizeof(KT) == 1) {
          // Word (8u + fg) of a row, its 16-byte chunk swizzled as stored.
          const int wo = 4 * ((8 * u + fg) ^ (8 * fc));
          const int r0 = 2 * fc;
          auto word = [&](bool ok, int row) {
            return ok ? *reinterpret_cast<const uint32_t*>(stage + row * kRowBytes + wo) : 0u;
          };
          const uint32_t w0 = word(lo_ok, r0), w1 = word(lo1_ok, r0 + 1);
          const uint32_t w8 = word(hi_ok, r0 + 8), w9 = word(hi1_ok, r0 + 9);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            a[h][0] = byte_pair<KT>(w0, w1, 2 * h);
            a[h][1] = byte_pair<KT>(w0, w1, 2 * h + 1);
            a[h][2] = byte_pair<KT>(w8, w9, 2 * h);
            a[h][3] = byte_pair<KT>(w8, w9, 2 * h + 1);
          }
        } else {
          // bf16 rows of 256 bytes, 8 a transfer: dimensions 32u + 4 fg .. +
          // 3 are 8 bytes of chunk 4u + fg / 2, swizzled as stored.
          const int bo = 16 * ((4 * u + (fg >> 1)) ^ (2 * fc)) + 8 * (fg & 1);
          const int r0 = 2 * fc;
          uint2 v0 = make_uint2(0u, 0u), v1 = make_uint2(0u, 0u);
          if (lo_ok) v0 = *reinterpret_cast<const uint2*>(stage + r0 * kRowBytes + bo);
          if (lo1_ok) v1 = *reinterpret_cast<const uint2*>(stage + (r0 + 1) * kRowBytes + bo);
          a[0][0] = __byte_perm(v0.x, v1.x, 0x5410);
          a[0][1] = __byte_perm(v0.x, v1.x, 0x7632);
          a[1][0] = __byte_perm(v0.y, v1.y, 0x5410);
          a[1][1] = __byte_perm(v0.y, v1.y, 0x7632);
          a[0][2] = a[0][3] = a[1][2] = a[1][3] = 0u;
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          mma_bf16(oacc[nt][2 * u], a[0], pb0[nt], pb1[nt]);
          mma_bf16(oacc[nt][2 * u + 1], a[1], pb0[nt], pb1[nt]);
        }
      }
    }
    cp_async_wait<0>();
    __syncwarp();  // the list, the probabilities and the stages are free again
  }

  // ---- the warp's partial, a row tile at a time in its own stage ring, and
  // the block's: its warps in order ----
  float* wacc = reinterpret_cast<float*>(ring);  // [kRG][D]
  const float* ml = reinterpret_cast<const float*>(smem_raw + L::kWml);
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    if (nt > 0) __syncthreads();  // the previous tile's merge is done with the rings
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (2 * fc + e < kRG)
          *reinterpret_cast<float4*>(wacc + (2 * fc + e) * D + 32 * u + 4 * fg) =
              make_float4(oacc[nt][2 * u][e], oacc[nt][2 * u][2 + e], oacc[nt][2 * u + 1][e],
                          oacc[nt][2 * u + 1][2 + e]);
      }
    }
    __syncthreads();
    for (int e = tid; e < kRG * D; e += kThreads) {
      const int r = nt * kRG + e / D, d = e % D;
      float M = kNegInf;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) M = fmaxf(M, ml[v * 2 * kRows + r]);
      float A = 0.f, Lsum = 0.f;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        const float lv = ml[v * 2 * kRows + kRows + r];
        const float wt = lv > 0.f ? ex2(ml[v * 2 * kRows + r] - M) : 0.f;
        const float* wv =
            reinterpret_cast<const float*>(smem_raw + L::kRing + v * kStages * kStageBytes);
        A = fmaf(wt, wv[e], A);
        Lsum = fmaf(wt, lv, Lsum);
      }
      bml[2 * kRows + r * D + d] = A;
      if (d == 0) {
        bml[r] = M;
        bml[kRows + r] = Lsum;
      }
    }
  }

  // ---- the cluster's partials, ranks in order, through distributed shared
  // memory: block k of the cluster merges rows k, k + 8, ..., two at a time ----
  cluster.sync();
  {
    const int d = tid % D;
    for (int r = rank + kCluster * (tid / D); r < R; r += kCluster * (kThreads / D)) {
      float mk[kCluster], lk[kCluster], ak[kCluster];
#pragma unroll
      for (int k = 0; k < kCluster; ++k) {
        const float* o = cluster.map_shared_rank(bml, k);
        mk[k] = o[r];
        lk[k] = o[kRows + r];
        ak[k] = o[2 * kRows + r * D + d];
      }
      float M = kNegInf;
#pragma unroll
      for (int k = 0; k < kCluster; ++k) M = fmaxf(M, mk[k]);
      float A = 0.f, Lsum = 0.f;
#pragma unroll
      for (int k = 0; k < kCluster; ++k) {
        const float wt = lk[k] > 0.f ? ex2(mk[k] - M) : 0.f;
        A = fmaf(wt, ak[k], A);
        Lsum = fmaf(wt, lk[k], Lsum);
      }
      const int t = r / G, g = r - t * G;
      out[(static_cast<size_t>(b * T + t) * H + j * G + g) * D + d] =
          __float2bfloat16_rn(Lsum > 0.f ? A / Lsum : 0.f);
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <typename KT, bool kScaled, bool kWrite, int kRG, int kNT>
cudaError_t launch_rows(const void* q, const void* xk, const void* xv, void* ck, void* cv,
                        void* ks, void* vs, int li, int window, const void* write_slot,
                        const void* q_pos, const void* kv_pos, const void* kv_valid, void* out,
                        int B, int T, int S, int H, int Hkv, float scale, cudaStream_t stream) {
  auto kern = decode_hopper_kernel<KT, kScaled, kWrite, kRG, kNT>;
  constexpr int smem = Smem<kRG, kNT>::kBytes;
  static std::atomic<unsigned> smem_set{0};
  cudaError_t err = smem_limit_once(reinterpret_cast<const void*>(kern), smem, smem_set);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, Hkv, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, kern, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(xk),
      static_cast<const __nv_bfloat16*>(xv), static_cast<KT*>(ck), static_cast<KT*>(cv),
      static_cast<float*>(ks), static_cast<float*>(vs), li, window,
      static_cast<const int*>(write_slot), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<const uint8_t*>(kv_valid),
      static_cast<__nv_bfloat16*>(out), B, T, S, H, Hkv, scale);
}

// K6 on `stream`: attention only, up to 8 query heads per KV head. Returns
// the CUDA error code (0 = launched).
template <typename KT, bool kScaled>
int launch_decode(const void* q, const void* ck, const void* cv, const void* ks,
                  const void* vs, int li, int window, const void* q_pos, const void* kv_pos,
                  const void* kv_valid, void* out, int B, int S, int H, int Hkv, float scale,
                  void* stream) {
  if (Hkv < 1 || H % Hkv != 0 || H / Hkv > 8 || B < 1 || S < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The ring is only read: the kernel takes it through the pointers it would write by.
  void* k = const_cast<void*>(ck);
  void* v = const_cast<void*>(cv);
  void* ksc = const_cast<void*>(ks);
  void* vsc = const_cast<void*>(vs);
  cudaError_t err =
      H / Hkv <= 4
          ? launch_rows<KT, kScaled, false, 4, 1>(q, nullptr, nullptr, k, v, ksc, vsc, li, window,
                                                  nullptr, q_pos, kv_pos, kv_valid, out, B, 1, S,
                                                  H, Hkv, scale, st)
          : launch_rows<KT, kScaled, false, 8, 1>(q, nullptr, nullptr, k, v, ksc, vsc, li, window,
                                                  nullptr, q_pos, kv_pos, kv_valid, out, B, 1, S,
                                                  H, Hkv, scale, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// K2 (T = 1) and K7 on `stream`: the write of T tokens a row, then the
// attention of their G * T <= kMaxRows query rows. The instantiation follows
// the rows alone, so K2 and K6 at the same G run the same one, and K7 at T
// = 1 is K2.
template <typename KT, bool kScaled>
int launch_fused(const void* xq, const void* xk, const void* xv, void* ck, void* cv, void* ks,
                 void* vs, int li, int window, const void* write_slot, const void* q_pos,
                 const void* kv_pos, const void* kv_valid, void* out, int B, int T, int S, int H,
                 int Hkv, float scale, void* stream) {
  if (Hkv < 1 || H % Hkv != 0 || T < 1 || T > kMaxTokens || B < 1 || S < 1)
    return cudaErrorInvalidValue;
  const int R = H / Hkv * T;
  if (R > kMaxRows) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MIT_FUSED_ROWS(rg, nt)                                                              \
  launch_rows<KT, kScaled, true, rg, nt>(xq, xk, xv, ck, cv, ks, vs, li, window, write_slot, \
                                         q_pos, kv_pos, kv_valid, out, B, T, S, H, Hkv,      \
                                         scale, st)
  const cudaError_t err = R <= 4    ? MIT_FUSED_ROWS(4, 1)
                          : R <= 8  ? MIT_FUSED_ROWS(8, 1)
                          : R <= 16 ? MIT_FUSED_ROWS(8, 2)
                          : R <= 24 ? MIT_FUSED_ROWS(8, 3)
                                    : MIT_FUSED_ROWS(8, 4);
#undef MIT_FUSED_ROWS
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace decode
}  // namespace mit
