// Decode attention for Hopper: one query token per batch row over one layer
// of the stacked KV ring, read in place and never written (K6).
//
// Function: for each batch row b and query head h = j * G + r (KV head j,
// G = H / Hkv <= 8 query heads per KV head), softmax over the visible slots
// s of layer li of (q . k_s) * k_scale[s] * D^-1/2, times v_s * v_scale[s].
// A slot is visible when kv_valid[b, s] holds and 0 <= q_pos[b] - kv_pos[b,
// s] < window; kv_pos and kv_valid may be anything (a wrapped ring, holes),
// so no fill is assumed. A row that sees no slot returns 0. Layouts: q and
// out (B, 1, H * D) bf16, the ring (L, B, S, Hkv * D) int8 or e4m3 with fp32
// scales (L, B, Hkv, S), or bf16 without scales; q_pos (B,), kv_pos (B, S)
// int32, kv_valid (B, S) bool. Numerics: fp32 dots of values widened
// exactly, the key scale after the dot, p times the value scale rounded to
// bf16 before the PV product (the contract of the JAX package's decode
// kernel and of fused_decode.cu), the softmax in log2 units.
//
// What bounds it on the H100: bytes. Each visible slot's K and V head
// segments (128 bytes each for int8 or e4m3, 256 for bf16) are read once for
// the G query heads, about 4 * G flops per byte against the card's 295
// flop/byte ridge; at B = 4 over a 4096-slot ring the visible ring is about
// 17 MB, 5.2 us at 3.35 TB/s. The design keeps bytes in flight, spreads the
// slots over many warps and gives no warp a long chain of dependent steps:
//
// - One thread-block cluster of kCluster blocks per (batch row, KV head);
//   block k of the cluster owns the k-th contiguous slice of the ring and
//   each of its kWarps warps an equal part of that slice (64 slots at S =
//   4096). A warp works alone until its walk is over.
// - Only visible slots are loaded. A warp reads the positions and validity
//   of up to kChunk of its slots at once and compacts the visible ones into
//   a list in shared memory (ballot and popcount), so holes, a window
//   shorter than the ring and a short fill cost no loads and no masked
//   arithmetic. A warp with no visible slot is done at once.
// - The list's K then V stream through one ring of kStages 2 KB stages a
//   warp by cp.async (16 bytes a copy, kStages - 1 transfers in flight; the
//   V transfers start while the scores of the last K transfers are
//   computed). Scores: a lane owns a slot (32 a transfer, 64-byte parts of
//   their K rows, stored swizzled so the lanes' reads do not conflict),
//   widens its K in registers (int8 through the exact biased-float trick,
//   e4m3 through the paired cvt, bf16 by a shift) and takes the G dots
//   against q, which every lane reads from shared memory at the same
//   address. Then the chunk's softmax in registers: one maximum and sum per
//   head over the warp. PV: a lane owns four dimensions of every head's
//   output, reads them from each V row and the row's G probabilities (one
//   broadcast), and accumulates in fp32. No shuffle per slot, and no chain
//   from one transfer to the next but the accumulators'.
// - The partials merge inside the cluster: the block's warps through shared
//   memory, then the cluster's blocks through distributed shared memory
//   (block r of the cluster merges query head r), in a fixed order. One
//   launch, no partials in device memory.
//
// Determinism and batch invariance: no atomics, and every sum runs in an
// order fixed by S alone (the slices), the row's own visibility (the lists)
// and the lanes, so a row's bits do not depend on B or on the other rows.
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
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a block, for ring element KT and kG = 4 or 8 query heads
// per KV head. A warp's stage ring holds its output partial after the walk.
template <typename KT, int kG>
struct Smem {
  static constexpr int kRing = 0;  // kWarps x kStages x kStageBytes
  static constexpr int kList = kRing + kWarps * kStages * kStageBytes;  // int [kWarps][kChunk]
  static constexpr int kPv = kList + kWarps * kChunk * 4;  // float [kWarps][kChunk][kG]
  static constexpr int kQ = kPv + kWarps * kChunk * kG * 4;  // float [kHeadDim][kG]
  static constexpr int kWml = kQ + kHeadDim * kG * 4;      // float [kWarps][2][kG]
  static constexpr int kBlock = kWml + kWarps * 2 * kG * 4;  // float m[kG], l[kG], acc[kG][D]
  static constexpr int kBytes = kBlock + (2 + kHeadDim) * kG * 4;
  static_assert(kG * kHeadDim * 4 <= kStages * kStageBytes, "a warp's partial fits its ring");
};

// 16 bytes of int8, e4m3 or bf16 values held in w -> 16 / sizeof(KT) fp32
// values, exactly.
template <typename KT>
__device__ __forceinline__ void widen16(uint4 w, float* f) {
  if constexpr (std::is_same<KT, int8_t>::value) {
    biased_bytes_to_float(w.x ^ 0x80808080u, 128.f, f);
    biased_bytes_to_float(w.y ^ 0x80808080u, 128.f, f + 4);
    biased_bytes_to_float(w.z ^ 0x80808080u, 128.f, f + 8);
    biased_bytes_to_float(w.w ^ 0x80808080u, 128.f, f + 12);
  } else if constexpr (std::is_same<KT, __nv_fp8_e4m3>::value) {
    e4m3x8_to_float(make_uint2(w.x, w.y), f);
    e4m3x8_to_float(make_uint2(w.z, w.w), f + 8);
  } else {
    const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(v[i] << 16);
      f[2 * i + 1] = __uint_as_float(v[i] & 0xFFFF0000u);
    }
  }
}

// This lane's four elements (4l .. 4l + 3) of a V row in shared memory -> fp32.
template <typename KT>
__device__ __forceinline__ void widen4(const unsigned char* row, int lane, float* f) {
  if constexpr (sizeof(KT) == 1) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + 4 * lane);
    if constexpr (std::is_same<KT, int8_t>::value) {
      biased_bytes_to_float(w ^ 0x80808080u, 128.f, f);
    } else {
      const float2 a = e4m3x2_to_float2(w), b = e4m3x2_to_float2(w >> 16);
      f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
    }
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(row + 8 * lane);
    f[0] = __uint_as_float(w.x << 16);
    f[1] = __uint_as_float(w.x & 0xFFFF0000u);
    f[2] = __uint_as_float(w.y << 16);
    f[3] = __uint_as_float(w.y & 0xFFFF0000u);
  }
}

// 2^x on the special-function unit (results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename KT, bool kScaled, int kG>
__global__ void __launch_bounds__(kThreads, kG <= 4 ? 3 : 2) decode_hopper_kernel(
    const __nv_bfloat16* __restrict__ q, const KT* __restrict__ ck,
    const KT* __restrict__ cv, const float* __restrict__ ks, const float* __restrict__ vs,
    int li, int window, const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
    const uint8_t* __restrict__ kv_valid, __nv_bfloat16* __restrict__ out, int B, int S,
    int H, int Hkv, float scale) {
  using L = Smem<KT, kG>;
  constexpr int D = kHeadDim;
  constexpr int kRowBytes = D * static_cast<int>(sizeof(KT));
  constexpr int kParts = kRowBytes / kPartBytes;          // score transfers per 32 slots
  constexpr int kVRows = kStageBytes / kRowBytes;         // V rows per transfer
  constexpr int kPartElems = kPartBytes / static_cast<int>(sizeof(KT));
  constexpr int kChunkElems = 16 / static_cast<int>(sizeof(KT));
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int j = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int G = H / Hkv;
  const size_t HD = static_cast<size_t>(Hkv) * D;
  const size_t lb = static_cast<size_t>(li) * B + b;
  const unsigned char* ck_row = reinterpret_cast<const unsigned char*>(ck + lb * S * HD + j * D);
  const unsigned char* cv_row = reinterpret_cast<const unsigned char*>(cv + lb * S * HD + j * D);
  const size_t row_stride = HD * sizeof(KT);  // bytes from slot s to slot s + 1
  const float* ks_row = kScaled ? ks + (lb * Hkv + j) * S : nullptr;
  const float* vs_row = kScaled ? vs + (lb * Hkv + j) * S : nullptr;
  const int* pos_row = kv_pos + static_cast<size_t>(b) * S;
  const uint8_t* ok_row = kv_valid + static_cast<size_t>(b) * S;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + L::kRing + w * kStages * kStageBytes;
  int* list = reinterpret_cast<int*>(smem_raw + L::kList) + w * kChunk;
  float* pv = reinterpret_cast<float*>(smem_raw + L::kPv) + w * kChunk * kG;  // [idx][kG]
  float* qs = reinterpret_cast<float*>(smem_raw + L::kQ);                     // [d][kG]

  // The warp's part of the ring: whole 32-slot groups, fixed by S alone.
  const int per_warp = ((S + kCluster * kWarps - 1) / (kCluster * kWarps) + 31) / 32 * 32;
  const int s_lo = (rank * kWarps + w) * per_warp;
  const int s_hi = min(s_lo + per_warp, S);
  const int qp = q_pos[b];
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
      see[i] = s < s_hi && ok_row[s];
      pos[i] = s < s_hi ? pos_row[s] : 0;
    }
  };
  load_vis(s_lo);

  // q of the KV head's query heads, fp32, [d][r] (zero rows past G).
  for (int e = tid; e < D * kG; e += kThreads) {
    const int d = e / kG, r = e % kG;
    qs[e] = r < G ? __bfloat162float(q[(static_cast<size_t>(b) * H + j * G + r) * D + d]) : 0.f;
  }
  __syncthreads();

  float m[kG], l[kG], acc[kG][4];  // m: running max of the logits (log2 units)
#pragma unroll
  for (int r = 0; r < kG; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
  }

  for (int c0 = s_lo; c0 < s_hi; c0 += kChunk) {
    // ---- the chunk's visible slots, in slot order, into the list ----
    if (c0 != s_lo) load_vis(c0);
    int n = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int delta = qp - pos[i];
      const bool v = see[i] && delta >= 0 && delta < window;
      const unsigned mask = __ballot_sync(0xffffffffu, v);
      if (v) list[n + __popc(mask & ((1u << lane) - 1u))] = c0 + lane + 32 * i;
      n += __popc(mask);
    }
    __syncwarp();
    // The scales of the lane's slots list[lane + 32 i], loaded now, used
    // after the scores.
    float ksr[kPer], vsr[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      ksr[i] = vsr[i] = 1.f;
      if (kScaled && lane + 32 * i < n) {
        ksr[i] = ks_row[list[lane + 32 * i]];
        vsr[i] = vs_row[list[lane + 32 * i]];
      }
    }
    const int groups = (n + 31) / 32;
    const int n_k = groups * kParts;            // score transfers
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
            if (idx < n)
              cp_async16(stage + s * kRowBytes + 16 * ch,
                         cv_row + list[idx] * row_stride + 16 * ch);
          }
        }
      }
      cp_async_commit();  // an empty group past the last transfer keeps the count
    };

#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) issue(t);
    float dot[kG];
#pragma unroll
    for (int r = 0; r < kG; ++r) dot[r] = 0.f;
    for (int t = 0; t < n_t; ++t) {
      __syncwarp();  // every lane is done with the stage refilled next
      issue(t + kStages - 1);
      cp_async_wait<kStages - 1>();
      __syncwarp();  // transfer t, every lane's copies, has landed
      const unsigned char* stage = ring + (t % kStages) * kStageBytes;
      if (t < n_k) {
        // Scores: part t % kParts of this lane's slot's dots.
        const int part = t % kParts;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              stage + lane * kPartBytes + 16 * (ch ^ ((lane >> 1) & 3)));
          float f[kChunkElems];
          widen16<KT>(raw, f);
          const int d0 = part * kPartElems + ch * kChunkElems;
#pragma unroll
          for (int i = 0; i < kChunkElems; ++i) {
            float qd[kG];
            if constexpr (kG == 4) {
              const float4 a = *reinterpret_cast<const float4*>(qs + (d0 + i) * kG);
              qd[0] = a.x, qd[1] = a.y, qd[2] = a.z, qd[3] = a.w;
            } else {
#pragma unroll
              for (int h = 0; h < kG; h += 4) {
                const float4 a = *reinterpret_cast<const float4*>(qs + (d0 + i) * kG + h);
                qd[h] = a.x, qd[h + 1] = a.y, qd[h + 2] = a.z, qd[h + 3] = a.w;
              }
            }
#pragma unroll
            for (int r = 0; r < kG; ++r) dot[r] = fmaf(qd[r], f[i], dot[r]);
          }
        }
        if (part == kParts - 1) {  // the dots are whole: store them, unscaled
          const int idx = (t / kParts) * 32 + lane;
          if (idx < n) {
#pragma unroll
            for (int r = 0; r < kG; ++r) pv[idx * kG + r] = dot[r];
          }
#pragma unroll
          for (int r = 0; r < kG; ++r) dot[r] = 0.f;
        }
        if (t == n_k - 1) {
          // ---- the chunk's softmax: logits, maximum, p * v_scale ----
          __syncwarp();
          float x[kPer][kG], mx[kG];
#pragma unroll
          for (int r = 0; r < kG; ++r) mx[r] = -INFINITY;
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const int idx = lane + 32 * i;
#pragma unroll
            for (int r = 0; r < kG; ++r) {
              x[i][r] = idx < n ? pv[idx * kG + r] * (ksr[i] * c2) : -INFINITY;
              mx[r] = fmaxf(mx[r], x[i][r]);
            }
          }
          bool moved = false;
          float alpha[kG];
#pragma unroll
          for (int r = 0; r < kG; ++r) {
            mx[r] = group_max(mx[r], 32);
            const float m_new = fmaxf(m[r], mx[r]);
            alpha[r] = m[r] > 0.5f * kNegInf ? ex2(m[r] - m_new) : 0.f;
            moved = moved || m_new != m[r];
            m[r] = m_new;
          }
          if (moved) {  // uniform over the warp: m is
#pragma unroll
            for (int r = 0; r < kG; ++r)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[r][i] *= alpha[r];
          }
          float ps[kG];
#pragma unroll
          for (int r = 0; r < kG; ++r) ps[r] = 0.f;
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const int idx = lane + 32 * i;
            if (idx < n) {
#pragma unroll
              for (int r = 0; r < kG; ++r) {
                const float p = ex2(x[i][r] - m[r]);
                ps[r] += p;
                pv[idx * kG + r] = round_bf16(p * vsr[i]);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < kG; ++r) l[r] = alpha[r] * l[r] + group_sum(ps[r], 32);
          __syncwarp();
        }
      } else {
        // PV: kVRows V rows; this lane's four dimensions of each head.
        const int idx0 = (t - n_k) * kVRows;
#pragma unroll
        for (int s = 0; s < kVRows; ++s) {
          if (idx0 + s < n) {  // uniform over the warp
            float f[4];
            widen4<KT>(stage + s * kRowBytes, lane, f);
            float p[kG];
#pragma unroll
            for (int h = 0; h < kG; h += 4) {
              const float4 a = *reinterpret_cast<const float4*>(pv + (idx0 + s) * kG + h);
              p[h] = a.x, p[h + 1] = a.y, p[h + 2] = a.z, p[h + 3] = a.w;
            }
#pragma unroll
            for (int r = 0; r < kG; ++r)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[r][i] = fmaf(p[r], f[i], acc[r][i]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncwarp();  // the list, the probabilities and the stages are free again
  }

  // ---- the warp's partial, in its own stage ring ----
  float* wacc = reinterpret_cast<float*>(ring);  // [kG][D]
  float* wml = reinterpret_cast<float*>(smem_raw + L::kWml) + w * 2 * kG;
#pragma unroll
  for (int r = 0; r < kG; ++r) {
    *reinterpret_cast<float4*>(wacc + r * D + 4 * lane) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    if (lane == 0) {
      wml[r] = m[r];
      wml[kG + r] = l[r];
    }
  }
  __syncthreads();

  // ---- the block's partial: its warps in order ----
  float* bml = reinterpret_cast<float*>(smem_raw + L::kBlock);  // m[kG], l[kG], acc[kG][D]
  for (int e = tid; e < kG * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const float* ml = reinterpret_cast<const float*>(smem_raw + L::kWml);
    float M = kNegInf;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) M = fmaxf(M, ml[v * 2 * kG + r]);
    float A = 0.f, Lsum = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const float lv = ml[v * 2 * kG + kG + r];
      const float wt = lv > 0.f ? ex2(ml[v * 2 * kG + r] - M) : 0.f;
      A += wt * reinterpret_cast<const float*>(smem_raw + L::kRing + v * kStages * kStageBytes)[e];
      Lsum += wt * lv;
    }
    bml[2 * kG + e] = A;
    if (d == 0) {
      bml[r] = M;
      bml[kG + r] = Lsum;
    }
  }

  // ---- the cluster's partials, ranks in order, through distributed shared
  // memory: block r of the cluster writes query head r ----
  cluster.sync();
  if (rank < G && tid < D) {
    const int r = rank, d = tid;
    float mk[kCluster], lk[kCluster], ak[kCluster];
#pragma unroll
    for (int k = 0; k < kCluster; ++k) {
      const float* o = cluster.map_shared_rank(bml, k);
      mk[k] = o[r];
      lk[k] = o[kG + r];
      ak[k] = o[2 * kG + r * D + d];
    }
    float M = kNegInf;
#pragma unroll
    for (int k = 0; k < kCluster; ++k) M = fmaxf(M, mk[k]);
    float A = 0.f, Lsum = 0.f;
#pragma unroll
    for (int k = 0; k < kCluster; ++k) {
      const float wt = lk[k] > 0.f ? ex2(mk[k] - M) : 0.f;
      A += wt * ak[k];
      Lsum += wt * lk[k];
    }
    out[(static_cast<size_t>(b) * H + j * G + r) * D + d] =
        __float2bfloat16_rn(Lsum > 0.f ? A / Lsum : 0.f);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <typename KT, bool kScaled, int kG>
cudaError_t launch_heads(const void* q, const void* ck, const void* cv, const void* ks,
                         const void* vs, int li, int window, const void* q_pos,
                         const void* kv_pos, const void* kv_valid, void* out, int B, int S,
                         int H, int Hkv, float scale, cudaStream_t stream) {
  auto kern = decode_hopper_kernel<KT, kScaled, kG>;
  constexpr int smem = Smem<KT, kG>::kBytes;
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
      &cfg, kern, static_cast<const __nv_bfloat16*>(q), static_cast<const KT*>(ck),
      static_cast<const KT*>(cv), static_cast<const float*>(ks), static_cast<const float*>(vs),
      li, window, static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos),
      static_cast<const uint8_t*>(kv_valid), static_cast<__nv_bfloat16*>(out), B, S, H, Hkv,
      scale);
}

// Launch on `stream`; returns the CUDA error code (0 = launched). Up to 8
// query heads per KV head.
template <typename KT, bool kScaled>
int launch_decode(const void* q, const void* ck, const void* cv, const void* ks,
                  const void* vs, int li, int window, const void* q_pos, const void* kv_pos,
                  const void* kv_valid, void* out, int B, int S, int H, int Hkv, float scale,
                  void* stream) {
  if (Hkv < 1 || H % Hkv != 0 || H / Hkv > 8 || B < 1 || S < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = H / Hkv <= 4
      ? launch_heads<KT, kScaled, 4>(q, ck, cv, ks, vs, li, window, q_pos, kv_pos, kv_valid,
                                     out, B, S, H, Hkv, scale, st)
      : launch_heads<KT, kScaled, 8>(q, ck, cv, ks, vs, li, window, q_pos, kv_pos, kv_valid,
                                     out, B, S, H, Hkv, scale, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace decode
}  // namespace mit
