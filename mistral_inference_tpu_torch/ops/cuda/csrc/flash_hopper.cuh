// Tiled online-softmax attention for Hopper, shared by three kernels: the
// chunk's attention to its own bf16 keys (K1), a chunk's queries over one
// layer's stored ring, int8 or e4m3 with per-(slot, head) scales, or bf16
// (K4), and the vision encoder's segment-masked attention (K10).
//
// Function: for every query row (token t, head h), softmax over the visible
// keys s of (q . k_s) * k_scale[s] * D^-1/2, times v_s * v_scale[s]. A key is
// visible when q_valid[t] and kv_valid[s] hold and 0 <= q_pos[t] - kv_pos[s]
// < window (K1, K4); or, with kSegment (K10), when the segment ids held in q_pos
// and kv_pos are equal (no validity flags: every row is a token of some
// segment, the bucket padding a segment of its own). GQA: head h reads KV
// head h / G. Returns the normalized output and, where m_out is given, the
// stats m (row max of the scaled logits, natural-log units) and l (sum of
// exp(x - m)) for an exact merge of two key sets. A row that sees no key
// returns 0, m = -1e30, l = 0.
//
// Layouts: q and out (B, T, H, D); keys and values (B, S, Hkv * D); scales
// (B, Hkv, S); m and l (B, T, H). Numerics: fp32 dots of bf16 operands (an
// int8 or e4m3 value widens to bf16 exactly), scales after the dot,
// probabilities times the value scale rounded to bf16 before the PV product.
//
// What bounds it on the H100: at the main path's shapes (T = 512 queries, G
// = 4, over a 4096-slot ring at D = 128; a 4096-patch image with 16 heads of
// 64) it does 4 * D flops per visible (query head, key) pair, 68.7 GFLOP for
// the image and about 85 GFLOP for the ring chunk, against 33.5 MB and 44 MB
// of operands: compute-bound, far above the card's 295 flop/byte ridge. K1's
// causal chunk (T = S = 512) has 2.2 GFLOP of visible pairs against 4.7 MB:
// its bound is the bytes, and its cost the ramp of short walks. The
// design puts both products on the bf16 tensor cores and hides the loads
// behind them; on an H100 SXM at 700 W it reaches about a third (K10) and a
// fifth to a quarter (K4) of the tensor cores' peak, the softmax bounding it:
//
// - One block of three warpgroups per work item (query tile, KV head,
//   batch row); for K1 one block an SM, walking items in turn. The
//   query tile is 128 rows: 128 / G tokens times the G heads that share the
//   KV head (K4: 32 tokens x 4 heads; K10: 128 patches of one head), so a
//   K/V tile read from device memory serves 128 rows. Warpgroups 0 and 1
//   each own 64 rows and run both products on wgmma (m64nNk16, bf16 in,
//   fp32 accumulate): S = Q K^T with Q in shared memory for the whole walk
//   and the key tile as the K-major B operand, then O += P V with P repacked
//   from the S accumulators into register A fragments and the value tile as
//   the MN-major B operand. Every operand tile sits in shared memory in the
//   128-byte swizzle the descriptors name. Each step issues S for this tile
//   and, behind it, the previous tile's PV product, so the tensor cores run
//   PV while the warpgroup computes this tile's softmax (S and O fit the
//   168 registers a thread the launch bounds leave).
// - The softmax is the consumers' main cost (at D = 64 the exponentials
//   alone take as long as the products): it runs in log2 units on the
//   special-function unit's ex2, with the key scale, D^-1/2 and log2 e
//   folded into one per-key factor by the producer, four partial maxima and
//   sums per row for short dependent chains, and O's rescale skipped where
//   no row's maximum moved (alpha = 1).
// - Warpgroup 2 is the producer. Its warp w owns stage w of a ring of
//   kStages = 4 shared-memory stages and fills it with tiles w, w + 4, ...,
//   signalled by mbarriers (full: tile landed; empty: both consumers are
//   done with it), so four tiles are in flight and the consumers compute on
//   tile j while the next land. A bf16 tile goes by cp.async straight into
//   its swizzled stage (the mbarrier tracks the copies). An int8 or e4m3
//   tile's raw bytes land by cp.async in the stage's V space and are widened
//   to bf16 exactly (e4m3 through the paired cvt.rn.f16x2.e4m3x2; the bf16
//   pair taken as the high halves of exact fp32 values, no rounding
//   convert); the key metadata and scales, loaded a tile ahead, travel in
//   the stage beside the tile. cp.async rather than TMA: no tensor map to
//   encode and cache per ring pointer from a library built without the
//   driver API, and the scaled rings need the producer's widening anyway.
// - Visibility decided per tile. The producer classifies each (query tile,
//   key tile) pair from the range of its valid query positions (or segment
//   ids) and the key tile's min, max and validity (warp reductions; a ring's
//   positions are not monotonic after a wrap): skipped (no pair can be
//   visible: nothing loaded, the consumers free the stage at once), full
//   (every pair of a valid query row is visible) or mixed. Only mixed tiles
//   pay the per-element mask, as -inf logits; a mixed tile whose pairs are
//   all visible computes the same bits as a full one. Invalid query rows are
//   zeroed when written, so they do not make a tile mixed.
// - Tiles: 64 keys at D = 128 (S 32 and O 64 fp32 registers a thread) and
//   128 keys at D = 64, so every barrier buys the same MMA at both widths;
//   four stages (165 KB and 153 KB of shared memory; K1 197 KB with its
//   second query tile), one block an SM. The
//   role and tile class are broadcast from lane 0 (__shfl_sync), so the
//   compiler sees no divergent path around a wgmma and does not serialize
//   them.
//
// - K1's blocks take items in turn (a persistent grid): a block costs
//   several microseconds to start, load its query tile and fill its
//   pipeline before the first product, which at K1's short walks (1 to 8
//   key tiles) outweighed the walk itself. Its producer loads the next
//   item's query tile (into a second buffer, behind barriers of its own,
//   with each row's position and validity) and first key tiles while the
//   consumers finish the current item; the stage of a key tile follows a
//   count that runs on through the block's items. K4 and K10, whose walks
//   are long, keep a block per item and their consumers load the query
//   tile: the persistent form measured 4-10 % slower for them.
// - K1 (kChunk) walks a causal chunk: query tile i sees about i + 1 of the
//   chunk's key tiles, so its items are of very unequal length. Its items
//   run the query tiles last to first (the longest walks first, every KV
//   head and row of a tile together), and each round of items is dealt to
//   the blocks in the reverse order of the round before, so that the
//   blocks' loads even out.
//
// Determinism and batch invariance: no atomics and no split over S. Each
// output row is computed by one item walking its key tiles in order from a
// fresh state, and a tile's class depends only on its own rows and keys, so
// a row's bits do not depend on B, on the other rows or on which block runs
// its item, or after which.
#pragma once

#include <climits>
#include <type_traits>

#include "hopper.cuh"

namespace mit {
namespace hopper {

constexpr int kRows = 128;       // query rows per block: two consumer warpgroups of 64
constexpr int kConsumers = 256;  // threads of the two consumer warpgroups
constexpr int kProducers = 128;  // the producer warpgroup
constexpr int kThreads = kConsumers + kProducers;
constexpr int kStages = 4;
constexpr int kFull = 0, kMixed = 1, kSkip = 2;  // a stage's tile class

template <int D>
constexpr int kKeysOf = D == 64 ? 128 : 64;

// ---- shared memory: 128-byte swizzled operand tiles (hopper.cuh), stage metadata,
// barriers ----

template <int kKeys>
struct StageMeta {
  int kpos[kKeys];  // position (K4) or segment id (K10) of each key; 0 when invalid
  int kok[kKeys];   // key valid
  float kf[kKeys];  // k_scale * D^-1/2 * log2 e (scaled rings; 0 when invalid)
  float vs[kKeys];  // value scale (scaled rings; 0 when invalid)
};

// kQTiles query tiles: two for K1's persistent grid (the next item's is
// loaded during the current item), one for a block per item.
template <int D, int kQTiles>
struct Smem {
  static constexpr int kKeys = kKeysOf<D>;
  static constexpr int kQBytes = kRows * D * 2;              // one query tile, bf16
  static constexpr int kQ = 0;                               // kQTiles query tiles
  static constexpr int kTile = kQTiles * kQBytes;            // K, then V, per stage
  static constexpr int kTileBytes = kKeys * D * 2;
  static constexpr int kMeta = kTile + kStages * 2 * kTileBytes;
  static constexpr int kCls = kMeta + kStages * sizeof(StageMeta<kKeys>);
  static constexpr int kQMeta = kCls + 16 * kStages;         // int qpos[2][kRows], qok[2][kRows]
  // full[kStages], empty[kStages], qfull[2], qempty[2]
  static constexpr int kBars = kQMeta + 4 * 4 * kRows;
  static constexpr int kBytes = kBars + 8 * (2 * kStages + 4);
  static_assert(kQBytes % 1024 == 0 && kTileBytes % 1024 == 0, "swizzle atoms 1024-aligned");
};

// ---- the producer's loads: one K and one V tile of kKeys rows ----

// 16 int8 or e4m3 values -> 16 bf16 (exact), as two 16-byte chunks.
template <typename KT>
__device__ __forceinline__ void widen16(uint4 raw, uint4& lo, uint4& hi) {
  float f[16];
  if constexpr (std::is_same<KT, int8_t>::value) {
    biased_bytes_to_float(raw.x ^ 0x80808080u, 128.f, f);
    biased_bytes_to_float(raw.y ^ 0x80808080u, 128.f, f + 4);
    biased_bytes_to_float(raw.z ^ 0x80808080u, 128.f, f + 8);
    biased_bytes_to_float(raw.w ^ 0x80808080u, 128.f, f + 12);
  } else {
    e4m3x8_to_float(make_uint2(raw.x, raw.y), f);
    e4m3x8_to_float(make_uint2(raw.z, raw.w), f + 8);
  }
  lo = make_uint4(high_halves(f[0], f[1]), high_halves(f[2], f[3]), high_halves(f[4], f[5]),
                  high_halves(f[6], f[7]));
  hi = make_uint4(high_halves(f[8], f[9]), high_halves(f[10], f[11]),
                  high_halves(f[12], f[13]), high_halves(f[14], f[15]));
}

// 2^x on the special-function unit (flushes results below 2^-126 to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// One tile's online-softmax step for this thread's two rows (r0 and r0 + 8,
// row half h) over its kKeys / 4 columns 8i + 2 quad + e, in log2 units:
// the logit of a scaled ring's key is its dot times kf = k_scale * D^-1/2 *
// log2 e (the producer's product); an unscaled key's is the dot times c2 =
// D^-1/2 log2 e, folded into the exponent's fma (its maximum is the raw
// dots' maximum times c2). Folds the tile's maximum into m2, leaves p (times
// the value scale) in sc and returns the factor alpha that rescales the
// earlier output. A masked pair's logit becomes -inf, which the maximum
// ignores and whose p is 0; a full tile tests nothing. The maxima and sums
// run over four partial accumulators each, so a thread's dependent chains
// are short.
template <bool kMasked, bool kScaled, bool kSegment, int kKeys>
__device__ __forceinline__ void softmax_step(float (&sc)[kKeys / 2],
                                             const StageMeta<kKeys>& mt, int quad,
                                             const int (&qpos)[2], const bool (&qok)[2],
                                             int window, float c2, float (&m2)[2],
                                             float (&l)[2], float (&alpha)[2]) {
  constexpr int kGroups = kKeys / 8;
  float mx[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int a = 0; a < 4; ++a) mx[h][a] = -INFINITY;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int c0 = i * 8 + 2 * quad;
    float2 kf = make_float2(1.f, 1.f);
    if (kScaled) kf = *reinterpret_cast<const float2*>(&mt.kf[c0]);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& x = sc[4 * i + 2 * h + e];
        if (kScaled) x *= e ? kf.y : kf.x;
        if (kMasked) {
          const int delta = qpos[h] - mt.kpos[c0 + e];
          const bool see = qok[h] && mt.kok[c0 + e] &&
                           (kSegment ? delta == 0 : delta >= 0 && delta < window);
          x = see ? x : -INFINITY;
        }
        mx[h][i % 4] = fmaxf(mx[h][i % 4], x);
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float t = group_max(fmaxf(fmaxf(mx[h][0], mx[h][1]), fmaxf(mx[h][2], mx[h][3])), 4);
    if (!kScaled) t *= c2;
    const float m_new = fmaxf(m2[h], t);
    alpha[h] = m2[h] > 0.5f * kNegInf ? ex2(m2[h] - m_new) : 0.f;
    m2[h] = m_new;
  }
  float ps[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    float2 vs = make_float2(1.f, 1.f);
    if (kScaled) vs = *reinterpret_cast<const float2*>(&mt.vs[i * 8 + 2 * quad]);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& x = sc[4 * i + 2 * h + e];
        const float p = kScaled ? ex2(x - m2[h]) : ex2(fmaf(x, c2, -m2[h]));
        ps[h][i % 4] += p;
        if (kScaled) x = p * (e ? vs.y : vs.x);  // rounded to bf16 when packed for PV
        else x = p;
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    l[h] = alpha[h] * l[h] + group_sum((ps[h][0] + ps[h][1]) + (ps[h][2] + ps[h][3]), 4);
}

template <typename KT, bool kScaled, int D, bool kSegment, bool kChunk>
__global__ void __launch_bounds__(kThreads, 1) flash_hopper_kernel(
    const __nv_bfloat16* __restrict__ q, const KT* __restrict__ k,
    const KT* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ q_pos,
    const int* __restrict__ kv_pos, const uint8_t* __restrict__ q_valid,
    const uint8_t* __restrict__ kv_valid, int window,
    __nv_bfloat16* __restrict__ out, float* __restrict__ m_out,
    float* __restrict__ l_out, int B, int T, int S, int H, int Hkv, float scale) {
  using L = Smem<D, kChunk ? 2 : 1>;
  constexpr int kKeys = L::kKeys;
  constexpr int kPerLane = kKeys / 32;  // keys of a tile per producer lane
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static_assert((kStages & (kStages - 1)) == 0, "stage of a tile: a mask");
  const int G = H / Hkv;
  const int TQ = kRows / G;
  const int n_qt = (T + TQ - 1) / TQ;
  const int n_items = n_qt * Hkv * B;
  const int tid = threadIdx.x, lane = tid & 31;
  const int n_tiles = (S + kKeys - 1) / kKeys;
  const size_t HD = static_cast<size_t>(Hkv) * D;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = smem_u32(sm);
  auto q_tile = [&](int buf) { return sbase + L::kQ + buf * L::kQBytes; };
  auto k_tile = [&](int st) { return sbase + L::kTile + st * 2 * L::kTileBytes; };
  auto v_tile = [&](int st) { return k_tile(st) + L::kTileBytes; };
  StageMeta<kKeys>* meta = reinterpret_cast<StageMeta<kKeys>*>(sm + L::kMeta);
  volatile int* cls_of = reinterpret_cast<volatile int*>(sm + L::kCls);
  int* qmeta_pos = reinterpret_cast<int*>(sm + L::kQMeta);  // [buf][row]
  int* qmeta_ok = qmeta_pos + 2 * kRows;
  auto full_bar = [&](int st) { return sbase + L::kBars + 8 * st; };
  auto empty_bar = [&](int st) { return sbase + L::kBars + 8 * (kStages + st); };
  auto qfull_bar = [&](int buf) { return sbase + L::kBars + 8 * (2 * kStages + buf); };
  auto qempty_bar = [&](int buf) { return sbase + L::kBars + 8 * (2 * kStages + 2 + buf); };

  // The work: items of one query tile, KV head and batch row. K1's items
  // run the query tiles last to first (a causal chunk's longest walks
  // first); the others query tile fastest. Block bid takes items bid, then
  // 2 nb - 1 - bid, 2 nb + bid, ...: rounds of nb = gridDim.x, every other
  // one in reverse, so the blocks' loads even out. Each block carries a
  // running tile count g through its items: tile g sits in stage g %
  // kStages, the (g / kStages)-th use of that stage.
  struct Item {
    int t0, j, b;
  };
  auto item_of = [&](int it) {
    Item w;
    if (kChunk) {
      const int per = Hkv * B, rest = it % per;
      w.t0 = (n_qt - 1 - it / per) * TQ;
      w.j = rest % Hkv;
      w.b = rest / Hkv;
    } else {  // a block per item: the grid is (query tile, KV head, row)
      w.t0 = blockIdx.x * TQ;
      w.j = blockIdx.y;
      w.b = blockIdx.z;
    }
    return w;
  };
  const int nb = gridDim.x, bid = blockIdx.x;
  auto item_at = [&](int x) { return x * nb + ((x & 1) ? nb - 1 - bid : bid); };
  // Whether the block has a wi-th item: for a block per item, only wi = 0.
  auto has_item = [&](int wi) { return kChunk ? item_at(wi) < n_items : wi < 1; };

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar(st), 32);  // the producer warp that owns the stage
      mbar_init(empty_bar(st), kConsumers);
    }
    for (int buf = 0; buf < 2; ++buf) {
      mbar_init(qfull_bar(buf), kProducers);
      mbar_init(qempty_bar(buf), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warpgroup's role, broadcast from lane 0 so that the compiler knows
  // it is the same in every lane: wgmma must not sit on a divergent path.
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == kConsumers / 128) {
    // ===== producer warpgroup: per item the query tile (all four warps),
    // then warp pw fills stage pw with the item's tiles g = pw mod 4 =====
    const int pw = __shfl_sync(0xffffffffu, (tid - kConsumers) / 32, 0);
    const int ptid = tid - kConsumers;
    // A tile's key metadata, lane holding keys lane + 32 i: every load is
    // issued at once (none waits on another's value), one tile ahead.
    struct KeyMeta {
      int pos[kPerLane];
      uint8_t ok[kPerLane];
      float kf[kPerLane], vs[kPerLane];
    };
    for (int wi = 0; has_item(wi); ++wi) {
      const Item w = item_of(item_at(wi));
      const int b = w.b, j = w.j, t0 = w.t0, buf = wi & 1;
      auto load_meta = [&](int tile, KeyMeta& km) {
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          const int s = tile * kKeys + lane + 32 * i;
          km.ok[i] = s < S;
          km.pos[i] = km.kf[i] = km.vs[i] = 0;
          if (s < S) {
            if (!kSegment) km.ok[i] = kv_valid[static_cast<size_t>(b) * S + s];
            km.pos[i] = kv_pos[static_cast<size_t>(b) * S + s];
            if (kScaled) {
              const size_t si = (static_cast<size_t>(b) * Hkv + j) * S + s;
              km.kf[i] = k_scale[si];
              km.vs[i] = v_scale[si];
            }
          }
        }
      };
      // This warp's first tile of the item; its metadata is on its way
      // while the query tile is issued.
      const int first = (pw - wi * n_tiles) & (kStages - 1);
      KeyMeta cur, nxt;
      if (first < n_tiles) load_meta(first, cur);

      // K1: the query tile into buffer wi % 2, once the consumers are done
      // with that buffer's last item: row r is token t0 + r / G, head j * G
      // + r % G, swizzled; with each row's position and validity.
      if constexpr (kChunk) {
        const int t = t0 + ptid / G;
        const int p = t < T ? q_pos[static_cast<size_t>(b) * T + t] : 0;
        const bool okq = t < T && (kSegment || q_valid[static_cast<size_t>(b) * T + t]);
        mbar_wait(qempty_bar(buf), ((wi >> 1) & 1) ^ 1);
        qmeta_pos[buf * kRows + ptid] = okq ? p : 0;
        qmeta_ok[buf * kRows + ptid] = okq;
        for (int e = ptid; e < kRows * D / 8; e += kProducers) {
          const int r = e / (D / 8), c = e % (D / 8);
          const int tr = t0 + r / G;
          const uint32_t dst = q_tile(buf) + sw128(r, c, kRows);
          if (tr < T)
            cp_async16_to(dst, q + ((static_cast<size_t>(b) * T + tr) * H + j * G + r % G) * D +
                                   c * 8);
          else
            st_shared16(dst, make_uint4(0u, 0u, 0u, 0u));
        }
        cp_async_mbar_arrive(qfull_bar(buf));
        fence_proxy_async();
        mbar_arrive(qfull_bar(buf));
      }

      // The query tile's range of positions (segment ids) over its valid rows.
      int qmin = INT_MAX, qmax = INT_MIN;
      for (int r = lane; r < kRows; r += 32) {
        const int t = t0 + r / G;
        if (t < T) {  // both loads issued at once
          const int p = q_pos[static_cast<size_t>(b) * T + t];
          if (kSegment || q_valid[static_cast<size_t>(b) * T + t]) {
            qmin = min(qmin, p);
            qmax = max(qmax, p);
          }
        }
      }
      qmin = __reduce_min_sync(0xffffffffu, qmin);
      qmax = __reduce_max_sync(0xffffffffu, qmax);

      for (int tile = first; tile < n_tiles; tile += kStages) {
        const int s0 = tile * kKeys;
        const uint32_t phase = ((wi * n_tiles + tile) / kStages) & 1;
        if (tile + kStages < n_tiles) load_meta(tile + kStages, nxt);
        int kp[kPerLane];
        bool ok[kPerLane];
        float ksv[kPerLane], vsv[kPerLane];
        int kmin = INT_MAX, kmax = INT_MIN;
        bool all_ok = true;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          ok[i] = cur.ok[i];
          kp[i] = ok[i] ? cur.pos[i] : 0;
          ksv[i] = ok[i] ? cur.kf[i] * scale * kLog2e : 0.f;
          vsv[i] = ok[i] ? cur.vs[i] : 0.f;
          all_ok = all_ok && ok[i];
          if (ok[i]) kmin = min(kmin, kp[i]), kmax = max(kmax, kp[i]);
        }
        cur = nxt;
        kmin = __reduce_min_sync(0xffffffffu, kmin);
        kmax = __reduce_max_sync(0xffffffffu, kmax);
        all_ok = __all_sync(0xffffffffu, all_ok);
        // Skipped: no valid query or key, or no pair can be visible. Full:
        // every pair of a valid query row is visible. Else mixed.
        int cls = kSkip;
        if (qmin <= qmax && kmin <= kmax) {
          if (kSegment) {
            if (qmax >= kmin && qmin <= kmax)
              cls = all_ok && qmin == qmax && kmin == kmax && qmin == kmin ? kFull : kMixed;
          } else if (qmax - kmin >= 0 && qmin - kmax < window) {
            // q_pos - kv_pos lies in [qmin - kmax, qmax - kmin].
            cls = all_ok && qmin - kmax >= 0 && qmax - kmin < window ? kFull : kMixed;
          }
        }

        mbar_wait(empty_bar(pw), phase ^ 1);
        if (cls != kSkip) {
          if constexpr (sizeof(KT) == 2) {
            // bf16: cp.async each 16-byte chunk into its swizzled place; the
            // stage's barrier waits for the copies.
            constexpr int kChunks = kKeys * D / 8;
#pragma unroll 8
            for (int e = lane; e < kChunks; e += 32) {
              const int r = e / (D / 8), c = e % (D / 8);
              const uint32_t off = sw128(r, c, kKeys);
              if (s0 + r < S) {
                const size_t g = (static_cast<size_t>(b) * S + s0 + r) * HD + j * D + c * 8;
                cp_async16_to(k_tile(pw) + off, k + g);
                cp_async16_to(v_tile(pw) + off, v + g);
              } else {
                st_shared16(k_tile(pw) + off, make_uint4(0u, 0u, 0u, 0u));
                st_shared16(v_tile(pw) + off, make_uint4(0u, 0u, 0u, 0u));
              }
            }
            cp_async_mbar_arrive(full_bar(pw));
          } else {
            // int8 / e4m3: the raw K and V bytes (kKeys * D each) land by
            // cp.async in the stage's V space, K in its first half and V in
            // its second; K is widened from there into the K space, then V
            // through registers over its own space.
            constexpr int kRaw = kKeys * D;
            constexpr int kLoads = kRaw / 16 / 32;  // 16-byte chunks a lane, per K or V
            const uint32_t raw_k = v_tile(pw), raw_v = v_tile(pw) + kRaw;
#pragma unroll
            for (int i = 0; i < kLoads; ++i) {
              const int e = lane + 32 * i;
              const int r = e / (D / 16), c = e % (D / 16);
              if (s0 + r < S) {
                const size_t g = (static_cast<size_t>(b) * S + s0 + r) * HD + j * D + c * 16;
                cp_async16_to(raw_k + 16 * e, k + g);
                cp_async16_to(raw_v + 16 * e, v + g);
              } else {
                st_shared16(raw_k + 16 * e, make_uint4(0u, 0u, 0u, 0u));
                st_shared16(raw_v + 16 * e, make_uint4(0u, 0u, 0u, 0u));
              }
            }
            cp_async_commit();
            cp_async_wait<0>();
            __syncwarp();
#pragma unroll
            for (int i = 0; i < kLoads; ++i) {
              const int e = lane + 32 * i;
              const int r = e / (D / 16), c = 2 * (e % (D / 16));
              uint4 lo, hi;
              widen16<KT>(ld_shared16(raw_k + 16 * e), lo, hi);
              st_shared16(k_tile(pw) + sw128(r, c, kKeys), lo);
              st_shared16(k_tile(pw) + sw128(r, c + 1, kKeys), hi);
            }
            uint4 raw[kLoads];
#pragma unroll
            for (int i = 0; i < kLoads; ++i) raw[i] = ld_shared16(raw_v + 16 * (lane + 32 * i));
            __syncwarp();  // every lane has read the raw bytes it overwrites next
#pragma unroll
            for (int i = 0; i < kLoads; ++i) {
              const int e = lane + 32 * i;
              const int r = e / (D / 16), c = 2 * (e % (D / 16));
              uint4 lo, hi;
              widen16<KT>(raw[i], lo, hi);
              st_shared16(v_tile(pw) + sw128(r, c, kKeys), lo);
              st_shared16(v_tile(pw) + sw128(r, c + 1, kKeys), hi);
            }
          }
#pragma unroll
          for (int i = 0; i < kPerLane; ++i) {
            const int c = lane + 32 * i;
            meta[pw].kpos[c] = kp[i];
            meta[pw].kok[c] = ok[i];
            if (kScaled) {
              meta[pw].kf[c] = ksv[i];
              meta[pw].vs[c] = vsv[i];
            }
          }
        }
        if (lane == 0) cls_of[pw] = cls;
        fence_proxy_async();
        mbar_arrive(full_bar(pw));
      }
    }
  } else {
    // ===== consumer warpgroups 0 and 1: 64 query rows each, item after item =====
    const int quad = lane & 3;
    const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);  // rows r0, r0 + 8
    const float c2 = scale * kLog2e;
    float m2[2], l[2];    // m2: row max, log2 units
    float o[D / 64][32];  // output: column block n of 64 dims
    float sc[kKeys / 2];
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) sc[i] = 0.f;

    // O += P V for the tile in stage pst: key step kk covers keys
    // 16kk..16kk+15, whose probabilities are the A fragment pa[kk]. V is the
    // MN-major B operand: rows of keys, 64-dim blocks kKeys rows apart.
    uint32_t pa[kKeys / 16][4];
    auto issue_pv = [&](int pst) {
      const uint32_t v_lo = desc_lo(v_tile(pst), kKeys * 128);
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
        for (int n = 0; n < D / 64; ++n)
          wgmma_rs(o[n], pa[kk],
                   desc(v_lo + (n * kKeys * 128 + kk * 16 * 128) / 16));
      wgmma_commit();
    };
    // O *= alpha, the factor of the softmax step since O's last PV product.
    // Most steps leave a row's maximum where it was (alpha = 1): skipped.
    float alpha[2] = {1.f, 1.f};
    auto rescale = [&]() {
      if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
        for (int n = 0; n < D / 64; ++n)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            o[n][4 * i] *= alpha[0];
            o[n][4 * i + 1] *= alpha[0];
            o[n][4 * i + 2] *= alpha[1];
            o[n][4 * i + 3] *= alpha[1];
          }
      }
    };
    // Run the held tile's PV product to its end and free its stage.
    auto flush = [&](int pst) {
      rescale();
      alpha[0] = alpha[1] = 1.f;
      wgmma_fence();
      issue_pv(pst);
      wgmma_wait<0>();
#pragma unroll
      for (int n = 0; n < D / 64; ++n) fence_regs(o[n]);
      mbar_arrive(empty_bar(pst));
    };

    for (int wi = 0; has_item(wi); ++wi) {
      const Item w = item_of(item_at(wi));
      const int b = w.b, j = w.j, t0 = w.t0, buf = kChunk ? wi & 1 : 0;
      int qpos[2];
      bool qok[2];
      if constexpr (kChunk) {  // the producer's query tile and row metadata
        mbar_wait(qfull_bar(buf), (wi >> 1) & 1);
        fence_proxy_async();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          qpos[h] = qmeta_pos[buf * kRows + r0 + 8 * h];
          qok[h] = qmeta_ok[buf * kRows + r0 + 8 * h];
        }
      } else {
        // The query tile, loaded by the two consumer warpgroups while the
        // producer issues the first key tiles (row r is token t0 + r / G,
        // head j * G + r % G), then a barrier of theirs alone.
        if (wi > 0) asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
        for (int e = tid; e < kRows * D / 8; e += kConsumers) {
          const int r = e / (D / 8), c = e % (D / 8);
          const int t = t0 + r / G;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (t < T)
            val = *reinterpret_cast<const uint4*>(
                q + ((static_cast<size_t>(b) * T + t) * H + j * G + r % G) * D + c * 8);
          st_shared16(q_tile(0) + sw128(r, c, kRows), val);
        }
        fence_proxy_async();
        asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + (r0 + 8 * h) / G;
          const int p = t < T ? q_pos[static_cast<size_t>(b) * T + t] : 0;
          qok[h] = t < T && (kSegment || q_valid[static_cast<size_t>(b) * T + t]);
          qpos[h] = qok[h] ? p : 0;
        }
      }
      const uint32_t q_lo = desc_lo(q_tile(buf) + wg * 64 * 128, 16);
      m2[0] = m2[1] = kNegInf;
      l[0] = l[1] = 0.f;
      alpha[0] = alpha[1] = 1.f;
#pragma unroll
      for (int n = 0; n < D / 64; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[n][i] = 0.f;

      // Each step issues S = Q K^T for this tile and, behind it, O += P V
      // for the previous one, so the tensor cores run the PV product while
      // this warpgroup computes the softmax of S.
      int pst = -1;  // the stage whose PV product is still to run (-1: none)
      for (int tile = 0; tile < n_tiles; ++tile) {
        const int g = wi * n_tiles + tile;
        const int st = g & (kStages - 1);
        if (st == pst) {  // kStages - 1 skipped tiles since: the stage is needed again
          flush(pst);
          pst = -1;
        }
        mbar_wait(full_bar(st), (g / kStages) & 1);
        const int cls = __shfl_sync(0xffffffffu, cls_of[st], 0);
        if (cls == kSkip) {
          mbar_arrive(empty_bar(st));
          continue;
        }
        const StageMeta<kKeys>& mt = meta[st];
        fence_proxy_async();

        // S = Q K^T: D / 16 k-steps of 16 dims; then the held tile's PV.
        wgmma_fence();
  #pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;  // inside a 64-dim column block
          wgmma_ss(sc, desc(q_lo + ((kk / 4) * (kRows * 128) + off) / 16),
                   desc(desc_lo(k_tile(st), 16) + ((kk / 4) * (kKeys * 128) + off) / 16), kk > 0);
        }
        wgmma_commit();
        if (pst >= 0) {
          rescale();
          wgmma_fence();
          issue_pv(pst);
        }
        if (pst >= 0)
          wgmma_wait<1>();  // S has landed; the PV product may still run
        else
          wgmma_wait<0>();
        fence_regs(sc);

        if (cls == kMixed)
          softmax_step<true, kScaled, kSegment>(sc, mt, quad, qpos, qok, window, c2, m2, l,
                                                alpha);
        else
          softmax_step<false, kScaled, kSegment>(sc, mt, quad, qpos, qok, window, c2, m2, l,
                                                 alpha);

        // The held tile's PV product done: its stage is free, the A fragments
        // may be written.
        wgmma_wait<0>();
  #pragma unroll
        for (int n = 0; n < D / 64; ++n) fence_regs(o[n]);
        if (pst >= 0) mbar_arrive(empty_bar(pst));
        // The S accumulators of 8-column groups 2kk and 2kk + 1 are exactly
        // the A fragment of key step kk.
  #pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
        pst = st;
      }
      if (pst >= 0) flush(pst);
      if (kChunk) mbar_arrive(qempty_bar(buf));  // every wgmma that reads this query tile is done

  #pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const int t = t0 + r / G;
        if (t >= T) continue;
        const size_t row = (static_cast<size_t>(b) * T + t) * H + j * G + r % G;
        const bool seen = qok[h] && l[h] > 0.f;
        const float inv = seen ? 1.f / l[h] : 0.f;
  #pragma unroll
        for (int n = 0; n < D / 64; ++n)
  #pragma unroll
          for (int i = 0; i < 8; ++i)
            *reinterpret_cast<__nv_bfloat162*>(out + row * D + n * 64 + i * 8 + 2 * quad) =
                seen ? __floats2bfloat162_rn(o[n][4 * i + 2 * h] * inv,
                                             o[n][4 * i + 2 * h + 1] * inv)
                     : __floats2bfloat162_rn(0.f, 0.f);
        if (quad == 0 && m_out != nullptr) {
          m_out[row] = seen ? m2[h] * 0.6931471805599453f : kNegInf;  // natural-log units
          l_out[row] = qok[h] ? l[h] : 0.f;
        }
      }
    }
  }
}

// Launch on `stream`; returns the CUDA error code (0 = launched).
template <typename KT, bool kScaled, int D, bool kSegment, bool kChunk = false>
int launch_flash_hopper(const void* q, const void* k, const void* v, const void* k_scale,
                        const void* v_scale, const void* q_pos, const void* kv_pos,
                        const void* q_valid, const void* kv_valid, int window, void* out,
                        void* m_out, void* l_out, int B, int T, int S, int H, int Hkv,
                        float scale, void* stream) {
  if (Hkv < 1 || H % Hkv != 0 || kRows % (H / Hkv) != 0) return cudaErrorInvalidValue;
  const int TQ = kRows / (H / Hkv);
  const long long n_items = static_cast<long long>((T + TQ - 1) / TQ) * Hkv * B;
  if (n_items == 0) return cudaSuccess;
  if (n_items > INT_MAX) return cudaErrorInvalidValue;
  const int smem = Smem<D, kChunk ? 2 : 1>::kBytes + 1024;  // + room to align tiles to 1 KB
  auto kern = flash_hopper_kernel<KT, kScaled, D, kSegment, kChunk>;
  static std::atomic<unsigned> smem_set{0};
  cudaError_t err = smem_limit_once(reinterpret_cast<const void*>(kern), smem, smem_set);
  if (err != cudaSuccess) return err;
  int n_sm = 0;
  err = sm_count(&n_sm);
  if (err != cudaSuccess) return err;
  // K1's short walks take a persistent grid; the long walks of K4 and K10
  // keep a block per item, which measured faster for them.
  const int n_qt = (T + TQ - 1) / TQ;
  const dim3 grid = kChunk ? dim3(static_cast<unsigned>(n_sm < n_items ? n_sm : n_items))
                           : dim3(n_qt, Hkv, B);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<const uint8_t*>(q_valid),
      static_cast<const uint8_t*>(kv_valid), window, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(m_out), static_cast<float*>(l_out), B, T, S, H, Hkv, scale);
  return cudaGetLastError();
}

}  // namespace hopper
}  // namespace mit
