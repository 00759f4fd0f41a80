// The grouped-dequant product of a few x rows against a streamed integer
// weight, on the tensor cores: the device loop of K3 (matmul_quant.cu, one
// weight) and K8 (moe_expert_matmul.cu, one weight per expert), which wrap it
// in their launchers.
//
// Function of one problem: x (C, K) bf16, C <= 128; q int8 (K, N), or int4
// packed (K / 2, N) in split-halves layout (byte row r holds element r in its
// low nibble and r + K / 2 in its high one, both signed); scale fp32 (K / g,
// N); out (C, N) bf16. out[m, n] = sum over groups G of (sum_{k in G} x[m, k]
// * w[k, n]) * scale[G, n], with the rounding points of the TPU kernels: the
// integer weight is exact in bf16, each group's dot is summed in fp32, the
// scale multiplies the fp32 partial after the dot, the groups are summed in
// fp32 in a fixed order, one rounding to bf16.
//
// Design: each block takes a panel of columns, one slice of the reduction and
// every row of its problem, so the weight is read once whatever C is:
//
// - Products on mma.sync m16n8k16 (bf16 in, fp32 accumulate), with the weight
//   as A (16 columns x 16 reduction steps) and x's rows on the narrow operand
//   B (8 rows an n-tile). The weight is N-minor as stored, so the two
//   reduction steps of an A register lie in two stored rows. The reduction
//   steps of a 16-step block are permuted (the same permutation in A and B):
//   lane (r, q) takes stored rows 4q..4q+3 and columns 4r..4r+3 of its warp's
//   32, so one 32-bit word per stored row gives it the A registers of two
//   m-tiles, assembled by byte permutes, and one 8-byte load of x its B
//   registers. int4 converts through the bf16 pattern of 128 + u (u = nibble
//   ^ 8; one logic op and one bf16x2 subtract per pair); int8 through the
//   exact fp32 conversion of common.cuh.
// - Units of work. int8: a stored row is a reduction step, a unit g stored
//   rows, one scale group. int4 (an even group count): a stored byte serves
//   both halves, its low nibbles group u, its high ones group u + ng / 2,
//   each with its own partial; a unit is g stored rows holding both.
// - Bytes in flight: the stored bytes of 64 rows x the panel, with x's
//   matching reduction steps of every row, land by cp.async in a ring of
//   three stages, two ahead of the products (four or more were slower on the
//   card); the scales of every unit the block takes land with the first
//   stage, so that no unit's end waits on a load of its scales from device
//   memory. A stage keeps a 128-byte line for every 128 / BN rows, its
//   16-byte pieces XORed by the row's quarter of a 16-row block, so the four
//   rows a warp's lanes read at once fall in different banks.
// - Rows: kNTW n-tiles a warp (1 to 4), kRG row groups of kNTW * 8 rows and
//   kStrips 32-column strips a block: 32 * kRG * kStrips threads, a panel of
//   32 * kStrips columns, picked from the row count by launch_rows. Which
//   warp holds a row, and how wide the panel is, do not change the sums.
// - A reduction split chosen by the launcher from K, N, the group count and
//   the bits alone, never from the row count. The splits of one (problem,
//   panel) are one thread-block cluster; each writes its fp32 partial tile to
//   its shared memory, and each block adds a slice of the tile over the
//   cluster's ranks in split order (distributed shared memory), rounding
//   once. No atomics, no workspace: a row's bits are the same whichever rows
//   share the launch.
// - kSkipEmpty (K8): a block first looks at its problem's rows over its slice
//   of the reduction and, if all are zero (an expert no token chose), adds
//   zeros and loads no weight.
//
// The launcher (launch_bits) is shared too: K3 and K8 keep only their shape
// check and their split rule.
//
// What bounds it on the H100: bytes at decode row counts (a weight byte does
// 8 or 16 flops at four rows, far under the 295 flop/byte ridge): the stored
// weights and scales over 3.35 TB/s. Toward 128 rows the products and x's
// reads of L2 (once per panel) come near the weight's bytes.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace mit {
namespace dqmma {

namespace cg = cooperative_groups;

constexpr int kKC = 64;            // stored rows a stage
constexpr int kStages = 3;
constexpr int kXPitch = kKC + 16;  // bf16 a staged x row: 160 bytes, conflict-free B loads
constexpr int kMaxRows = 128;
constexpr int kMaxSplits = 8;      // the portable cluster size

// Scale rows a block stages at most (32 KB at a 128-column panel): a block
// with more (a group of 16 over a long reduction) loads each unit's scales
// from device memory as the unit starts.
constexpr int kMaxScaleRows = 64;

// The shared memory of an instantiation with kXRows rows and a panel of kBN
// columns: the stages, then the scales of `upb` units.
template <int kBits, int kXRows, int kBN>
struct Smem {
  static constexpr int kHalves = kBits == 4 ? 2 : 1;  // x's steps a stored row serves
  static constexpr int kRawBytes = kKC * kBN;
  static constexpr int kXBytes = kXRows * kXPitch * 2;
  static constexpr int kStage = kRawBytes + kHalves * kXBytes;
  static constexpr int kBytes = kStages * kStage;
  static int bytes(int upb) { return kBytes + min(upb * kHalves, kMaxScaleRows) * kBN * 4; }
};

// The dynamic shared memory limit every instantiation is given once.
constexpr int kSmemLimit = 232448;

// The 16-byte piece ch of stored row `row` in a stage of kBN-byte rows.
template <int kBN>
__device__ __forceinline__ int raw_off(int row, int ch) {
  const int byte = row * kBN + 16 * ch;
  return (byte & ~127) | ((((byte >> 4) & 7) ^ (((row >> 2) & 3) << 1)) << 4);
}

// (t & 0x000F000F) ^ 0x43084308 in one logic op: the two nibbles at bits 0-3
// and 16-19 of t, XORed with 8, become the bf16 pair 128 + (v ^ 8) = 136 + v.
__device__ __forceinline__ uint32_t nibble_bias(uint32_t t) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(d) : "r"(t), "n"(0x000F000F), "n"(0x43084308));
  return d;
}

// int4: byte c of wa and of wb (two stored rows, one column) -> the bf16
// pairs (row a, row b) of their low nibbles and of their high nibbles.
__device__ __forceinline__ void nibble_pairs(uint32_t wa, uint32_t wb, int c, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t t = __byte_perm(wa, wb, c | (c << 4) | ((4 + c) << 8) | ((4 + c) << 12));
  const uint32_t bias = 0x43084308u;  // bf16 136, 136
  uint32_t p[2] = {nibble_bias(t), nibble_bias(t >> 4)};
  const __nv_bfloat162 l = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&p[0]),
                                   *reinterpret_cast<const __nv_bfloat162*>(&bias));
  const __nv_bfloat162 h = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&p[1]),
                                   *reinterpret_cast<const __nv_bfloat162*>(&bias));
  lo = *reinterpret_cast<const uint32_t*>(&l);
  hi = *reinterpret_cast<const uint32_t*>(&h);
}

// int8: byte c of wa and of wb, already XORed with 0x80 (u = v + 128) -> the
// bf16 pair (row a, row b), exactly: 2^23 + u as fp32, minus 2^23 + 128, is
// v, whose high half is its bf16.
__device__ __forceinline__ uint32_t byte_pair(uint32_t wa, uint32_t wb, int c) {
  const float magic = 8388608.f + 128.f;
  const float fa = __uint_as_float(__byte_perm(wa, 0x4B000000u, 0x7650 | c)) - magic;
  const float fb = __uint_as_float(__byte_perm(wb, 0x4B000000u, 0x7650 | c)) - magic;
  return __byte_perm(__float_as_uint(fa), __float_as_uint(fb), 0x7632);
}

// True if any of rows [0, C) of xe is nonzero over the reduction steps
// [s0, s0 + len) (and, with two halves, [half + s0, half + s0 + len)). Row 0
// first, eight 16-byte loads a thread at once, stopping at the first nonzero.
// The same answer in every thread of the block.
template <int kThreads>
__device__ __forceinline__ bool any_live(const __nv_bfloat16* xe, int C, int K, int s0, int len,
                                         int halves, int half) {
  // Piece p (8 steps) of the flattened (row, half, offset) order; each round
  // takes eight a thread, kThreads apart, and walks (row, half, offset)
  // forward without dividing.
  const int per_half = len / 8, per_row = per_half * halves, total = C * per_row;
  for (int base = 0; base < total; base += 8 * kThreads) {
    const int p0 = base + threadIdx.x;
    int row = p0 / per_row, rem = p0 - row * per_row;
    bool any = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (row < C) {
        const int hh = rem >= per_half, off = rem - hh * per_half;
        const uint4 v = *reinterpret_cast<const uint4*>(xe + static_cast<size_t>(row) * K +
                                                        hh * half + s0 + 8 * off);
        any |= ((v.x | v.y | v.z | v.w) & 0x7FFF7FFFu) != 0;
      }
      for (rem += kThreads; rem >= per_row; rem -= per_row) ++row;
    }
    if (__syncthreads_or(any)) return true;
  }
  return false;
}

// Grid (N / BN, splits, problems), clusters of `splits` blocks along y.
// Problem z takes rows [z C, z C + C) of x and out (fewer in the last, of
// `rows` in all), the weight at q + z q_stride and its scales at scale + z
// s_stride. A block takes units [split upb, (split + 1) upb): a unit is g
// stored rows, one scale group (int4: two, one a half).
template <int kBits, int kNTW, int kRG, int kStrips, bool kSkipEmpty>
__global__ void __launch_bounds__(32 * kRG * kStrips) dequant_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int C, int rows, int K,
    int N, int g, int upb, long long q_stride, long long s_stride) {
  constexpr int kThreads = 32 * kRG * kStrips;
  constexpr int kXRows = kRG * kNTW * 8;
  constexpr int kBN = 32 * kStrips;
  using L = Smem<kBits, kXRows, kBN>;
  constexpr int kHalves = L::kHalves;
  static_assert(kXRows * kBN * 4 <= L::kBytes, "the partial tile fits the stages");
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.y, splits = gridDim.y, z = blockIdx.z;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = lane >> 2, qd = lane & 3;
  const int strip = warp / kRG, rg = warp % kRG;
  const int cz = min(C, rows - z * C);  // this problem's rows
  const int half = K / 2, ng = K / g;
  const int units = kBits == 4 ? ng / 2 : ng;
  const int u0 = split * upb, u1 = min(units, u0 + upb);
  const int s0 = u0 * g, len = (u1 - u0) * g;  // this block's stored rows
  const __nv_bfloat16* xe = x + static_cast<size_t>(z) * C * K;
  const int8_t* qe = q + z * q_stride + n0;
  const float* se = scale + z * s_stride + n0;

  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  float* part = reinterpret_cast<float*>(smem);  // [kXRows][kBN], after the loop
  // [unit - u0][half][kBN]: the scales of the block's units.
  const float* scales = reinterpret_cast<const float*>(smem + L::kBytes);

  float acc[2][kNTW][4], pa[2][kNTW][4], pb[2][kNTW][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int t = 0; t < kNTW; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][t][i] = pa[j][t][i] = pb[j][t][i] = 0.f;

  bool live = true;
  if constexpr (kSkipEmpty) live = any_live<kThreads>(xe, cz, K, s0, len, kHalves, half);
  if (live) {
    const int chunks = len / kKC;
    // This thread's pieces of a stage's weight rows, the same in every stage:
    // their offsets in the stage and in the weight, computed once.
    constexpr int kPieces = kKC * kBN / 16 / kThreads;
    static_assert(kPieces * kThreads * 16 == kKC * kBN, "whole pieces a thread");
    int soff[kPieces], goff[kPieces];
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int p = tid + i * kThreads, row = p / (kBN / 16), ch = p % (kBN / 16);
      soff[i] = raw_off<kBN>(row, ch);
      goff[i] = row * N + 16 * ch;
    }
    // Chunk c into stage c % kStages: the stored rows' bytes of the panel and
    // x's matching reduction steps of every row. One commit group per call,
    // empty past the last chunk.
    auto fetch = [&](int c) {
      if (c < chunks) {
        const int st = c % kStages, k0 = s0 + c * kKC;
        const uint32_t rs = sbase + st * L::kStage;
        const int8_t* qr = qe + static_cast<size_t>(k0) * N;
#pragma unroll
        for (int i = 0; i < kPieces; ++i) {
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(rs + soff[i]),
                       "l"(qr + goff[i]));
        }
#pragma unroll
        for (int hh = 0; hh < kHalves; ++hh)
          for (int p = tid; p < cz * 8; p += kThreads) {
            const int row = p >> 3, ch = p & 7;
            const unsigned dst = rs + L::kRawBytes + hh * L::kXBytes + row * kXPitch * 2 + 16 * ch;
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                         "l"(xe + static_cast<size_t>(row) * K + hh * half + k0 + 8 * ch));
          }
      }
      cp_async_commit();
    };

    // The units' scale rows, in chunk 0's commit group.
    const bool staged = (u1 - u0) * kHalves <= kMaxScaleRows;
    for (int p = tid; staged && p < (u1 - u0) * kHalves * (kBN / 4); p += kThreads) {
      const int row = p / (kBN / 4), col = 4 * (p % (kBN / 4));
      const int uu = u0 + row / kHalves, hh = row % kHalves;
      const unsigned dst = sbase + L::kBytes + 16 * p;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(se + static_cast<size_t>(uu + hh * (ng / 2)) * N + col));
    }
    for (int c = 0; c < kStages - 1; ++c) fetch(c);
    float4 sl = make_float4(0.f, 0.f, 0.f, 0.f), sh = sl;  // the current unit's scales
    // This lane's word of stored row 4 qd + i of a 16-row block (the next
    // block is 16 rows on: the same swizzle).
    uint32_t woff[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      woff[i] = raw_off<kBN>(4 * qd + i, 2 * strip + (r >> 2)) + 4 * (r & 3);
    const int g16 = g / 16;  // 16-row blocks a unit
    int u = u0, in_unit = 0;  // the current unit, its 16-row blocks done
    for (int c = 0; c < chunks; ++c) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk c is in; every warp is done with chunk c - 1's stage
      fetch(c + kStages - 1);
      const uint32_t rs = sbase + (c % kStages) * L::kStage;
      const unsigned char* xs = smem + (c % kStages) * L::kStage + L::kRawBytes;
#pragma unroll
      for (int kb = 0; kb < kKC / 16; ++kb) {
        if (in_unit == 0) {  // a unit starts: its scales
          const int col = 32 * strip + 4 * r;
          if (staged) {
            const float* su = scales + (u - u0) * kHalves * kBN + col;
            sl = *reinterpret_cast<const float4*>(su);
            if (kBits == 4) sh = *reinterpret_cast<const float4*>(su + kBN);
          } else {
            sl = __ldg(reinterpret_cast<const float4*>(se + static_cast<size_t>(u) * N + col));
            if (kBits == 4)
              sh = __ldg(reinterpret_cast<const float4*>(
                  se + static_cast<size_t>(u + ng / 2) * N + col));
          }
        }
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t a = rs + woff[i] + kb * 16 * kBN;
          asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(w[i]) : "r"(a));
        }
        // A registers of m-tile j: (column 2j, steps 4q, 4q+1), (column 2j +
        // 1, the same), (column 2j, steps 4q + 2, 4q + 3), (column 2j + 1, ...).
        uint32_t alo[2][4], ahi[2][4];
        if (kBits == 8) {
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] ^= 0x80808080u;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            alo[j][0] = byte_pair(w[0], w[1], 2 * j);
            alo[j][1] = byte_pair(w[0], w[1], 2 * j + 1);
            alo[j][2] = byte_pair(w[2], w[3], 2 * j);
            alo[j][3] = byte_pair(w[2], w[3], 2 * j + 1);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            nibble_pairs(w[0], w[1], 2 * j, alo[j][0], ahi[j][0]);
            nibble_pairs(w[0], w[1], 2 * j + 1, alo[j][1], ahi[j][1]);
            nibble_pairs(w[2], w[3], 2 * j, alo[j][2], ahi[j][2]);
            nibble_pairs(w[2], w[3], 2 * j + 1, alo[j][3], ahi[j][3]);
          }
        }
#pragma unroll
        for (int t = 0; t < kNTW; ++t) {
          const int xrow = (rg * kNTW + t) * 8 + r;
#pragma unroll
          for (int hh = 0; hh < kHalves; ++hh) {
            const uint2 b = *reinterpret_cast<const uint2*>(
                xs + hh * L::kXBytes + xrow * kXPitch * 2 + (kb * 16 + 4 * qd) * 2);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (hh == 0)
                mma_bf16(pa[j][t], alo[j], b.x, b.y);
              else
                mma_bf16(pb[j][t], ahi[j], b.x, b.y);
            }
          }
        }
        if (++in_unit == g16) {
          // The unit ends: its groups' scales, after their dots. Columns of
          // m-tile j: 2j (registers 0, 1) and 2j + 1 (registers 2, 3).
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int t = 0; t < kNTW; ++t)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float s = i < 2 ? (j ? sl.z : sl.x) : (j ? sl.w : sl.y);
                acc[j][t][i] = __fmaf_rn(pa[j][t][i], s, acc[j][t][i]);
                pa[j][t][i] = 0.f;
                if (kBits == 4) {
                  const float s2 = i < 2 ? (j ? sh.z : sh.x) : (j ? sh.w : sh.y);
                  acc[j][t][i] = __fmaf_rn(pb[j][t][i], s2, acc[j][t][i]);
                  pb[j][t][i] = 0.f;
                }
              }
          in_unit = 0;
          ++u;
        }
      }
    }
    __syncthreads();  // every warp is done with the stages: part may overwrite them
  }

  // This split's partial tile: rows x columns, fp32.
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int t = 0; t < kNTW; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = (rg * kNTW + t) * 8 + 2 * qd + (i & 1);
        const int col = 32 * strip + 4 * r + 2 * j + (i >> 1);
        part[row * kBN + col] = acc[j][t][i];
      }
  cluster.sync();
  // Block `split` adds its slice of the tile over the cluster's ranks, in
  // split order, and rounds once.
  const int total = cz * kBN, per = (total + splits - 1) / splits;
  const int end = min(total, (split + 1) * per);
  __nv_bfloat16* oe = out + static_cast<size_t>(z) * C * N + n0;
  for (int i = split * per + tid; i < end; i += kThreads) {
    // Every rank's partial loaded first, then added in split order.
    float ps[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < splits) ps[s] = cluster.map_shared_rank(part, s)[i];
    float v = ps[0];
#pragma unroll
    for (int s = 1; s < kMaxSplits; ++s)
      if (s < splits) v += ps[s];
    oe[static_cast<size_t>(i / kBN) * N + i % kBN] = __float2bfloat16_rn(v);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// The weights the loop takes (matmul_quant.py's shape_ok without its row
// count): N a multiple of 128; a group g = K / ng of 16k steps that divides
// the 64-row stage or is a multiple of it; K a multiple of the stage, and for
// int4 of two, with an even group count (a stored row serves a group of each
// half).
inline bool shapes_ok(int K, int N, int ng, int bits) {
  if (K < 1 || N < 1 || ng < 1 || (bits != 4 && bits != 8) || N % 128 != 0 || K % ng != 0)
    return false;
  const int g = K / ng;
  return g % 16 == 0 && (g % kKC == 0 || kKC % g == 0) &&
         K % (bits == 4 ? 2 * kKC : kKC) == 0 && (bits == 8 || ng % 2 == 0);
}

// Units of work of the reduction (int4: pairs of groups sharing stored rows).
inline int units_of(int ng, int bits) { return bits == 4 ? ng / 2 : ng; }

// Units a block takes for `want` splits of `units`, rounded up to whole
// stages (units * g a multiple of kKC stored rows).
inline int aligned_units(int units, int g, int want) {
  int align = 1;
  while ((align * g) % kKC != 0) ++align;
  const int upb = (units + want - 1) / want;
  return (upb + align - 1) / align * align;
}

// One launch over `problems` problems of C rows (`rows` in all): grid (N /
// panel, splits, problems), the splits of a panel one cluster along y.
template <int kBits, int kNTW, int kRG, int kStrips, bool kSkipEmpty>
cudaError_t launch(cudaStream_t st, const __nv_bfloat16* x, const int8_t* q, const float* scale,
                   __nv_bfloat16* out, int C, int rows, int problems, int K, int N, int g,
                   int upb, long long q_stride, long long s_stride) {
  using L = Smem<kBits, kRG * kNTW * 8, 32 * kStrips>;
  auto kern = dequant_mma_kernel<kBits, kNTW, kRG, kStrips, kSkipEmpty>;
  static std::atomic<unsigned> smem_set{0};
  cudaError_t err = smem_limit_once(reinterpret_cast<const void*>(kern), kSmemLimit, smem_set);
  if (err != cudaSuccess) return err;
  const int units = units_of(K / g, kBits);
  const int splits = (units + upb - 1) / upb;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / (32 * kStrips), splits, problems);
  cfg.blockDim = dim3(32 * kRG * kStrips, 1, 1);
  cfg.dynamicSmemBytes = L::bytes(upb);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, x, q, scale, out, C, rows, K, N, g, upb, q_stride,
                           s_stride);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The instantiation for C rows a problem: up to 32 rows one row group of 1-4
// n-tiles a warp over a 128-column panel; up to 64 two row groups, and up to
// 128 four, of 4 n-tiles over 64 columns.
template <int kBits, bool kSkipEmpty>
cudaError_t launch_rows(cudaStream_t st, const __nv_bfloat16* x, const int8_t* q,
                        const float* scale, __nv_bfloat16* out, int C, int rows, int problems,
                        int K, int N, int g, int upb, long long q_stride, long long s_stride) {
  const int nt = (C + 7) / 8;
  const auto f = nt <= 1   ? &launch<kBits, 1, 1, 4, kSkipEmpty>
                 : nt <= 2 ? &launch<kBits, 2, 1, 4, kSkipEmpty>
                 : nt <= 3 ? &launch<kBits, 3, 1, 4, kSkipEmpty>
                 : nt <= 4 ? &launch<kBits, 4, 1, 4, kSkipEmpty>
                 : nt <= 8 ? &launch<kBits, 4, 2, 2, kSkipEmpty>
                           : &launch<kBits, 4, 4, 2, kSkipEmpty>;
  return f(st, x, q, scale, out, C, rows, problems, K, N, g, upb, q_stride, s_stride);
}

// The loop on a shape shapes_ok takes, int4 or int8, `upb` units a block.
template <bool kSkipEmpty>
cudaError_t launch_bits(cudaStream_t st, const void* x, const void* q, const void* scale,
                        void* out, int C, int rows, int problems, int K, int N, int ng, int bits,
                        int upb, long long q_stride, long long s_stride) {
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const int g = K / ng;
  return bits == 8 ? launch_rows<8, kSkipEmpty>(st, xp, qp, sp, op, C, rows, problems, K, N, g,
                                                upb, q_stride, s_stride)
                   : launch_rows<4, kSkipEmpty>(st, xp, qp, sp, op, C, rows, problems, K, N, g,
                                                upb, q_stride, s_stride);
}

}  // namespace dqmma
}  // namespace mit
