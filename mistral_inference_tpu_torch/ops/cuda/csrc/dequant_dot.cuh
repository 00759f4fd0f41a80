// The grouped-dequant product of a few x rows against a streamed integer
// weight: the device code of K3 (matmul_quant.cu), which wraps it in its
// kernels.
//
// Function of one problem: x (M, K) bf16; q int8 (K, N), or int4 packed
// (K / 2, N) in split-halves layout (byte row r holds element r in its low
// nibble and element r + K / 2 in its high nibble, both signed); scale fp32
// (K / g, N). out[m, n] = sum over groups G of (sum_{k in G} x[m, k] *
// w[k, n]) * scale[G, n], with the rounding points of the TPU kernels: the
// integer weight is exact in x's type, each group's dot is summed in fp32,
// the group's scale multiplies the fp32 partial after the dot, groups are
// summed in fp32, and the result is rounded to bf16 once.
//
// Design: a block owns 128 output columns, four x rows and one slice of the
// reduction; its four warps take the slice's groups in turn. The weight is
// N-minor as stored, so a lane reads one 32-bit word (four neighbouring
// columns of one stored row) and a warp reads 128 contiguous bytes per row.
// The x rows of the group in hand sit in shared memory as fp32 and are read
// as broadcasts, four reduction steps per load. For int4 with an even number
// of groups a lane uses both nibbles of each word at once: the low nibbles
// against x[:, r] into the partial of group r / g, the high nibbles against
// x[:, r + K / 2] into that of group r / g + ng / 2, so every stored byte is
// read once. (With an odd number of groups a group may straddle the halves;
// then each logical group is walked on its own and picks its nibble row by
// row.) The reduction is split over blocks where the column blocks alone
// would leave most of the 132 SMs idle. Partial sums go to a workspace and a
// second kernel adds them in a fixed order: no atomics, so the result is the
// same bits on every run. More than four rows are further blocks, which read
// the weight again.
//
// What bounds it on the H100: bytes. At four rows each weight byte does 8 or
// 16 flops, far under the 295 flop/byte ridge, so the least time is the
// weight's bytes (plus scales) over 3.35 TB/s. Reading every stored byte once,
// in full 128-byte rows, from enough blocks to keep every SM loading is what
// the design does about it; it does not yet overlap loads with math
// (cp.async or TMA), and the fp32 FMAs plus the integer-to-float conversions
// (two full-rate ALU operations per weight, common.cuh) bound the int4 case
// before the memory does.
#pragma once

#include "common.cuh"

namespace mit {

constexpr int kMqWarps = 4;
constexpr int kMqThreads = 32 * kMqWarps;
constexpr int kMqCols = 128;          // output columns per block, four per lane
constexpr int kMqRows = 4;            // x rows per block
constexpr int kMqChunk = 128;         // reduction steps staged in shared memory at once
constexpr int kMqTargetBlocks = 528;  // four blocks for each of the 132 SMs

constexpr int kModeInt8 = 0;
constexpr int kModeInt4Paired = 1;  // even group count: both nibbles of a word at once
constexpr int kModeInt4Single = 2;  // any group count: one logical group at a time

// The four weights of one word (four neighbouring columns of a stored row).
__device__ __forceinline__ void bytes_to_float(uint32_t w, float* f) {
  biased_bytes_to_float(w ^ 0x80808080u, 128.f, f);
}

// Low nibble (v << 28) >> 28 and high nibble v >> 4 of each byte, both
// arithmetic, through the exact conversion of common.cuh.
__device__ __forceinline__ void nibbles_to_float(uint32_t w, float* lo, float* hi) {
  biased_bytes_to_float((w & 0x0F0F0F0Fu) ^ 0x08080808u, 8.f, lo);
  biased_bytes_to_float(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 8.f, hi);
}

// One block's share of one problem. A unit of work is one scale group of
// reduction steps: group u for int8 and kModeInt4Single, and for
// kModeInt4Paired stored rows [u g, (u + 1) g), which hold group u in their
// low nibbles and group u + ng / 2 in their high ones. The block takes
// columns [nb, nb + 128), rows [m0, m0 + 4) and units [split upb, (split + 1)
// upb). With part == nullptr (one split) it writes out, else its fp32 partial
// sums to part + split * part_stride, laid out like out.
template <int kMode>
__device__ __forceinline__ void dequant_dot_block(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, float* __restrict__ part, __nv_bfloat16* __restrict__ out,
    int M, int K, int N, int g, int units, int upb, int nb, int split, int m0,
    size_t part_stride) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = nb + 4 * lane;
  const int half = K / 2, ng = K / g;

  __shared__ __align__(16) float xs[kMqWarps][2][kMqRows][kMqChunk];
  __shared__ float red[kMqWarps][kMqRows][kMqCols];

  const int u_begin = split * upb;
  const int u_end = min(units, (split + 1) * upb);

  float acc[kMqRows][4];
#pragma unroll
  for (int m = 0; m < kMqRows; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int u = u_begin + warp; u < u_end; u += kMqWarps) {
    const int ka = u * g;         // first reduction index of the unit's group
    const int kb = half + u * g;  // and of its paired group (kModeInt4Paired)
    float pa[kMqRows][4], pb[kMqRows][4];
#pragma unroll
    for (int m = 0; m < kMqRows; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) pa[m][c] = pb[m][c] = 0.f;

    for (int c0 = 0; c0 < g; c0 += kMqChunk) {
      const int cl = min(kMqChunk, g - c0);
      __syncwarp();  // the previous chunk's reads of xs are done
      for (int e = lane; e < kMqRows * cl; e += 32) {
        const int m = e / cl, j = e - m * cl;
        const bool live = m0 + m < M;
        const __nv_bfloat16* xr = x + static_cast<size_t>(live ? m0 + m : 0) * K + c0 + j;
        xs[warp][0][m][j] = live ? __bfloat162float(xr[ka]) : 0.f;
        if (kMode == kModeInt4Paired) xs[warp][1][m][j] = live ? __bfloat162float(xr[kb]) : 0.f;
      }
      __syncwarp();

#pragma unroll 2
      for (int j = 0; j < cl; j += 4) {
        // Stored row of reduction index k: itself, or k - K / 2 read through
        // the high nibble. Four steps never straddle the halves (K % 8 == 0).
        const int k = ka + c0 + j;
        const bool high = kMode == kModeInt4Single && k >= half;
        const int8_t* qp = q + static_cast<size_t>(high ? k - half : k) * N + n0;
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = __ldg(reinterpret_cast<const uint32_t*>(qp + static_cast<size_t>(i) * N));
        float xa[kMqRows][4], xb[kMqRows][4];
#pragma unroll
        for (int m = 0; m < kMqRows; ++m) {
          const float4 v = *reinterpret_cast<const float4*>(&xs[warp][0][m][j]);
          xa[m][0] = v.x, xa[m][1] = v.y, xa[m][2] = v.z, xa[m][3] = v.w;
          if (kMode == kModeInt4Paired) {
            const float4 t = *reinterpret_cast<const float4*>(&xs[warp][1][m][j]);
            xb[m][0] = t.x, xb[m][1] = t.y, xb[m][2] = t.z, xb[m][3] = t.w;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float fa[4], fb[4];
          if (kMode == kModeInt8) {
            bytes_to_float(w[i], fa);
          } else {
            nibbles_to_float(w[i], fa, fb);
            if (high) {
#pragma unroll
              for (int c = 0; c < 4; ++c) fa[c] = fb[c];
            }
          }
#pragma unroll
          for (int m = 0; m < kMqRows; ++m)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              pa[m][c] = fmaf(xa[m][i], fa[c], pa[m][c]);
              if (kMode == kModeInt4Paired) pb[m][c] = fmaf(xb[m][i], fb[c], pb[m][c]);
            }
        }
      }
    }

    // The group's scale, after its dot.
    const float4 sa = *reinterpret_cast<const float4*>(scale + static_cast<size_t>(u) * N + n0);
#pragma unroll
    for (int m = 0; m < kMqRows; ++m) {
      acc[m][0] += pa[m][0] * sa.x, acc[m][1] += pa[m][1] * sa.y;
      acc[m][2] += pa[m][2] * sa.z, acc[m][3] += pa[m][3] * sa.w;
    }
    if (kMode == kModeInt4Paired) {
      const float4 sb =
          *reinterpret_cast<const float4*>(scale + static_cast<size_t>(ng / 2 + u) * N + n0);
#pragma unroll
      for (int m = 0; m < kMqRows; ++m) {
        acc[m][0] += pb[m][0] * sb.x, acc[m][1] += pb[m][1] * sb.y;
        acc[m][2] += pb[m][2] * sb.z, acc[m][3] += pb[m][3] * sb.w;
      }
    }
  }

  // The block's four warps, added in a fixed order; thread t owns column t.
#pragma unroll
  for (int m = 0; m < kMqRows; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][m][4 * lane + c] = acc[m][c];
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kMqRows; ++m) {
    const int row = m0 + m;
    if (row >= M) break;
    float v = red[0][m][tid];
#pragma unroll
    for (int w = 1; w < kMqWarps; ++w) v += red[w][m][tid];
    const size_t o = static_cast<size_t>(row) * N + nb + tid;
    if (part != nullptr)
      part[static_cast<size_t>(split) * part_stride + o] = v;
    else
      out[o] = __float2bfloat16_rn(v);
  }
}

// Element i of out = sum over splits of part, in split order, rounded to
// bf16 once.
__device__ __forceinline__ void dequant_dot_reduce(const float* __restrict__ part,
                                                   __nv_bfloat16* __restrict__ out, int splits,
                                                   size_t MN) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float v = part[i];
  for (int s = 1; s < splits; ++s) v += part[s * MN + i];
  out[i] = __float2bfloat16_rn(v);
}

inline int mq_units(int ng, int bits) { return (bits == 4 && ng % 2 == 0) ? ng / 2 : ng; }

inline int mq_row_blocks(int M) { return (M + kMqRows - 1) / kMqRows; }

// Units per block, chosen so that a grid of `blocks` blocks before the split
// (column blocks x row blocks) grows to about kMqTargetBlocks.
inline int mq_units_per_block(int blocks, int units) {
  const int want = max(1, min(units, (kMqTargetBlocks + blocks - 1) / blocks));
  return (units + want - 1) / want;
}

// The row blocks share grid z.
inline bool mq_shapes_ok(int M, int K, int N, int ng, int bits) {
  if (M < 1 || K < 1 || N < 1 || ng < 1 || (bits != 4 && bits != 8)) return false;
  if (N % kMqCols != 0 || K % ng != 0 || (K / ng) % 4 != 0 || K % 8 != 0) return false;
  return mq_row_blocks(M) <= 65535;
}

}  // namespace mit
