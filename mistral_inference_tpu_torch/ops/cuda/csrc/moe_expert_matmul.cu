// K8: per expert e, buf[e] (C, K) @ dequant(W[e]) (K, N): the grouped
// (per-expert) dequant-matmul of the MoE decode step.
//
// Replaces mistral_inference_tpu/ops/pallas/moe_matmul.py::moe_matmul_quant
// (kernel _kernel) and ::moe_matmul_quant_stacked (kernel _kernel_stacked).
// The stacked form is this same kernel: its caller offsets the weight and
// scale pointers to layer li of the (L, E, ...) stack, so no layer is copied.
//
// Function: x (E, C, K) bf16, the experts' capacity buffers (C <= 128); q
// int8 (E, K, N), or int4 packed (E, K / 2, N) in split-halves layout (byte
// row r holds element r in its low nibble and r + K / 2 in its high one);
// scale fp32 (E, K / g, N); out (E, C, N) bf16. out[e] is the grouped-dequant
// product of x[e] and expert e's weight, with the rounding points of K3 and
// K5: the integer weight is exact in bf16, each group's dot is summed in
// fp32, the scale multiplies the fp32 partial after the dot, the groups are
// summed in fp32 in a fixed order, one rounding to bf16.
//
// Design: the TPU kernel stages a whole (C, K) buffer and a (K, TN) weight
// tile in fast memory. Here each block takes one expert, a panel of columns
// and one slice of the reduction, and every capacity row of the expert, so
// each live expert's weight is read once whatever C is:
//
// - Products on the tensor cores, mma.sync m16n8k16 (bf16 in, fp32
//   accumulate), with the weight as A (16 columns x 16 reduction steps) and
//   the capacity rows on the narrow operand B (8 rows an n-tile). The weight
//   is N-minor as stored, so the two reduction steps of an A register lie in
//   two stored rows. The reduction steps of a 16-step block are permuted
//   (the same permutation in A and B): lane (r, q) takes stored rows 4q..4q+3
//   and columns 4r..4r+3 of its warp's 32, so one 32-bit word per stored row
//   gives it the A registers of two m-tiles, assembled by byte permutes, and
//   one 8-byte load of x its B registers. int4 converts through the bf16
//   pattern of 128 + u (u = nibble ^ 8; one logic op and one bf16x2
//   subtract per pair); int8 through the exact fp32 conversion of
//   common.cuh. A stored int4 byte serves both halves: its low nibbles go to
//   group u, its high ones to group u + ng / 2, each with its own partial.
// - Bytes in flight: the stored bytes of 64 rows x up to 128 columns, with
//   x's matching 64 (int4: 2 x 64) reduction steps of every row, land by
//   cp.async in a ring of four stages, three ahead of the products; small
//   blocks (four warps) let several share an SM.
// - Capacity: one to four n-tiles a warp (instantiated 1, 2, 4). Up to 32
//   rows the four warps take four 32-column strips (128 columns a block); at
//   up to 64 rows two strips of two row groups, at up to 128 one strip of
//   four. The column panel narrows; the sums do not change.
// - Empty experts read no weight: a block first looks at its expert's rows
//   over its slice of the reduction (row 0 first, stopping at the first
//   nonzero); if all are zero (a third of the experts at B = 4, top-2) it
//   contributes zeros and loads nothing.
// - A fixed reduction split: about 1024 stored rows a block, at most 8,
//   chosen from K, N, the group count and the bits alone (never from C or
//   E). The splits of one (expert, panel) are one thread-block cluster; each
//   writes its fp32 partial tile to its shared memory, and each block adds
//   a slice of the tile over the cluster's ranks in split order (distributed
//   shared memory), rounding once. No atomics, no workspace: a row's bits
//   are the same at C = 4 and C = 128, whichever experts share the step.
//
// What bounds it on the H100: bytes at the main path's C = 4: the stored
// weights and scales of the experts that hold a row over 3.35 TB/s (a weight
// byte does 8 or 16 flops). At C = 128 the products come near the bytes.
#include <cooperative_groups.h>

#include "common.cuh"

namespace mit {
namespace expert {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;     // four warps
constexpr int kKC = 64;           // stored rows a stage
constexpr int kStages = 4;
constexpr int kRawPitch = 128;    // bytes a staged stored row (up to 128 columns)
constexpr int kRawBytes = kKC * kRawPitch;
constexpr int kXPitch = kKC + 16;  // bf16 a staged x row: 160 bytes, conflict-free B loads
constexpr int kSplitRows = 1024;  // stored rows a block takes, about
constexpr int kMaxSplits = 8;     // the portable cluster size
constexpr int kMaxRows = 128;

// The shared memory of an instantiation with kXRows capacity rows a block.
template <int kBits, int kXRows>
struct Smem {
  static constexpr int kHalves = kBits == 4 ? 2 : 1;  // x's reduction steps a stored row serves
  static constexpr int kXBytes = kXRows * kXPitch * 2;
  static constexpr int kStage = kRawBytes + kHalves * kXBytes;
  static constexpr int kBytes = kStages * kStage;
};

// The 16-byte piece ch of stored row `row` in a stage: pieces XORed by the
// row's quarter of a 16-row block, so the four rows a warp's lanes read at
// once fall in different banks.
__device__ __forceinline__ int raw_off(int row, int ch) {
  return row * kRawPitch + ((ch ^ (((row >> 2) & 3) << 1)) << 4);
}

// int4: byte c of wa and of wb (two stored rows, one column) -> the bf16
// pairs (row a, row b) of their low nibbles and of their high nibbles.
__device__ __forceinline__ void nibble_pairs(uint32_t wa, uint32_t wb, int c, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t t = __byte_perm(wa, wb, c | (c << 4) | ((4 + c) << 8) | ((4 + c) << 12));
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
  uint32_t p[2] = {(t & 0x000F000Fu) ^ 0x43084308u, ((t >> 4) & 0x000F000Fu) ^ 0x43084308u};
  const __nv_bfloat162 l = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&p[0]), bias);
  const __nv_bfloat162 h = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&p[1]), bias);
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
// [s0, s0 + len) (and, for int4, [half + s0, half + s0 + len)). Row 0 first,
// eight 16-byte loads a thread at once, stopping at the first nonzero. The
// same answer in every thread of the block.
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

// Grid (N / BN, splits, E), clusters of `splits` blocks along y. kNTW
// n-tiles a warp, kRG row groups a block: BN = 128 / kRG columns.
template <int kBits, int kNTW, int kRG>
__global__ void __launch_bounds__(kThreads) moe_expert_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int C, int K, int N,
    int g, int upb) {
  constexpr int kXRows = kRG * kNTW * 8;
  constexpr int kBN = 128 / kRG;
  using L = Smem<kBits, kXRows>;
  constexpr int kHalves = L::kHalves;
  static_assert(kXRows * kBN * 4 <= L::kBytes, "the partial tile fits the stages");
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.y, splits = gridDim.y, e = blockIdx.z;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = lane >> 2, qd = lane & 3;
  const int strip = warp / kRG, rg = warp % kRG;
  const int half = K / 2, ng = K / g;
  const int stored = kBits == 4 ? half : K;
  const int units = kBits == 4 ? ng / 2 : ng;
  const int u0 = split * upb, u1 = min(units, u0 + upb);
  const int s0 = u0 * g, len = (u1 - u0) * g;  // this block's stored rows
  const __nv_bfloat16* xe = x + static_cast<size_t>(e) * C * K;
  const int8_t* qe = q + static_cast<size_t>(e) * stored * N + n0;
  const float* se = scale + static_cast<size_t>(e) * ng * N + n0 + 32 * strip + 4 * r;

  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  float* part = reinterpret_cast<float*>(smem);  // [kXRows][kBN], after the loop

  float acc[2][kNTW][4], pa[2][kNTW][4], pb[2][kNTW][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int t = 0; t < kNTW; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][t][i] = pa[j][t][i] = pb[j][t][i] = 0.f;

  const bool live = any_live(xe, C, K, s0, len, kHalves, half);
  if (live) {
    const int chunks = len / kKC;
    // Chunk c into stage c % kStages: the stored rows' bytes of the panel and
    // x's matching reduction steps of every row. One commit group per call,
    // empty past the last chunk.
    auto fetch = [&](int c) {
      if (c < chunks) {
        const int st = c % kStages, k0 = s0 + c * kKC;
        const uint32_t rs = sbase + st * L::kStage;
        const int8_t* qr = qe + static_cast<size_t>(k0) * N;
        for (int p = tid; p < kKC * kBN / 16; p += kThreads) {
          const int row = p / (kBN / 16), ch = p % (kBN / 16);
          const unsigned dst = rs + raw_off(row, ch);
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                       "l"(qr + static_cast<size_t>(row) * N + 16 * ch));
        }
#pragma unroll
        for (int hh = 0; hh < kHalves; ++hh)
          for (int p = tid; p < C * 8; p += kThreads) {
            const int row = p >> 3, ch = p & 7;
            const unsigned dst = rs + kRawBytes + hh * L::kXBytes + row * kXPitch * 2 + 16 * ch;
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                         "l"(xe + static_cast<size_t>(row) * K + hh * half + k0 + 8 * ch));
          }
      }
      cp_async_commit();
    };

    for (int c = 0; c < kStages - 1; ++c) fetch(c);
    float4 sl = make_float4(0.f, 0.f, 0.f, 0.f), sh = sl;  // the current unit's scales
    const int g16 = g / 16;  // 16-row blocks a unit
    int u = u0, in_unit = 0;  // the current unit, its 16-row blocks done
    for (int c = 0; c < chunks; ++c) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk c is in; every warp is done with chunk c - 1's stage
      fetch(c + kStages - 1);
      const uint32_t rs = sbase + (c % kStages) * L::kStage;
      const unsigned char* xs = smem + (c % kStages) * L::kStage + kRawBytes;
#pragma unroll
      for (int kb = 0; kb < kKC / 16; ++kb) {
        if (in_unit == 0) {  // a unit starts: its scales are on their way
          sl = __ldg(reinterpret_cast<const float4*>(se + static_cast<size_t>(u) * N));
          if (kBits == 4)
            sh = __ldg(reinterpret_cast<const float4*>(se + static_cast<size_t>(u + ng / 2) * N));
        }
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t a = rs + raw_off(kb * 16 + 4 * qd + i, 2 * strip + (r >> 2)) + 4 * (r & 3);
          asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(w[i]) : "r"(a));
        }
        // A registers of m-tile j: (column 2j, steps 4q, 4q+1), (column 2j +
        // 1, the same), (column 2j, steps 4q + 2, 4q + 3), (column 2j + 1, ...).
        uint32_t alo[2][4], ahi[2][4];
        if (kBits == 4) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            nibble_pairs(w[0], w[1], 2 * j, alo[j][0], ahi[j][0]);
            nibble_pairs(w[0], w[1], 2 * j + 1, alo[j][1], ahi[j][1]);
            nibble_pairs(w[2], w[3], 2 * j, alo[j][2], ahi[j][2]);
            nibble_pairs(w[2], w[3], 2 * j + 1, alo[j][3], ahi[j][3]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] ^= 0x80808080u;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            alo[j][0] = byte_pair(w[0], w[1], 2 * j);
            alo[j][1] = byte_pair(w[0], w[1], 2 * j + 1);
            alo[j][2] = byte_pair(w[2], w[3], 2 * j);
            alo[j][3] = byte_pair(w[2], w[3], 2 * j + 1);
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
                acc[j][t][i] += pa[j][t][i] * s;
                pa[j][t][i] = 0.f;
                if (kBits == 4) {
                  const float s2 = i < 2 ? (j ? sh.z : sh.x) : (j ? sh.w : sh.y);
                  acc[j][t][i] += pb[j][t][i] * s2;
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

  // This split's partial tile: rows (capacity) x columns, fp32.
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
  const int total = C * kBN, per = (total + splits - 1) / splits;
  const int end = min(total, (split + 1) * per);
  __nv_bfloat16* oe = out + static_cast<size_t>(e) * C * N + n0;
  for (int i = split * per + tid; i < end; i += kThreads) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float* ps = cluster.map_shared_rank(part, s);
      v = s == 0 ? ps[i] : v + ps[i];
    }
    oe[static_cast<size_t>(i / kBN) * N + i % kBN] = __float2bfloat16_rn(v);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// Reduction units (int4: pairs of groups sharing stored rows) a block takes.
inline int units_per_block(int units, int g) {
  const int want = min(kMaxSplits, max(1, (units * g + kSplitRows - 1) / kSplitRows));
  const int align = g >= kKC ? 1 : kKC / g;  // whole stages
  int upb = (units + want - 1) / want;
  return (upb + align - 1) / align * align;
}

template <int kBits, int kNTW, int kRG>
cudaError_t launch(cudaStream_t st, const __nv_bfloat16* x, const int8_t* q, const float* scale,
                   __nv_bfloat16* out, int E, int C, int K, int N, int g) {
  using L = Smem<kBits, kRG * kNTW * 8>;
  auto kern = moe_expert_matmul_kernel<kBits, kNTW, kRG>;
  static std::atomic<unsigned> smem_set{0};
  cudaError_t err = smem_limit_once(reinterpret_cast<const void*>(kern), L::kBytes, smem_set);
  if (err != cudaSuccess) return err;
  const int units = kBits == 4 ? K / g / 2 : K / g;
  const int upb = units_per_block(units, g);
  const int splits = (units + upb - 1) / upb;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / (128 / kRG), splits, E);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, x, q, scale, out, C, K, N, g, upb);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int kBits>
cudaError_t launch_rows(cudaStream_t st, const __nv_bfloat16* x, const int8_t* q,
                        const float* scale, __nv_bfloat16* out, int E, int C, int K, int N,
                        int g) {
  const int nt = (C + 7) / 8;
  return nt <= 1   ? launch<kBits, 1, 1>(st, x, q, scale, out, E, C, K, N, g)
         : nt <= 2 ? launch<kBits, 2, 1>(st, x, q, scale, out, E, C, K, N, g)
         : nt <= 4 ? launch<kBits, 4, 1>(st, x, q, scale, out, E, C, K, N, g)
         : nt <= 8 ? launch<kBits, 4, 2>(st, x, q, scale, out, E, C, K, N, g)
                   : launch<kBits, 4, 4>(st, x, q, scale, out, E, C, K, N, g);
}

}  // namespace expert
}  // namespace mit

// C at most 128 rows; N a multiple of 128; the group g = K / ng a multiple
// of 16 that divides 64 or is a multiple of it; K a multiple of 64, and for
// int4 of 128 with an even number of groups (a stored row serves a group of
// each half). The same rules as moe_matmul.py's expert_shape_ok.
extern "C" int moe_matmul_quant_bf16(const void* x, const void* q, const void* scale, void* out,
                                     int E, int C, int K, int N, int ng, int bits,
                                     void* stream) {
  using namespace mit::expert;
  if (E < 1 || E > 65535 || C < 1 || C > kMaxRows || K < 1 || N < 1 || ng < 1 ||
      (bits != 4 && bits != 8) || N % 128 != 0 || K % ng != 0)
    return cudaErrorInvalidValue;
  const int g = K / ng;
  if (g % 16 != 0 || (g % kKC != 0 && kKC % g != 0) ||
      K % (bits == 4 ? 2 * kKC : kKC) != 0 || (bits == 4 && ng % 2 != 0))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<__nv_bfloat16*>(out);
  return bits == 8 ? launch_rows<8>(st, xp, qp, sp, op, E, C, K, N, g)
                   : launch_rows<4>(st, xp, qp, sp, op, E, C, K, N, g);
}
