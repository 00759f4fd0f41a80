// K5: the grouped-dequant product over row tiles, each tile with the weight
// its entry of tile_group selects.
//
// Replaces mistral_inference_tpu/ops/pallas/moe_matmul.py::
// moe_matmul_quant_ragged (kernels _kernel_ragged, _kernel_ragged_stacked).
// Dense prefill at 256 < rows < 8192 is its E = 1 case; sorted-by-expert MoE
// prefill is the general one.
//
// Function: x (Mp, K) bf16, cut into row tiles of TM; q int8 (E, K, N), or
// int4 packed (E, K / 2, N) in split-halves layout; scale fp32 (E, K / g, N);
// optionally both with a leading layer axis, of which `layer` is read. Tile t
// uses weight e = tile_group[t]: out[m, n] = sum over groups G of
// (sum_{k in G} x[m, k] * w_e[k, n]) * scale_e[G, n]. Rounding points as in
// K3 (matmul_quant.cu) and K8, which decode == prefill leans on: the integer
// weight is exact in bf16, each group's dot is summed in fp32, the scale
// multiplies the fp32 partial after the dot, groups are summed in fp32 in
// order, one rounding to bf16. Pad rows are computed like any other row.
//
// Design (on the wgmma primitives of hopper.cuh):
//
// - One block of two warpgroups per 128 x 128 output tile; warpgroup w owns
//   rows 64w..64w+63 and all 128 columns. The grid runs the row blocks
//   fastest, so consecutive blocks walk the row blocks of one weight column
//   panel (and, sorted by expert, one tile's weight): each panel comes from
//   device memory about once per launch, and x, which every panel reads,
//   stays in the 50 MB L2.
// - Products on wgmma m64n128k16 (bf16 in, fp32 accumulate) from shared
//   memory in the 128-byte swizzle: A the x rows, K-major; B the dequantized
//   weight chunk, read through the transpose bit as stored (N-major).
// - Chunks of 64 reduction steps. Chunk c's x rows, stored weight bytes (64
//   x 128) and the scales of the groups it ends land by cp.async in stage c
//   % 6 of a six-stage ring, issued four chunks ahead. The dequantization
//   runs beside the tensor cores: with chunk c's products in flight, each
//   thread converts the weight bytes of chunk c + 1 that it copied itself
//   (exact: int4 through the bf16 pattern of 128 + u, int8 through fp32)
//   into one of three bf16 buffers, then waits for chunk c - 1's products
//   (or, at a group's end, for all). One block barrier per chunk: behind it,
//   chunk c + 1 is whole and converted, and chunk c - 1's stage and weight
//   buffer are free in both warpgroups.
// - Each group's products accumulate into pg; the group's first wgmma zeroes
//   pg through its scale-d operand. When the group ends the warpgroup adds
//   pg * scale to acc, the running sum. acc and pg are 64 fp32 registers
//   each: a tile of 64 x 256 a warpgroup would take 256.
// - The epilogue stages each warpgroup's bf16 tile through the (idle) raw
//   bytes, swizzled, and writes 16-byte pieces.
//
// Batch invariance: no split of the reduction; every output element is one
// warpgroup's accumulator, its groups in order, its chunks in order. A row's
// bits depend on K, its weight and its own x row only: not on Mp, on the
// number of tiles, on E or on the other tiles' weights; nor on N, so a
// column shard of a weight (N / T columns) gives the whole product's columns.
//
// What bounds it on the H100: operations. At the main path's 2048 rows each
// weight byte does 4096 (int8) or 8192 (int4) flops, far above the 295
// flop/byte ridge, so the least time is 2 Mp K N over 989 TFLOP/s. Per chunk
// the tensor cores read 48 KB of operands from shared memory; a group's end
// drains the warpgroup's products before its fold.
#include "hopper.cuh"

namespace mit {
namespace moe {

using namespace hopper;

constexpr int kBM = 128;  // output rows per block: two warpgroups of 64
constexpr int kBN = 128;  // output columns per block
constexpr int kBK = 64;   // reduction steps per chunk: one 128-byte row of x
constexpr int kStages = 6;   // x, stored bytes and scales: loads four chunks ahead
constexpr int kWBufs = 3;    // bf16 weight: chunk c in use, c + 1 converted, c - 1 draining
constexpr int kThreads = 256;
constexpr int kXBytes = kBM * kBK * 2;        // a stage's x rows, bf16, K-major swizzled
constexpr int kWBytes = kBK * kBN * 2;        // a bf16 weight chunk, MN-major swizzled
constexpr int kRawBytes = kBK * kBN;          // a stage's stored weight bytes
constexpr int kScaleBytes = kBK / 16 * kBN * 4;  // the scales of the groups ending in it
constexpr int kX = 0;
constexpr int kW = kX + kStages * kXBytes;
constexpr int kR = kW + kWBufs * kWBytes;
constexpr int kS = kR + kStages * kRawBytes;
constexpr int kSmemBytes = kS + kStages * kScaleBytes + 1024;  // + room to align to 1 KB
static_assert(kStages * kRawBytes >= 2 * 64 * kBN * 2, "the epilogue's tiles fit the raw bytes");

// 16 stored bytes (16 neighbouring columns of one stored row) -> 16 bf16, as
// two 16-byte pieces. int8: the bytes as they are, through the exact fp32
// conversion of common.cuh. int4: the low or the high nibble of each byte,
// sign-extended: u = nibble ^ 8 = v + 8 in [0, 16), and the bf16 with bits
// 0x4300 | u is 128 + u, so subtracting 136 leaves v exactly.
template <int kBits>
__device__ __forceinline__ void dequant16(uint4 raw, bool high, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (kBits == 8) {
      float f[4];
      biased_bytes_to_float(w[i] ^ 0x80808080u, 128.f, f);
      o[2 * i] = high_halves(f[0], f[1]);
      o[2 * i + 1] = high_halves(f[2], f[3]);
    } else {
      const uint32_t u = ((w[i] >> (high ? 4 : 0)) & 0x0F0F0F0Fu) ^ 0x08080808u;
      const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
      uint32_t p[2] = {__byte_perm(u, 0x4343u, 0x4140), __byte_perm(u, 0x4343u, 0x4342)};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&p[j]), bias);
        o[2 * i + j] = *reinterpret_cast<const uint32_t*>(&v);
      }
    }
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// kGS: the k16 steps of a group shorter than a chunk (16 -> 1, 32 -> 2), or
// 0 for a group of whole chunks.
template <int kBits, int kGS>
__global__ void __launch_bounds__(kThreads, 1) moe_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, const int* __restrict__ tile_group,
    __nv_bfloat16* __restrict__ out, int K, int N, int g, int TM, int E, int layer) {
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, lane = tid & 31, quad = lane & 3;
  // The warpgroup, the same in every lane (wgmma must not sit on a path the
  // compiler thinks divergent).
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0), warp = (tid >> 5) & 3;
  const int chunks = K / kBK, half = K / 2;
  // A weight index outside [0, E) is clamped, so that no read leaves the stack.
  const int e = min(max(tile_group[m0 / TM], 0), E - 1);
  const size_t wi = static_cast<size_t>(layer) * E + e;
  const int8_t* qe = q + wi * (kBits == 4 ? half : K) * N + n0;
  const float* se = scale + wi * (K / g) * N + n0;
  const __nv_bfloat16* xb = x + static_cast<size_t>(m0) * K;
  const int gpc = g >= kBK ? 1 : kBK / g;  // groups that end in a chunk that ends one

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = smem_u32(sm);

  // Chunk c into stage c % kStages: x, the stored bytes, the scales of the
  // groups it ends. One commit group per call, empty past the last chunk.
  auto load = [&](int c) {
    if (c < chunks) {
      const int st = c % kStages, k0 = c * kBK;
      const uint32_t xs = sbase + kX + st * kXBytes;
#pragma unroll
      for (int i = 0; i < kBM * 8 / kThreads; ++i) {
        const int p = tid + kThreads * i, r = p >> 3, ch = p & 7;
        cp_async16_to(xs + sw128(r, ch, kBM), xb + static_cast<size_t>(r) * K + k0 + 8 * ch);
      }
      const bool high = kBits == 4 && k0 >= half;
      const int8_t* qrow = qe + static_cast<size_t>(high ? k0 - half : k0) * N;
      const uint32_t rs = sbase + kR + st * kRawBytes;
#pragma unroll
      for (int i = 0; i < kBK * 8 / kThreads; ++i) {
        const int p = tid + kThreads * i, r = p >> 3, ch = p & 7;
        cp_async16_to(rs + 16 * p, qrow + static_cast<size_t>(r) * N + 16 * ch);
      }
      if ((k0 + kBK) % g == 0 && tid < 32 * gpc) {
        const int j = tid >> 5, G = (k0 + kBK) / g - gpc + j;
        cp_async16_to(sbase + kS + st * kScaleBytes + j * kBN * 4 + 16 * (tid & 31),
                      se + static_cast<size_t>(G) * N + 4 * (tid & 31));
      }
    }
    cp_async_commit();
  };
  // Chunk c's stored bytes that this thread copied, dequantized into weight
  // buffer c % kWBufs: its own copies are all it waits for.
  auto convert = [&](int c) {
    const bool high = kBits == 4 && c * kBK >= half;
    const uint32_t rs = sbase + kR + (c % kStages) * kRawBytes;
    const uint32_t ws = sbase + kW + (c % kWBufs) * kWBytes;
#pragma unroll
    for (int i = 0; i < kBK * 8 / kThreads; ++i) {
      const int p = tid + kThreads * i, r = p >> 3, ch = p & 7;
      uint4 lo, hi;
      dequant16<kBits>(ld_shared16(rs + 16 * p), high, lo, hi);
      st_shared16(ws + sw128(r, 2 * ch, kBK), lo);
      st_shared16(ws + sw128(r, 2 * ch + 1, kBK), hi);
    }
  };

  float acc[64], pg[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = pg[i] = 0.f;
  // pg * the scales of slot j of the stage's scales, into acc.
  auto fold = [&](const float* sc, int j) {
    const float* s = sc + j * kBN + 2 * quad;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float2 sv = *reinterpret_cast<const float2*>(s + 8 * i);
      acc[4 * i] += pg[4 * i] * sv.x;
      acc[4 * i + 1] += pg[4 * i + 1] * sv.y;
      acc[4 * i + 2] += pg[4 * i + 2] * sv.x;
      acc[4 * i + 3] += pg[4 * i + 3] * sv.y;
    }
  };

  for (int c = 0; c < kStages - 2; ++c) load(c);
  cp_async_wait<kStages - 3>();  // this thread's copies of chunk 0 have landed
  convert(0);
  fence_proxy_async();
  __syncthreads();

  const int cpg = kGS ? 1 : g / kBK;  // chunks a group spans
  int in_group = 0;                    // chunks of the current group issued so far
  for (int c = 0; c < chunks; ++c) {
    // Behind the last barrier chunk c - 2's products are done in both
    // warpgroups: its stage takes chunk c + 4.
    load(c + kStages - 2);
    const int st = c % kStages;
    const uint32_t a_lo = desc_lo(sbase + kX + st * kXBytes + wg * 64 * 128, 16);
    const uint32_t b_lo = desc_lo(sbase + kW + (c % kWBufs) * kWBytes, kBK * 128);
    const float* sc = reinterpret_cast<const float*>(sm + kS + st * kScaleBytes);
    // A: 32 bytes further per k16 step inside the swizzled row; B: 16 rows.
    if constexpr (kGS == 0) {
      // The chunk is a part of one group: its products go on behind the
      // previous chunk's; the group's first zeroes pg.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_ss<1>(pg, desc(a_lo + 2 * kk), desc(b_lo + kk * 128), kk > 0 || in_group > 0);
      wgmma_commit();
      // While they run: chunk c + 1's weight (its copies by this thread).
      cp_async_wait<kStages - 3>();
      if (c + 1 < chunks) convert(c + 1);
      if (++in_group == cpg) {
        // The group's products done: its scales, after its dot.
        in_group = 0;
        wgmma_wait<0>();
        fence_regs(pg);
        fold(sc, 0);
      } else {
        wgmma_wait<1>();  // chunk c - 1's products are done
      }
    } else {
      cp_async_wait<kStages - 3>();
      if (c + 1 < chunks) convert(c + 1);
      // Groups of kGS k16 steps: each folded before the next starts.
#pragma unroll
      for (int j = 0; j < kBK / 16 / kGS; ++j) {
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kGS; ++s) {
          const int kk = j * kGS + s;
          wgmma_ss<1>(pg, desc(a_lo + 2 * kk), desc(b_lo + kk * 128), s > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(pg);
        fold(sc, j);
      }
    }
    // Chunk c + 1's x and converted weight whole for every thread; chunk c -
    // 1's products done in both warpgroups.
    fence_proxy_async();
    __syncthreads();
  }
  wgmma_wait<0>();  // the last group was waited for; this tells the compiler so

  // Epilogue: the warpgroup's 64 x 128 bf16 tile through the raw bytes (every
  // chunk is converted), 16-byte pieces swizzled by row, then to the output
  // in whole 256-byte rows.
  const uint32_t ep = sbase + kR + wg * (64 * kBN * 2);
  auto piece = [](int row, int ch) { return row * 256 + (((ch & 8) | ((ch ^ row) & 7)) << 4); };
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * warp + (lane >> 2) + 8 * h;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(ep + piece(row, i) + 4 * quad),
                   "r"(pack_bf16(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]))
                   : "memory");
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  const int wt = tid & 127;
  __nv_bfloat16* ob = out + static_cast<size_t>(m0 + 64 * wg) * N + n0;
#pragma unroll
  for (int i = 0; i < 64 * 16 / 128; ++i) {
    const int p = wt + 128 * i, row = p >> 4, ch = p & 15;
    *reinterpret_cast<uint4*>(ob + static_cast<size_t>(row) * N + 8 * ch) =
        ld_shared16(ep + piece(row, ch));
  }
}

template <int kBits, int kGS>
cudaError_t launch(dim3 grid, cudaStream_t st, const __nv_bfloat16* x, const int8_t* q,
                   const float* scale, const int* tg, __nv_bfloat16* out, int K, int N, int g,
                   int TM, int E, int layer) {
  auto kern = moe_matmul_kernel<kBits, kGS>;
  static std::atomic<unsigned> smem_set{0};
  cudaError_t err = smem_limit_once(reinterpret_cast<const void*>(kern), kSmemBytes, smem_set);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, kSmemBytes, st>>>(x, q, scale, tg, out, K, N, g, TM, E, layer);
  return cudaGetLastError();
}

}  // namespace moe
}  // namespace mit

// Rows of x must be a multiple of the row tile TM = Mp / n_tiles, and TM of
// the block's 128 rows; N a multiple of 128; the group g = K / ng a multiple
// of 16 that divides 64 or is a multiple of it; K a multiple of 64, and for
// int4 of 128 (each half a whole number of chunks). `layer` is 0 for an (E,
// ...) stack. The same rules as moe_matmul.py's ragged_shape_ok.
extern "C" int moe_matmul_quant_ragged_bf16(const void* x, const void* q, const void* scale,
                                            const void* tile_group, void* out, int Mp, int K,
                                            int N, int ng, int bits, int n_tiles, int E,
                                            int layer, void* stream) {
  using namespace mit::moe;
  if (Mp < 1 || K < 1 || N < 1 || ng < 1 || n_tiles < 1 || E < 1 || layer < 0)
    return cudaErrorInvalidValue;
  if ((bits != 4 && bits != 8) || Mp % n_tiles != 0 || K % ng != 0 || N % kBN != 0)
    return cudaErrorInvalidValue;
  const int TM = Mp / n_tiles, g = K / ng;
  if (TM % kBM != 0 || g % 16 != 0 || (g % kBK != 0 && kBK % g != 0) ||
      K % (bits == 4 ? 2 * kBK : kBK) != 0 || N / kBN > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(Mp / kBM, N / kBN);  // row blocks fastest: a weight panel's blocks together
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = static_cast<const float*>(scale);
  const auto* tg = static_cast<const int*>(tile_group);
  auto* op = static_cast<__nv_bfloat16*>(out);
#define MIT_K5(bits, gs) launch<bits, gs>(grid, st, xp, qp, sp, tg, op, K, N, g, TM, E, layer)
  if (bits == 8) return g == 16 ? MIT_K5(8, 1) : g == 32 ? MIT_K5(8, 2) : MIT_K5(8, 0);
  return g == 16 ? MIT_K5(4, 1) : g == 32 ? MIT_K5(4, 2) : MIT_K5(4, 0);
#undef MIT_K5
}
