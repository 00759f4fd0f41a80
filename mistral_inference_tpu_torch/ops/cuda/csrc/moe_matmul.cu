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
// K3 (matmul_quant.cu), which decode == prefill leans on: the integer weight
// is exact in bf16, each group's dot is summed in fp32, the scale multiplies
// the fp32 partial after the dot, groups are summed in fp32, one rounding to
// bf16. Pad rows are computed like any other row.
//
// Design: one block of four warps per 128 x 64 output tile; it reads its
// tile's weight index from tile_group itself, so the host never waits for it.
// The block walks K in chunks of up to 64 steps, a whole number per scale
// group, through three shared-memory stages filled by cp.async: while the
// tensor cores work on chunk c, chunks c + 1 and c + 2 are on their way, each
// with its x rows, its stored weight bytes and, with a group's last chunk, the
// group's scales. After the math of chunk c each thread dequantizes the weight
// bytes of chunk c + 1 that it copied itself to bf16 into the other of two
// weight buffers (int4: group G < ng / 2 reads the low nibbles of stored rows
// [G g, (G + 1) g), the others the high nibbles of rows [G g - K / 2, ...)).
// One barrier per chunk. Both products run on the tensor cores with mma.sync
// m16n8k16 (bf16 in, fp32 accumulate): warp w owns rows 32w..32w+31 as two
// 16-row A fragments (ldmatrix), and the N-minor weight chunk is read as B
// fragments with ldmatrix.trans. Each group accumulates into its own fragment,
// which is multiplied by the group's scales and added to the running sum when
// the group ends, so the scale is never folded into a bf16 weight.
//
// What bounds it on the H100: operations. At the main path's 2048 rows each
// weight byte does 4096 (int8) or 8192 (int4) flops, far above the 295
// flop/byte ridge, so the least time is 2 Mp K N over 989 TFLOP/s. The design
// puts the flops on the tensor cores and overlaps the loads with them. What
// holds it several times above that bound: a warp's 32 x 64 tile reads 1.5
// shared-memory wavefronts per mma (two sets of accumulators, the running sum
// and the group's, leave no registers for a larger one), and mma.sync reaches
// about two thirds of the rate of wgmma, which would also take its operands
// from shared memory without ldmatrix. Those are the next steps.
#include "common.cuh"

namespace mit {

constexpr int kMoeBM = 128;      // output rows per block, 32 per warp
constexpr int kMoeBN = 64;       // output columns per block
constexpr int kMoeBK = 64;       // most reduction steps staged at once
constexpr int kMoeThreads = 128;
constexpr int kMoeMinBlocks = 2;  // per SM: what the registers and shared memory allow
// +8 bf16 (16 bytes) per shared-memory row: conflict-free fragment loads,
// every row 16-byte aligned for ldmatrix and cp.async.
constexpr int kMoeXStride = kMoeBK + 8;
constexpr int kMoeWStride = kMoeBN + 8;
constexpr int kMoeStages = 3;    // chunks in shared memory: this one and the next two
constexpr int kMoeXElems = kMoeBM * kMoeXStride;  // one stage of x, bf16
constexpr int kMoeWElems = kMoeBK * kMoeWStride;  // one buffer of the bf16 weight
constexpr int kMoeRawBytes = kMoeBK * kMoeBN;     // one stage of stored weight bytes
// Per stage: x, the stored weight bytes, one group's scales for the tile.
// Besides, two buffers of the dequantized weight.
constexpr int kMoeSmemBytes =
    kMoeStages * (kMoeXElems * 2 + kMoeRawBytes + kMoeBN * 4) + 2 * kMoeWElems * 2;
// 16-byte pieces of a chunk's stored weight bytes per thread.
constexpr int kMoePieces = kMoeRawBytes / 16 / kMoeThreads;

// Four biased bytes (common.cuh) -> four bf16.
__device__ __forceinline__ uint2 biased_bytes_to_bf16(uint32_t u, float bias) {
  float f[4];
  biased_bytes_to_float(u, bias, f);
  return make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
}

// Sixteen neighbouring columns of one stored row -> sixteen bf16: the bytes
// as they are (int8), or of packed int4 the low or the high nibble,
// sign-extended.
template <int kBits>
__device__ __forceinline__ void dequant16(uint4 raw, bool high, __nv_bfloat16* dst) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint2 o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (kBits == 8)
      o[i] = biased_bytes_to_bf16(w[i] ^ 0x80808080u, 128.f);
    else
      o[i] = biased_bytes_to_bf16(((w[i] >> (high ? 4 : 0)) & 0x0F0F0F0Fu) ^ 0x08080808u, 8.f);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(o[0].x, o[0].y, o[1].x, o[1].y);
  d[1] = make_uint4(o[2].x, o[2].y, o[3].x, o[3].y);
}

template <int kBits>
__global__ void __launch_bounds__(kMoeThreads, kMoeMinBlocks) moe_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, const int* __restrict__ tile_group,
    __nv_bfloat16* __restrict__ out, int K, int N, int g, int TM, int E, int layer) {
  const int n0 = blockIdx.x * kMoeBN, m0 = blockIdx.y * kMoeBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad = lane & 3, frow = lane >> 2;
  const int half = K / 2, ng = K / g;
  const int stored = kBits == 4 ? half : K;
  // A weight index outside [0, E) is clamped, so that no read leaves the stack.
  const int e = min(max(tile_group[m0 / TM], 0), E - 1);
  const size_t wi = static_cast<size_t>(layer) * E + e;
  const int8_t* qe = q + wi * stored * N + n0;
  const float* se = scale + wi * ng * N + n0;
  const __nv_bfloat16* xb = x + static_cast<size_t>(m0) * K;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem);     // [stages][kMoeXElems]
  __nv_bfloat16* Ws = Xs + kMoeStages * kMoeXElems;               // [2][kMoeWElems]
  int8_t* Rs = reinterpret_cast<int8_t*>(Ws + 2 * kMoeWElems);    // [stages][kMoeRawBytes]
  float* Ss = reinterpret_cast<float*>(Rs + kMoeStages * kMoeRawBytes);  // [stages][kMoeBN]

  const int bk = min(g, kMoeBK);  // a chunk never straddles a group or the halves
  const int chunks = K / bk;
  const int xvecs = kMoeBM * bk / 8, pieces = bk * kMoeBN / 16;
  const int xsh = bk == 64 ? 3 : bk == 32 ? 2 : 1;  // log2 of a chunk row's 16-byte pieces

  // Chunk c starts on its way into its stage, all by cp.async: its x rows,
  // its stored weight bytes and, with a group's last chunk, the group's
  // scales. One commit group per chunk, empty past the last chunk, so that
  // "all but the newest n groups" always names the same chunks.
  auto fetch = [&](int c) {
    if (c < chunks) {
      const int k0 = c * bk, stage = c % kMoeStages;
      __nv_bfloat16* xs = Xs + stage * kMoeXElems;
      for (int v = tid; v < xvecs; v += kMoeThreads) {
        const int r = v >> xsh, col = (v & ((1 << xsh) - 1)) * 8;
        cp_async16(xs + r * kMoeXStride + col, xb + static_cast<size_t>(r) * K + k0 + col);
      }
      if ((k0 + bk) % g == 0 && tid < kMoeBN / 4)
        cp_async16(Ss + stage * kMoeBN + 4 * tid, se + static_cast<size_t>(k0 / g) * N + 4 * tid);
      const bool high = kBits == 4 && k0 >= half;
      const int8_t* qrow = qe + static_cast<size_t>(high ? k0 - half : k0) * N;
#pragma unroll
      for (int i = 0; i < kMoePieces; ++i) {
        const int v = tid + i * kMoeThreads;
        if (v < pieces)
          cp_async16(Rs + stage * kMoeRawBytes + 16 * v,
                     qrow + static_cast<size_t>(v / (kMoeBN / 16)) * N + (v % (kMoeBN / 16)) * 16);
      }
    }
    cp_async_commit();
  };
  // Chunk c's stored weight bytes, dequantized to bf16 into buffer c & 1. Each
  // thread converts the pieces it copied itself, so its own wait is enough.
  auto stage_weight = [&](int c) {
    const bool high = kBits == 4 && c * bk >= half;
    const int8_t* rs = Rs + (c % kMoeStages) * kMoeRawBytes;
    __nv_bfloat16* ws = Ws + (c & 1) * kMoeWElems;
#pragma unroll
    for (int i = 0; i < kMoePieces; ++i) {
      const int v = tid + i * kMoeThreads;
      if (v < pieces)
        dequant16<kBits>(*reinterpret_cast<const uint4*>(rs + 16 * v), high,
                         ws + (v / (kMoeBN / 16)) * kMoeWStride + (v % (kMoeBN / 16)) * 16);
    }
  };

  // Fragments [m-tile][n-tile][4]: rows 32 warp + 16 mt + frow (+ 8), columns
  // 8 nt + 2 quad (+ 1).
  float acc[2][8][4], pg[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = pg[mt][nt][i] = 0.f;

  for (int c = 0; c < kMoeStages - 1; ++c) fetch(c);
  cp_async_wait<kMoeStages - 2>();  // chunk 0 has landed
  stage_weight(0);
  __syncthreads();

  for (int c = 0; c < chunks; ++c) {
    // The stage of chunk c + stages - 1 held chunk c - 1, last read before the
    // barrier that ended it.
    fetch(c + kMoeStages - 1);

    const __nv_bfloat16* xs = Xs + (c % kMoeStages) * kMoeXElems;
    const __nv_bfloat16* ws = Ws + (c & 1) * kMoeWElems;
    // ldmatrix: lane l addresses row 8 * (l / 8 % 2) + l % 8 of its 16-row
    // tile at reduction step 16kk + 8 * (l / 16): registers 0..3 are the A
    // fragment's (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
    // (rows 8-15, k 8-15).
    const __nv_bfloat16* arow =
        xs + (32 * warp + ((lane >> 3) & 1) * 8 + (lane & 7)) * kMoeXStride + (lane >> 4) * 8;
    // ldmatrix.trans: lane l addresses reduction step 16kk + 8 * (l / 8 % 2)
    // + l % 8 at column 16np + 8 * (l / 16); registers 0, 1 are the B
    // fragment of n-tile 2np and registers 2, 3 that of n-tile 2np + 1.
    const __nv_bfloat16* wrow =
        ws + (((lane >> 3) & 1) * 8 + (lane & 7)) * kMoeWStride + (lane >> 4) * 8;
    for (int kk = 0; kk < bk / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], arow + 16 * mt * kMoeXStride + kk * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, wrow + kk * 16 * kMoeWStride + np * 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(pg[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(pg[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }

    if (((c + 1) * bk) % g == 0) {
      // The group's scales, after its dot.
      const float* ss = Ss + (c % kMoeStages) * kMoeBN + 2 * quad;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 s = *reinterpret_cast<const float2*>(ss + nt * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          acc[mt][nt][0] += pg[mt][nt][0] * s.x;
          acc[mt][nt][1] += pg[mt][nt][1] * s.y;
          acc[mt][nt][2] += pg[mt][nt][2] * s.x;
          acc[mt][nt][3] += pg[mt][nt][3] * s.y;
          pg[mt][nt][0] = pg[mt][nt][1] = pg[mt][nt][2] = pg[mt][nt][3] = 0.f;
        }
      }
    }

    // Chunk c + 1 has landed; its weight goes into the buffer chunk c - 1 used.
    cp_async_wait<kMoeStages - 2>();
    if (c + 1 < chunks) stage_weight(c + 1);
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = m0 + 32 * warp + 16 * mt + frow + 8 * h;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(out + row * N + n0 + nt * 8 + 2 * quad) =
            __floats2bfloat162_rn(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
    }
}

template <int kBits>
cudaError_t moe_launch(dim3 grid, cudaStream_t st, const __nv_bfloat16* x, const int8_t* q,
                       const float* scale, const int* tg, __nv_bfloat16* out, int K, int N,
                       int g, int TM, int E, int layer) {
  // More than the 48 KB a kernel gets without asking.
  cudaError_t err = cudaFuncSetAttribute(moe_matmul_kernel<kBits>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMoeSmemBytes);
  if (err != cudaSuccess) return err;
  moe_matmul_kernel<kBits><<<grid, kMoeThreads, kMoeSmemBytes, st>>>(x, q, scale, tg, out, K, N,
                                                                     g, TM, E, layer);
  return cudaGetLastError();
}

}  // namespace mit

// Rows of x must be a multiple of the row tile TM = Mp / n_tiles, and TM of
// the block's 128 rows; N a multiple of 64; the group g = K / ng a multiple
// of 16 that divides 64 or is a multiple of it; for int4, K / 2 a multiple of
// min(g, 64). `layer` is 0 for an (E, ...) stack.
extern "C" int moe_matmul_quant_ragged_bf16(const void* x, const void* q, const void* scale,
                                            const void* tile_group, void* out, int Mp, int K,
                                            int N, int ng, int bits, int n_tiles, int E,
                                            int layer, void* stream) {
  using namespace mit;
  if (Mp < 1 || K < 1 || N < 1 || ng < 1 || n_tiles < 1 || E < 1 || layer < 0)
    return cudaErrorInvalidValue;
  if ((bits != 4 && bits != 8) || Mp % n_tiles != 0 || K % ng != 0 || N % kMoeBN != 0)
    return cudaErrorInvalidValue;
  const int TM = Mp / n_tiles, g = K / ng;
  const int bk = g < kMoeBK ? g : kMoeBK;
  if (TM % kMoeBM != 0 || g % 16 != 0 || g % bk != 0 || kMoeBK % bk != 0 || K % 8 != 0)
    return cudaErrorInvalidValue;
  if (bits == 4 && (K / 2) % bk != 0) return cudaErrorInvalidValue;
  if (Mp / kMoeBM > 65535) return cudaErrorInvalidValue;
  const dim3 grid(N / kMoeBN, Mp / kMoeBM);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = static_cast<const float*>(scale);
  const auto* tg = static_cast<const int*>(tile_group);
  auto* op = static_cast<__nv_bfloat16*>(out);
  return bits == 8 ? moe_launch<8>(grid, st, xp, qp, sp, tg, op, K, N, g, TM, E, layer)
                   : moe_launch<4>(grid, st, xp, qp, sp, tg, op, K, N, g, TM, E, layer);
}
