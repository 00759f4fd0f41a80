// Tiled online-softmax attention over one KV head's bf16 keys, with
// mma.sync: the flash_attention kernel (K1). The ring kernel (K4) and the
// vision encoder's segment-masked attention (K10) run the Hopper loop of
// flash_hopper.cuh (wgmma, an asynchronous K/V pipeline, visibility decided
// per tile); K1 is to move onto it, after which this header goes.
//
// Function: for every query row (token t, head h), softmax over the visible
// keys s of (q . k_s) * D^-1/2, times v_s. A key is visible when q_valid[t]
// and kv_valid[s] hold and 0 <= q_pos[t] - kv_pos[s] < window. GQA: head h
// reads KV head h / G. Returns the normalized output and, where m_out is
// given, the online-softmax stats m (row max) and l (sum of exp) for an
// exact merge of two key sets. A row that sees no key returns 0, m = -1e30,
// l = 0.
//
// Layouts (those of the JAX package's kernel): q and out (B, T, H, D); keys
// and values (B, S, Hkv, D); m and l (B, T, H).
//
// Design: one block of 4 warps per (T-tile, kv head, batch row). Its 64 rows
// are 64/G query tokens times the G heads that share the KV head, so each
// K/V tile read from device memory serves the whole group; warp w owns rows
// 16w..16w+15. The block walks S in 64-key tiles staged in shared memory.
// Both products run on the tensor cores with mma.sync m16n8k16 (bf16 in,
// fp32 accumulate): S = Q K^T with Q held in registers as A fragments for
// the whole walk, then O += P V with the probabilities repacked from the S
// accumulators into A fragments and V read with ldmatrix.trans. The running
// max and sum stay in registers, one pair per row half of the thread's
// fragment. A tile in which no (query, key) pair is visible is skipped,
// which halves the work of causal self-attention. Numerics follow the TPU
// kernel: fp32 dots of bf16 values, probabilities rounded to bf16 before the
// PV product.
//
// What bounds it on the H100: at the main path's shape (T = 512 queries over
// S = 512 chunk keys, G = 4) the work is about 4 * D flops per visible
// (query head, key) pair against a few MB of operands, far above the 295
// flop/byte ridge: it is compute-bound, and the design puts the flops on the
// bf16 tensor cores. The launch bounds hold the kernel to 170 registers so
// that three blocks (12 warps) share an SM and hide each other's barriers
// and loads. It does not overlap the next tile's loads with this tile's math
// nor use wgmma, as flash_hopper.cuh does.
#pragma once

#include "common.cuh"

namespace mit {

constexpr int kRows = 64;      // query rows (token, head) per block
constexpr int kKeys = 64;      // keys per S tile
constexpr int kThreads = 128;  // 4 warps x 16 rows
// bf16 elements per shared-memory row of head dim D: +8 (16 bytes) keeps
// every row 16-byte aligned for ldmatrix and puts neighbouring rows 4 banks
// apart (272 bytes at D = 128, 144 at D = 64), so the eight rows of a
// fragment load fall in distinct banks.
template <int D>
constexpr int kStrideOf = D + 8;

template <int D>
inline size_t flash_tile_smem_bytes() {
  return sizeof(__nv_bfloat16) * (kRows + 2 * kKeys) * kStrideOf<D> +
         sizeof(int) * (2 * kRows + 2 * kKeys);
}

// e^x as 2^(x log2 e): exp2f is a few instructions where an accurate expf
// (no fast-math here) is some twenty, and this loop takes 34 per tile and
// thread. It differs from expf by a few ulp, far inside the bf16 output.
__device__ __forceinline__ float exp_(float x) { return exp2f(x * 1.4426950408889634f); }

template <int D>
__global__ void __launch_bounds__(kThreads, 3) flash_tile_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ kv_pos, const uint8_t* __restrict__ q_valid,
    const uint8_t* __restrict__ kv_valid, int window,
    __nv_bfloat16* __restrict__ out, float* __restrict__ m_out,
    float* __restrict__ l_out, int T, int S, int H, int Hkv, float scale) {
  static_assert(D % 16 == 0, "head dim: whole 16-wide k-steps of the QK product");
  constexpr int kStride = kStrideOf<D>;
  const int G = H / Hkv;
  const int TQ = kRows / G;
  const int b = blockIdx.z, j = blockIdx.y, t0 = blockIdx.x * TQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad = lane & 3;  // fragment column pair: 2 * quad, 2 * quad + 1
  const int r0 = warp * 16 + (lane >> 2);  // fragment rows r0 and r0 + 8
  const size_t HD = static_cast<size_t>(Hkv) * D;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kRows x kStride
  __nv_bfloat16* Ks = Qs + kRows * kStride;                          // kKeys x kStride
  __nv_bfloat16* Vs = Ks + kKeys * kStride;                          // kKeys x kStride
  int* qpos_s = reinterpret_cast<int*>(Vs + kKeys * kStride);
  int* qok_s = qpos_s + kRows;
  int* kpos_s = qok_s + kRows;
  int* kok_s = kpos_s + kKeys;

  // Query tile: row r is token t0 + r / G, head j * G + r % G.
  for (int e = tid; e < kRows * D / 8; e += kThreads) {
    const int r = e / (D / 8), d0 = (e % (D / 8)) * 8;
    const int t = t0 + r / G;
    __nv_bfloat16* dst = Qs + r * kStride + d0;
    if (t < T)
      stage8(q + ((static_cast<size_t>(b) * T + t) * H + j * G + r % G) * D + d0, dst);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid < kRows) {
    const int t = t0 + tid / G;
    const bool ok = t < T && q_valid[static_cast<size_t>(b) * T + t];
    qpos_s[tid] = ok ? q_pos[static_cast<size_t>(b) * T + t] : 0;
    qok_s[tid] = ok;
  }
  __syncthreads();

  // Q as A fragments for the whole walk: k-step kk covers dims 16kk..16kk+15.
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* top = Qs + r0 * kStride + kk * 16 + 2 * quad;
    qf[kk][0] = lds32(top);
    qf[kk][1] = lds32(top + 8 * kStride);
    qf[kk][2] = lds32(top + 8);
    qf[kk][3] = lds32(top + 8 * kStride + 8);
  }
  const int qpos[2] = {qpos_s[r0], qpos_s[r0 + 8]};
  const bool qok[2] = {qok_s[r0] != 0, qok_s[r0 + 8] != 0};

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 8][4];  // output accumulators: n-tile nt covers dims 8nt..8nt+7
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nt][i] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kKeys) {
    __syncthreads();  // the previous tile is done with Ks, Vs and the key metadata
    if (tid < kKeys) {
      const int s = s0 + tid;
      const bool ok = s < S && kv_valid[static_cast<size_t>(b) * S + s];
      kpos_s[tid] = ok ? kv_pos[static_cast<size_t>(b) * S + s] : 0;
      kok_s[tid] = ok;
    }
    __syncthreads();

    // Visibility of this thread's fragment entries: bit (h * 16 + nt * 2 + e)
    // for row r0 + 8h and key 8nt + 2quad + e.
    unsigned vis = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = nt * 8 + 2 * quad + e;
          const int delta = qpos[h] - kpos_s[c];
          if (qok[h] && kok_s[c] && delta >= 0 && delta < window)
            vis |= 1u << (h * 16 + nt * 2 + e);
        }
    if (!__syncthreads_or(vis != 0)) continue;  // no visible pair: skip the tile

    for (int e = tid; e < kKeys * D / 8; e += kThreads) {
      const int c = e / (D / 8), d0 = (e % (D / 8)) * 8;
      __nv_bfloat16* kd = Ks + c * kStride + d0;
      __nv_bfloat16* vd = Vs + c * kStride + d0;
      if (s0 + c < S) {
        const size_t off = (static_cast<size_t>(b) * S + s0 + c) * HD + j * D + d0;
        stage8(k + off, kd);
        stage8(v + off, vd);
      } else {
        *reinterpret_cast<uint4*>(kd) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float sc[kKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = 0.f;
      const __nv_bfloat16* krow = Ks + (nt * 8 + (lane >> 2)) * kStride + 2 * quad;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16(sc[nt], qf[kk], lds32(krow + kk * 16), lds32(krow + kk * 16 + 8));
    }

    // Online softmax per row half h (rows r0 and r0 + 8); the four lanes of a
    // quad share a row.
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[nt][2 * h + e];
          x *= scale;
          if (vis >> (h * 16 + nt * 2 + e) & 1u) mx = fmaxf(mx, x);
        }
      mx = group_max(mx, 4);
      const float m_new = fmaxf(m[h], mx);
      alpha[h] = m[h] > 0.5f * kNegInf ? exp_(m[h] - m_new) : 0.f;
      float psum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[nt][2 * h + e];
          const float p = (vis >> (h * 16 + nt * 2 + e) & 1u) ? exp_(x - m_new) : 0.f;
          psum += p;
          x = p;  // rounded to bf16 when packed below
        }
      l[h] = alpha[h] * l[h] + group_sum(psum, 4);
      m[h] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }

    // O += P V. Key step kk covers keys 16kk..16kk+15: the S accumulators of
    // n-tiles 2kk and 2kk + 1 are exactly the A fragment of that step.
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * kk][0], sc[2 * kk][1]), pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      // ldmatrix.trans: lane l addresses key 16kk + 8 * (l / 8 % 2) + l % 8
      // at dim 16np + 8 * (l / 16); registers 0, 1 are the B fragment of
      // n-tile 2np and registers 2, 3 that of n-tile 2np + 1.
      const __nv_bfloat16* vrow =
          Vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kStride + (lane >> 4) * 8;
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vrow + np * 16);
        mma_bf16(o[2 * np], pa, bv[0], bv[1]);
        mma_bf16(o[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const int t = t0 + r / G;
    if (t >= T) continue;
    const size_t row = (static_cast<size_t>(b) * T + t) * H + j * G + r % G;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(out + row * D + nt * 8 + 2 * quad) =
          __floats2bfloat162_rn(o[nt][2 * h] * inv, o[nt][2 * h + 1] * inv);
    if (quad == 0 && m_out != nullptr) {
      m_out[row] = m[h];
      l_out[row] = l[h];
    }
  }
}

// Launch on `stream`; returns the CUDA error code (0 = launched).
template <int D = kHeadDim>
int launch_flash_tile(const void* q, const void* k, const void* v, const void* q_pos,
                      const void* kv_pos,
                      const void* q_valid, const void* kv_valid, int window, void* out,
                      void* m_out, void* l_out, int B, int T, int S, int H, int Hkv,
                      float scale, void* stream) {
  const int G = H / Hkv;
  if (G < 1 || G > kRows || kRows % G != 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  const int TQ = kRows / G;
  const size_t smem = flash_tile_smem_bytes<D>();
  auto kern = flash_tile_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + TQ - 1) / TQ, Hkv, B);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<const uint8_t*>(q_valid),
      static_cast<const uint8_t*>(kv_valid), window, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(m_out), static_cast<float*>(l_out), T, S, H, Hkv, scale);
  return cudaGetLastError();
}

}  // namespace mit
