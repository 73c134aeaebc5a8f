// Blockwise attention with softmax statistics (kernel K3) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_flash_stats_kernel` of
// elastic_gpu_scheduler_tpu/ops/attention.py (launched by
// `flash_block_stats`): for queries at global positions q_offset + i and
// keys at k_offset + j it returns, per (batch, head, query row), the
// UNNORMALISED pv = sum_j p_j v_j with p_j = exp(s_j - m), the row max m
// of the scaled scores s = (q . k) * scale and l = sum_j p_j, so a caller
// can merge blocks (a prefix-cached prefill, a ring-attention hop) or
// normalise (out = pv / l).  Causal keeps (i, j) iff
// q_offset + i >= k_offset + j.
//
// Semantics kept from the TPU kernel:
//   - masked logits are the finite NEG_INF (-1e30), and they take part in
//     the max and the sums: a row that keeps no key at all ends with
//     m = -1e30, l = Sk and pv = sum_j v_j (each masked p is exp(0) = 1);
//   - p is rounded to V's dtype before the P V product, while l sums the
//     unrounded p; products take native-dtype operands, sums are fp32.
//
// What bounds it on this card: bytes, at the engine's shapes (T <= 128
// new queries against a bucketed page span of M <= 1024 keys, Dh 128,
// bf16, 16 query heads on 8 kv-heads): a key's K and V rows (4 Dh bytes)
// serve at most T (H / Hkv) kept pairs of 4 Dh FLOPs, i.e. <= 256 FLOPs a
// byte, under the H100's ridge of ~295, and the fp32 pv output adds
// bytes.  This first version is right and simple, in the style of K1
// (csrc/flash_fwd.cu, whose tile plan and helpers it shares through
// attn_common.cuh):
//   - one block per (64-row query tile, head, batch), four warps, each
//     owning 16 query rows; the block loops over 64-row K/V tiles in
//     shared memory (Hopper blocks run in no order, so nothing carries
//     between blocks; the TPU kernel's all-heads program is split here);
//   - GQA by index: query head h reads kv-head h / (H / Hkv), the cache is
//     never expanded;
//   - bf16: Q K^T and P V through WMMA (16x16x16, fp32 accumulate); fp32:
//     plain FMA (TF32 would not keep the reference's precision);
//   - any Sq and Sk: rows past Sq and keys past Sk are masked out of every
//     sum (keys past Sk are not keys; they are not NEG_INF logits);
//   - tiles wholly above the diagonal are skipped only when every row of
//     the query tile keeps key 0 (then such tiles add exp(-1e30 - m) = 0);
//     a tile with a row that keeps no key runs every key tile, so such rows
//     come out as the TPU kernel's.
// A later PR can group the n_rep query heads of one kv-head in a block
// (one K/V load for all of them) and move to wgmma + TMA.

#include <math.h>
#include <mma.h>

#include "attn_common.cuh"

namespace {

using namespace nvcuda;
using namespace egs;

constexpr int BQ = TILE;  // query rows per block
constexpr int BK = TILE;  // key rows per streamed tile
constexpr int NTHREADS = TILE_THREADS;  // four warps, each owning 16 query rows
template <typename T, int D>
using Layout = FwdLayout<T, D>;

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_stats_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   float* __restrict__ pv, float* __restrict__ m_out, float* __restrict__ l_out,
                   int H, int Hkv, int Sq, int Sk, int causal, int q_offset, int k_offset,
                   float scale) {
  using Lay = Layout<T, D>;
  constexpr int LD = Lay::LD, LDS = Lay::LDS, LDP = Lay::LDP, LDO = Lay::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + Lay::Q_OFF);
  T* sK = reinterpret_cast<T*>(smem + Lay::K_OFF);
  T* sV = reinterpret_cast<T*>(smem + Lay::V_OFF);
  float* sS = reinterpret_cast<float*>(smem + Lay::S_OFF);
  T* sP = reinterpret_cast<T*>(smem + Lay::P_OFF);
  float* sO = reinterpret_cast<float*>(smem + Lay::O_OFF);
  float* sM = reinterpret_cast<float*>(smem + Lay::M_OFF);
  float* sL = reinterpret_cast<float*>(smem + Lay::L_OFF);
  float* sA = reinterpret_cast<float*>(smem + Lay::A_OFF);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const size_t bhk = (size_t)b * Hkv + h / (H / Hkv);  // this head's kv-head
  const T* qg = q + bh * Sq * D;
  const T* kg = k + bhk * Sk * D;
  const T* vg = v + bhk * Sk * D;
  // key index j is kept by query row i iff j <= i + diag
  const int diag = q_offset - k_offset;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wrow = warp * 16;  // this warp's first row in the tile

  load_tile<T, D>(sQ, qg, q0, Sq, LD);
  for (int i = tid; i < BQ * LDO; i += NTHREADS) sO[i] = 0.f;
  if (tid < BQ) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  const int n_kt = (Sk + BK - 1) / BK;
  int kt_end = n_kt;
  if (causal && q0 + diag >= 0) {
    // every row keeps key 0: tiles wholly above the last row's diagonal
    // add nothing (exp(-1e30 - m) = 0) and are skipped
    kt_end = min(n_kt, (q0 + BQ - 1 + diag) / BK + 1);
  }

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K/V are no longer read
    load_tile<T, D>(sK, kg, k0, Sk, LD);
    load_tile<T, D>(sV, vg, k0, Sk, LD);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows (raw dot products, fp32)
    if constexpr (Lay::kBf16) {
      for (int j = 0; j < BK / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
          wmma::load_matrix_sync(a, sQ + wrow * LD + kk * 16, LD);
          wmma::load_matrix_sync(bf, sK + (j * 16) * LD + kk * 16, LD);
          wmma::mma_sync(acc, a, bf, acc);
        }
        wmma::store_matrix_sync(sS + wrow * LDS + j * 16, acc, LDS, wmma::mem_row_major);
      }
    } else {
      for (int rr = 0; rr < 16; ++rr) {
        const int r = wrow + rr;
        for (int c = lane; c < BK; c += 32) {
          float acc = 0.f;
#pragma unroll 8
          for (int d = 0; d < D; ++d) acc += to_float(sQ[r * LD + d]) * to_float(sK[c * LD + d]);
          sS[r * LDS + c] = acc;
        }
      }
    }
    __syncwarp();

    // online softmax over this tile, one row at a time, two columns a lane;
    // a masked key is the logit NEG_INF, a key past Sk is no key at all
    for (int rr = 0; rr < 16; ++rr) {
      const int r = wrow + rr;
      const int row = q0 + r;
      float x[2];
      bool real[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = k0 + lane + 32 * u;
        real[u] = j < Sk;
        const bool kept = real[u] && (!causal || j <= row + diag);
        x[u] = kept ? sS[r * LDS + lane + 32 * u] * scale : (real[u] ? NEG_INF : -INFINITY);
      }
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x[0], x[1])));
      float p[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) p[u] = real[u] ? expf(x[u] - m_new) : 0.f;
      const float sum = warp_sum(p[0] + p[1]);
#pragma unroll
      for (int u = 0; u < 2; ++u) sP[r * LDP + lane + 32 * u] = from_float<T>(p[u]);
      __syncwarp();  // every lane has read sM[r]
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sA[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncwarp();

    // PV = PV * alpha + P V for this warp's rows
    if constexpr (Lay::kBf16) {
      for (int rr = 0; rr < 16; ++rr) {
        const float a = sA[wrow + rr];
        for (int c = lane; c < D; c += 32) sO[(wrow + rr) * LDO + c] *= a;
      }
      __syncwarp();
      for (int j = 0; j < D / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, sO + wrow * LDO + j * 16, LDO, wmma::mem_row_major);
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
          wmma::load_matrix_sync(a, sP + wrow * LDP + kk * 16, LDP);
          wmma::load_matrix_sync(bf, sV + (kk * 16) * LD + j * 16, LD);
          wmma::mma_sync(acc, a, bf, acc);
        }
        wmma::store_matrix_sync(sO + wrow * LDO + j * 16, acc, LDO, wmma::mem_row_major);
      }
    } else {
      for (int rr = 0; rr < 16; ++rr) {
        const int r = wrow + rr;
        const float a = sA[r];
        for (int c = lane; c < D; c += 32) {
          float acc = 0.f;
#pragma unroll 8
          for (int kk = 0; kk < BK; ++kk) acc += to_float(sP[r * LDP + kk]) * to_float(sV[kk * LD + c]);
          sO[r * LDO + c] = sO[r * LDO + c] * a + acc;
        }
      }
    }
    __syncwarp();
  }

  __syncthreads();  // the initial pv/m/l writes are visible even with no tile
  for (int rr = 0; rr < 16; ++rr) {
    const int r = wrow + rr;
    const int row = q0 + r;
    if (row >= Sq) break;
    float* og = pv + (bh * Sq + row) * D;
    for (int c = lane; c < D; c += 32) og[c] = sO[r * LDO + c];
    if (lane == 0) {
      m_out[bh * Sq + row] = sM[r];
      l_out[bh * Sq + row] = sL[r];
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* pv, void* m, void* l, int B,
           int H, int Hkv, int Sq, int Sk, int causal, int q_offset, int k_offset, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = Layout<T, D>::BYTES;
  static_assert(smem <= 232448, "K3 tile layout exceeds a block's shared memory");
  auto kern = flash_stats_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<float*>(pv), static_cast<float*>(m), static_cast<float*>(l), H, Hkv, Sq, Sk,
      causal, q_offset, k_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* pv, void* m, void* l,
               int B, int H, int Hkv, int Sq, int Sk, int causal, int q_offset, int k_offset,
               float scale, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, pv, m, l, B, H, Hkv, Sq, Sk, causal, q_offset, k_offset, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, pv, m, l, B, H, Hkv, Sq, Sk, causal, q_offset, k_offset, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, pv, m, l, B, H, Hkv, Sq, Sk, causal, q_offset, k_offset, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,Sq,D), k/v (B,Hkv,Sk,D) contiguous, Hkv dividing H; pv (B,H,Sq,D)
// fp32; m, l (B,H,Sq) fp32.  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError().
extern "C" int egs_flash_block_stats(const void* q, const void* k, const void* v, void* pv,
                                     void* m, void* l, int B, int H, int Hkv, int Sq, int Sk,
                                     int D, int dtype, int causal, int q_offset, int k_offset,
                                     float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || H % Hkv) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, pv, m, l, B, H, Hkv, Sq, Sk, causal, q_offset,
                                     k_offset, scale, s);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, pv, m, l, B, H, Hkv, Sq, Sk, causal, q_offset,
                             k_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}
