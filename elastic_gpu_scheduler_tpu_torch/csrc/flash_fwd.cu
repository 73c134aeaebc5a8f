// Flash-attention forward (kernel K1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels `_flash_kernel_resident` and
// `_flash_kernel` of elastic_gpu_scheduler_tpu/ops/attention.py (launched by
// `_flash_forward_pallas`): out = softmax(Q K^T * scale + causal/window
// mask) V per (batch, head), plus the per-row logsumexp.
//
// What bounds it on this card: at the serving prefill shapes (Sq = Sk up to
// 640, D = 128, bf16) the causal FLOPs dominate the q/k/v/o bytes by far, so
// the tensor cores are the limit.  This first version is right and simple:
//   - one block per (64-row query tile, head, batch), four warps, each warp
//     owning 16 query rows; a loop streams 64-row K/V tiles through shared
//     memory (blocks run in no order, so nothing carries between them);
//   - bf16: Q K^T and P V on the tensor cores through WMMA (mma.sync,
//     16x16x16, fp32 accumulate); fp32: plain FMA (the TPU kernel's fp32
//     path is the "highest"-precision MXU product, and TF32 would not be);
//   - the online softmax statistics (m, l) and the output accumulator stay
//     in fp32 in shared memory; P is cast to V's dtype before P V, as in the
//     TPU kernel and mha_reference;
//   - tiles wholly above the diagonal or below the sliding window are
//     skipped; boundary tiles and the ragged edge (rows past Sq, keys past
//     Sk) are masked element by element; queries sit at the last Sq key
//     positions (q_shift = Sk - Sq); rows with l == 0 write 0.
// A later PR can move this to wgmma + TMA with a producer warp.

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
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Sk,
                 int causal, int window, float scale) {
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
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const T* qg = q + bh * Sq * D;
  const T* kg = k + bh * Sk * D;
  const T* vg = v + bh * Sk * D;
  const int qpos0 = q0 + (Sk - Sq);  // absolute position of query row q0
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
  if (causal) kt_end = min(n_kt, (qpos0 + BQ - 1) / BK + 1);  // above-diagonal tiles
  int kt_begin = 0;
  if (window > 0) {
    const int lo = qpos0 - window + 1;  // earliest key any row of the tile keeps
    kt_begin = lo > 0 ? lo / BK : 0;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
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
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
          wmma::load_matrix_sync(a, sQ + wrow * LD + kk * 16, LD);
          wmma::load_matrix_sync(b, sK + (j * 16) * LD + kk * 16, LD);
          wmma::mma_sync(acc, a, b, acc);
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

    // online softmax over this tile, one row at a time, two columns a lane
    for (int rr = 0; rr < 16; ++rr) {
      const int r = wrow + rr;
      const int qpos = qpos0 + r;
      float x[2];
      bool keep[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = lane + 32 * u;
        const int kpos = k0 + c;
        bool kp = kpos < Sk;
        if (causal) kp = kp && kpos <= qpos;
        if (window > 0) kp = kp && (qpos - kpos) < window;
        keep[u] = kp;
        x[u] = kp ? sS[r * LDS + c] * scale : NEG_INF;
      }
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x[0], x[1])));
      float p[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) p[u] = keep[u] ? expf(x[u] - m_new) : 0.f;
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

    // O = O * alpha + P V for this warp's rows
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
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(a, sP + wrow * LDP + kk * 16, LDP);
          wmma::load_matrix_sync(b, sV + (kk * 16) * LD + j * 16, LD);
          wmma::mma_sync(acc, a, b, acc);
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

  __syncthreads();  // the initial O/m/l writes are visible even with no tile
  // out = O / l (l == 0 -> 0), lse = m + log(l)
  for (int rr = 0; rr < 16; ++rr) {
    const int r = wrow + rr;
    const int row = q0 + r;
    if (row >= Sq) break;
    const float l = sL[r];
    const float ls = (l == 0.f) ? 1.f : l;
    T* og = o + (bh * Sq + row) * D;
    for (int c = lane; c < D; c += 32) og[c] = from_float<T>(sO[r * LDO + c] / ls);
    if (lane == 0) lse[bh * Sq + row] = sM[r] + logf(ls);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
           int Sq, int Sk, int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = Layout<T, D>::BYTES;
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), H, Sq, Sk, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o, void* lse, int B,
               int H, int Sq, int Sk, int causal, int window, float scale, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, lse, B, H, Sq, Sk, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, H, Sq, Sk, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, H, Sq, Sk, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,Sq,D), k/v (B,H,Sk,D) contiguous, Sq <= Sk; o like q; lse (B,H,Sq)
// fp32.  dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int egs_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             int B, int H, int Sq, int Sk, int D, int dtype, int causal,
                             int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, lse, B, H, Sq, Sk, causal, window, scale, s);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, lse, B, H, Sq, Sk, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* egs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
