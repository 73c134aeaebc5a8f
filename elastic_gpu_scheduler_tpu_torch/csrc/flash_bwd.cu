// Flash-attention backward (kernel K4) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels of elastic_gpu_scheduler_tpu/ops/attention.py
// launched by `_flash_backward_pallas`: `_flash_bwd_dq_kernel_resident`,
// `_flash_bwd_dkv_kernel_resident`, `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel`.  The FlashAttention-2 backward from the saved
// per-row logsumexp, with delta = rowsum(dO * O) in fp32 computed by the
// wrapper (the TPU side computes it outside its kernels too):
//   p  = exp(Q K^T * scale - lse)           recomputed one tile at a time
//   dP = dO V^T
//   dS = p * (dP - delta) * scale           cast to the input dtype
//   dQ = dS K,  dK = dS^T Q,  dV = p^T dO   (p cast to dO's dtype)
// The (Sq, Sk) matrices never reach device memory.
//
// What bounds it on this card: at the training shape (S 1024, D 128, bf16,
// causal) the five S^2 D products dominate the q/k/v/o/dO/dq/dk/dv bytes,
// so the tensor cores are the limit.  This first version is right and
// simple, in the shape of K1 (csrc/flash_fwd.cu):
//   - two kernels, as on the TPU, so that nothing needs atomics and no
//     state crosses blocks: the dq kernel owns a 64-row query tile and
//     loops over 64-row K/V tiles; the dkv kernel owns a 64-row key tile
//     and loops over 64-row Q/dO tiles;
//   - four warps a block.  Each warp computes S and dP for 16 query rows;
//     in the dkv kernel each warp then owns 16 key rows of dK and dV;
//   - bf16: every product on the tensor cores through WMMA (mma.sync,
//     16x16x16, fp32 accumulate), with the fp32 accumulators (dQ, or dK
//     and dV) in shared memory; fp32: plain FMA, S and dP in registers
//     (the TPU kernel's fp32 path is the "highest"-precision MXU product,
//     and TF32 would not be);
//   - up to 227 KB of dynamic shared memory a block (bf16 dkv at D 128
//     takes ~187 KB), requested with cudaFuncSetAttribute;
//   - tiles wholly outside the causal/window mask are skipped; the others
//     are masked element by element (rows past Sq, keys past Sk, causal
//     with q_shift = Sk - Sq, window), with p = 0 set explicitly, so any
//     Sq <= Sk runs (the TPU side needs `_fit_block`).
// A later PR can move this to wgmma + TMA, keep the accumulators in
// registers and run more than one block an SM.

#include <mma.h>

#include "attn_common.cuh"

namespace {

using namespace nvcuda;
using namespace egs;

constexpr int BT = TILE;  // rows per tile, queries and keys alike
constexpr int NTHREADS = TILE_THREADS;  // four warps, each owning 16 rows

// Shared-memory plan of both kernels.  Row strides in elements; bf16 tiles
// are padded (WMMA wants 32-byte aligned fragment pointers and ldm a
// multiple of 8; the pad spreads rows over the banks).  fp32 tiles are not
// padded, so the fp32 dkv kernel at D 128 fits in 227 KB.
template <typename T, int D>
struct Plan {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int LD = D + (kBf16 ? 8 : 0);      // Q, K, V, dO tiles
  static constexpr int LDS = BT + 4;                  // S, dP in fp32 (bf16 path only)
  static constexpr int LDP = BT + (kBf16 ? 8 : 4);    // P, dS in T
  static constexpr int LDO = D + (kBf16 ? 4 : 0);     // fp32 accumulators
  static constexpr size_t TILE = align128(sizeof(T) * BT * LD);
  static constexpr size_t SCORE = kBf16 ? align128(sizeof(float) * BT * LDS) : 0;
  static constexpr size_t PT = align128(sizeof(T) * BT * LDP);
  static constexpr size_t ACC = align128(sizeof(float) * BT * LDO);
  static constexpr size_t ROW = align128(sizeof(float) * BT);
};

// lse and delta of rows [row0, row0 + 64); rows past the end read 0
__device__ __forceinline__ void load_rows(float* s_lse, float* s_delta,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta, int row0,
                                          int rows_total) {
  for (int i = threadIdx.x; i < BT; i += NTHREADS) {
    const int gr = row0 + i;
    s_lse[i] = gr < rows_total ? lse[gr] : 0.f;
    s_delta[i] = gr < rows_total ? delta[gr] : 0.f;
  }
}

__device__ __forceinline__ bool keep_pair(int qrow, int qpos, int kpos, int Sq, int Sk,
                                          int causal, int window) {
  bool k = qrow < Sq && kpos < Sk;
  if (causal) k = k && kpos <= qpos;
  if (window > 0) k = k && (qpos - kpos) < window;
  return k;
}

// S = Q K^T and dP = dO V^T for this warp's 16 query rows (raw dot
// products, fp32) into sS / sDP: the bf16 path
template <int D, int LD, int LDS>
__device__ __forceinline__ void scores_wmma(float* sS, float* sDP, const __nv_bfloat16* sQ,
                                            const __nv_bfloat16* sK, const __nv_bfloat16* sDO,
                                            const __nv_bfloat16* sV, int wrow) {
  for (int j = 0; j < BT / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> s, dp;
    wmma::fill_fragment(s, 0.f);
    wmma::fill_fragment(dp, 0.f);
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(a, sQ + wrow * LD + kk * 16, LD);
      wmma::load_matrix_sync(b, sK + (j * 16) * LD + kk * 16, LD);
      wmma::mma_sync(s, a, b, s);
      wmma::load_matrix_sync(a, sDO + wrow * LD + kk * 16, LD);
      wmma::load_matrix_sync(b, sV + (j * 16) * LD + kk * 16, LD);
      wmma::mma_sync(dp, a, b, dp);
    }
    wmma::store_matrix_sync(sS + wrow * LDS + j * 16, s, LDS, wmma::mem_row_major);
    wmma::store_matrix_sync(sDP + wrow * LDS + j * 16, dp, LDS, wmma::mem_row_major);
  }
}

// p and dS of this warp's 16 query rows against one 64-key tile, written
// in T to sP (when given) and sDS.  Lane l takes keys l and l + 32.
// bf16: S and dP come from sS / sDP; fp32: computed here by FMA.
template <typename T, int D>
__device__ __forceinline__ void grad_tile(T* sP, T* sDS, const float* sS, const float* sDP,
                                          const T* sQ, const T* sK, const T* sDO,
                                          const T* sV, const float* s_lse,
                                          const float* s_delta, int wrow, int lane, int q0,
                                          int q_shift, int k0, int Sq, int Sk, int causal,
                                          int window, float scale) {
  using P = Plan<T, D>;
  for (int rr = 0; rr < 16; ++rr) {
    const int r = wrow + rr;
    const int qrow = q0 + r;
    const int qpos = qrow + q_shift;
    const float lse_r = s_lse[r];
    const float delta_r = s_delta[r];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = lane + 32 * u;
      float s, dp;
      if constexpr (P::kBf16) {
        s = sS[r * P::LDS + c];
        dp = sDP[r * P::LDS + c];
      } else {
        s = 0.f;
        dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          s += to_float(sQ[r * P::LD + d]) * to_float(sK[c * P::LD + d]);
          dp += to_float(sDO[r * P::LD + d]) * to_float(sV[c * P::LD + d]);
        }
      }
      float p = 0.f, ds = 0.f;
      if (keep_pair(qrow, qpos, k0 + c, Sq, Sk, causal, window)) {
        p = expf(s * scale - lse_r);
        ds = p * (dp - delta_r) * scale;
      }
      if (sP != nullptr) sP[r * P::LDP + c] = from_float<T>(p);
      sDS[r * P::LDP + c] = from_float<T>(ds);
    }
  }
}

// acc (16 rows of this warp, D cols, fp32 in shared memory) += A B, A the
// warp's 16 x 64 rows of `a` (row-major, or the transpose of a 64 x 16
// column block when kTransA), B a 64 x D tile (row-major, stride LD)
template <typename T, int D, bool kTransA>
__device__ __forceinline__ void accumulate(float* acc, const T* a, const T* b, int wrow,
                                           int lane) {
  using P = Plan<T, D>;
  if constexpr (P::kBf16) {
    using Layout = typename std::conditional<kTransA, wmma::col_major, wmma::row_major>::type;
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::load_matrix_sync(c, acc + wrow * P::LDO + j * 16, P::LDO, wmma::mem_row_major);
      for (int kk = 0; kk < BT / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, Layout> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        const T* pa = kTransA ? a + (kk * 16) * P::LDP + wrow : a + wrow * P::LDP + kk * 16;
        wmma::load_matrix_sync(fa, pa, P::LDP);
        wmma::load_matrix_sync(fb, b + (kk * 16) * P::LD + j * 16, P::LD);
        wmma::mma_sync(c, fa, fb, c);
      }
      wmma::store_matrix_sync(acc + wrow * P::LDO + j * 16, c, P::LDO, wmma::mem_row_major);
    }
  } else {
    for (int rr = 0; rr < 16; ++rr) {
      const int r = wrow + rr;
      for (int c = lane; c < D; c += 32) {
        float s = 0.f;
#pragma unroll 8
        for (int kk = 0; kk < BT; ++kk) {
          const float av = kTransA ? to_float(a[kk * P::LDP + r]) : to_float(a[r * P::LDP + kk]);
          s += av * to_float(b[kk * P::LD + c]);
        }
        acc[r * P::LDO + c] += s;
      }
    }
  }
}

// write rows [row0, row0 + 64) of an fp32 shared accumulator to global T
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const float* acc, int row0,
                                           int rows_total) {
  using P = Plan<T, D>;
  for (int i = threadIdx.x; i < BT * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    if (row0 + r < rows_total) dst[(size_t)(row0 + r) * D + c] = from_float<T>(acc[r * P::LDO + c]);
  }
}

template <typename T, int D>
struct DqSmem {
  using P = Plan<T, D>;
  static constexpr size_t Q = 0, DO = Q + P::TILE, K = DO + P::TILE, V = K + P::TILE;
  static constexpr size_t S = V + P::TILE, DP = S + P::SCORE, DS = DP + P::SCORE;
  static constexpr size_t ACC = DS + P::PT, LSE = ACC + P::ACC, DELTA = LSE + P::ROW;
  static constexpr size_t BYTES = DELTA + P::ROW;
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int H, int Sq, int Sk,
                    int causal, int window, float scale) {
  using M = DqSmem<T, D>;
  using P = Plan<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + M::Q);
  T* sDO = reinterpret_cast<T*>(smem + M::DO);
  T* sK = reinterpret_cast<T*>(smem + M::K);
  T* sV = reinterpret_cast<T*>(smem + M::V);
  float* sS = reinterpret_cast<float*>(smem + M::S);
  float* sDP = reinterpret_cast<float*>(smem + M::DP);
  T* sDS = reinterpret_cast<T*>(smem + M::DS);
  float* sAcc = reinterpret_cast<float*>(smem + M::ACC);
  float* sLse = reinterpret_cast<float*>(smem + M::LSE);
  float* sDelta = reinterpret_cast<float*>(smem + M::DELTA);

  const int q0 = blockIdx.x * BT;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const int q_shift = Sk - Sq;
  const int qpos0 = q0 + q_shift;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wrow = warp * 16;

  load_tile<T, D>(sQ, q + bh * Sq * D, q0, Sq, P::LD);
  load_tile<T, D>(sDO, dout + bh * Sq * D, q0, Sq, P::LD);
  load_rows(sLse, sDelta, lse + bh * Sq, delta + bh * Sq, q0, Sq);
  for (int i = tid; i < BT * P::LDO; i += NTHREADS) sAcc[i] = 0.f;

  const int n_kt = (Sk + BT - 1) / BT;
  int kt_end = n_kt;
  if (causal) kt_end = min(n_kt, (qpos0 + BT - 1) / BT + 1);  // above-diagonal tiles
  int kt_begin = 0;
  if (window > 0) {
    const int lo = qpos0 - window + 1;  // earliest key any row of the tile keeps
    kt_begin = lo > 0 ? lo / BT : 0;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's K/V are no longer read
    load_tile<T, D>(sK, k + bh * Sk * D, k0, Sk, P::LD);
    load_tile<T, D>(sV, v + bh * Sk * D, k0, Sk, P::LD);
    __syncthreads();
    if constexpr (P::kBf16) {
      scores_wmma<D, P::LD, P::LDS>(sS, sDP, sQ, sK, sDO, sV, wrow);
      __syncwarp();
    }
    grad_tile<T, D>(nullptr, sDS, sS, sDP, sQ, sK, sDO, sV, sLse, sDelta, wrow, lane, q0,
                    q_shift, k0, Sq, Sk, causal, window, scale);
    __syncwarp();
    accumulate<T, D, false>(sAcc, sDS, sK, wrow, lane);  // dQ += dS K
    __syncwarp();
  }
  __syncthreads();  // the zeroed accumulator is visible even with no tile
  store_rows<T, D>(dq + bh * Sq * D, sAcc, q0, Sq);
}

template <typename T, int D>
struct DkvSmem {
  using P = Plan<T, D>;
  static constexpr size_t K = 0, V = K + P::TILE, Q = V + P::TILE, DO = Q + P::TILE;
  static constexpr size_t S = DO + P::TILE, DP = S + P::SCORE, PP = DP + P::SCORE;
  static constexpr size_t DS = PP + P::PT, DK = DS + P::PT, DV = DK + P::ACC;
  static constexpr size_t LSE = DV + P::ACC, DELTA = LSE + P::ROW;
  static constexpr size_t BYTES = DELTA + P::ROW;
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int H, int Sq, int Sk, int causal, int window, float scale) {
  using M = DkvSmem<T, D>;
  using P = Plan<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem + M::K);
  T* sV = reinterpret_cast<T*>(smem + M::V);
  T* sQ = reinterpret_cast<T*>(smem + M::Q);
  T* sDO = reinterpret_cast<T*>(smem + M::DO);
  float* sS = reinterpret_cast<float*>(smem + M::S);
  float* sDP = reinterpret_cast<float*>(smem + M::DP);
  T* sP = reinterpret_cast<T*>(smem + M::PP);
  T* sDS = reinterpret_cast<T*>(smem + M::DS);
  float* sDK = reinterpret_cast<float*>(smem + M::DK);
  float* sDV = reinterpret_cast<float*>(smem + M::DV);
  float* sLse = reinterpret_cast<float*>(smem + M::LSE);
  float* sDelta = reinterpret_cast<float*>(smem + M::DELTA);

  const int k0 = blockIdx.x * BT;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const int q_shift = Sk - Sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wrow = warp * 16;

  load_tile<T, D>(sK, k + bh * Sk * D, k0, Sk, P::LD);
  load_tile<T, D>(sV, v + bh * Sk * D, k0, Sk, P::LD);
  for (int i = tid; i < BT * P::LDO; i += NTHREADS) {
    sDK[i] = 0.f;
    sDV[i] = 0.f;
  }

  // query tiles that keep some pair with this key tile
  const int n_qt = (Sq + BT - 1) / BT;
  int qt_begin = 0, qt_end = n_qt;
  if (causal) {
    const int first = k0 - q_shift;  // first query row at or past key k0
    qt_begin = first > 0 ? first / BT : 0;
  }
  if (window > 0) {
    const int last = k0 + BT - 1 + window - 1 - q_shift;  // last row within the window
    qt_end = last < 0 ? 0 : min(n_qt, last / BT + 1);
  }

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();  // the previous tile's Q/dO/P/dS are no longer read
    load_tile<T, D>(sQ, q + bh * Sq * D, q0, Sq, P::LD);
    load_tile<T, D>(sDO, dout + bh * Sq * D, q0, Sq, P::LD);
    load_rows(sLse, sDelta, lse + bh * Sq, delta + bh * Sq, q0, Sq);
    __syncthreads();
    if constexpr (P::kBf16) {
      scores_wmma<D, P::LD, P::LDS>(sS, sDP, sQ, sK, sDO, sV, wrow);
      __syncwarp();
    }
    grad_tile<T, D>(sP, sDS, sS, sDP, sQ, sK, sDO, sV, sLse, sDelta, wrow, lane, q0, q_shift,
                    k0, Sq, Sk, causal, window, scale);
    __syncthreads();  // every warp's P/dS rows are in place
    accumulate<T, D, true>(sDV, sP, sDO, wrow, lane);  // dV += P^T dO
    accumulate<T, D, true>(sDK, sDS, sQ, wrow, lane);  // dK += dS^T Q
  }
  __syncthreads();
  store_rows<T, D>(dk + bh * Sk * D, sDK, k0, Sk);
  store_rows<T, D>(dv + bh * Sk * D, sDV, k0, Sk);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int B, H, Sq, Sk, causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dq(const Args& a) {
  constexpr size_t smem = DqSmem<T, D>::BYTES;
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + BT - 1) / BT, a.H, a.B);
  kern<<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.H, a.Sq, a.Sk, a.causal,
      a.window, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Args& a) {
  constexpr size_t smem = DkvSmem<T, D>::BYTES;
  static_assert(smem <= 232448, "dkv tile plan exceeds 227 KB of shared memory");
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sk + BT - 1) / BT, a.H, a.B);
  kern<<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H,
      a.Sq, a.Sk, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <bool kDq, typename T>
int dispatch_d(int D, const Args& a) {
  switch (D) {
    case 32: return kDq ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64: return kDq ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128: return kDq ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kDq>
int dispatch(int D, int dtype, const Args& a) {
  if (dtype == 1) return dispatch_d<kDq, __nv_bfloat16>(D, a);
  if (dtype == 0) return dispatch_d<kDq, float>(D, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/dout (B,H,Sq,D), k/v (B,H,Sk,D) contiguous, Sq <= Sk; lse and delta
// (B,H,Sq) fp32; dq like q.  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError().
extern "C" int egs_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, int B, int H,
                                int Sq, int Sk, int D, int dtype, int causal, int window,
                                float scale, void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, H, Sq, Sk, causal, window, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch<true>(D, dtype, a);
}

// as egs_flash_bwd_dq; dk, dv like k
extern "C" int egs_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv, int B,
                                 int H, int Sq, int Sk, int D, int dtype, int causal, int window,
                                 float scale, void* stream) {
  Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, B, H, Sq, Sk, causal, window, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch<false>(D, dtype, a);
}
