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
// What bounds it on this card.  At the training shape (B 8, H 16, S 1024,
// D 128, bf16, causal) the five S^2 D products take 86 GFLOP against
// 268 MB of q/k/v/o/dO read and dq/dk/dv written (plus 0.5 MB of lse),
// ~320 FLOPs a byte, about the H100's ridge of ~295: the products bound
// it (0.087 ms), the bytes close behind (0.080 ms).  The first version kept
// the fp32 accumulators in shared memory, stored S and dP there in fp32
// and re-read them a row at a time, copied tiles synchronously and ran
// WMMA at one block an SM: 36x its bound.  The bf16 path now keeps every
// fp32 tile in registers:
//   - two kernels, as on the TPU, so that nothing needs atomics and the
//     gradients are deterministic, bitwise run to run: the dq kernel owns a
//     64-row query tile and loops over 64-key tiles (it recomputes S and dP,
//     7 products in all instead of 5); the dkv kernel owns a 64-key tile
//     and loops over 64-row query tiles.  Four warps a block, each owning
//     16 rows of the block's own tile;
//   - the dkv kernel computes S^T = K Q^T and dP^T = V dO^T, so a warp's
//     accumulator rows are its own keys and P^T and dS^T are already, once
//     rounded and packed, the A operands of dV += P^T dO and dK += dS^T Q.
//     At D 128 it takes the query tile in two passes of 32 columns, so dK,
//     dV (64 registers each), S^T and dP^T fit in registers together;
//   - the dq kernel keeps S, dP and dQ in registers and packs dS to bf16 in
//     registers as the A operand of dQ += dS K;
//   - the streamed tiles (K and V in dq; Q, dO and the lse and delta rows
//     in dkv) come by 16-byte cp.async into a 2-stage ring of XOR-swizzled
//     shared memory, the next tile in flight during the current one's
//     products; fragments by ldmatrix (.trans where an operand is
//     transposed), products on mma.sync.m16n8k16 (bf16 in, fp32
//     accumulate);
//   - under causal the grid starts with the heaviest tiles: the first key
//     tiles for dkv, the last query tiles for dq; tiles wholly outside the
//     causal/window mask are skipped, a warp skips the part its rows keep
//     nothing of, and only edge tiles are masked element by element (rows
//     past Sq, keys past Sk, causal with q_shift = Sk - Sq, window), with p
//     = 0 set explicitly, so any Sq <= Sk runs (the TPU side needs
//     `_fit_block`).
// float32 keeps the first version (it carries the float32 card-vs-CPU
// training identity): the same two kernels with plain FMA (the TPU
// kernel's fp32 path is the "highest"-precision MXU product, and TF32
// would not be), S and dP in registers, P, dS and the accumulators in
// shared memory (dkv at D 128 takes ~187 KB, requested with
// cudaFuncSetAttribute).  A later PR can move the bf16 path to wgmma.

#include <math.h>

#include "attn_common.cuh"
#include "warp_mma.cuh"

namespace {

using namespace egs;

__device__ __forceinline__ bool keep_pair(int qrow, int qpos, int kpos, int Sq, int Sk,
                                          int causal, int window) {
  return qrow < Sq && keeps(qpos, kpos, Sk, causal, window);
}

// -- bf16: registers, cp.async, mma.sync -------------------------------------

constexpr int BQ = 64;   // query rows a tile
constexpr int BK = 64;   // key rows a tile
constexpr int NT = 128;  // four warps, each owning 16 rows of the block's tile

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * (2 * BQ * D + 4 * BK * D);  // Q, dO, then 2 stages of K and of V
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int Sq, int Sk, int causal, int window,
                         float scale) {
  constexpr int CH = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + BQ * D;
  bf16* sK = sDO + BQ * D;     // stage s at sK + s * BK * D
  bf16* sV = sK + 2 * BK * D;  // stage s at sV + s * BK * D

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y) * BQ;
  const size_t bh = blockIdx.x;
  const bf16* kg = k + bh * Sk * D;
  const bf16* vg = v + bh * Sk * D;
  const int q_shift = Sk - Sq;
  const int qpos0 = q0 + q_shift;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = warp * 16;
  const int qw0 = qpos0 + wrow;  // position of this warp's first row
  const bool rows_past = q0 + wrow + 16 > Sq;

  const int n_kt = (Sk + BK - 1) / BK;
  int kt_end = n_kt;
  if (causal) kt_end = min(n_kt, (qpos0 + BQ - 1) / BK + 1);  // above-diagonal tiles
  int kt_begin = 0;
  if (window > 0) {
    const int lo = qpos0 - window + 1;  // earliest key any row of the tile keeps
    kt_begin = lo > 0 ? lo / BK : 0;
  }

  cp_tile<BQ, D, NT>(sQ, q + bh * Sq * D, q0, Sq);
  cp_tile<BQ, D, NT>(sDO, dout + bh * Sq * D, q0, Sq);
  if (kt_begin < kt_end) {
    cp_tile<BK, D, NT>(sK, kg, kt_begin * BK, Sk);
    cp_tile<BK, D, NT>(sV, vg, kt_begin * BK, Sk);
  }
  cp_async_commit();

  float lse_r[2], delta_r[2];  // rows g and g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wrow + g + 8 * i;
    lse_r[i] = row < Sq ? lse[bh * Sq + row] : 0.f;
    delta_r[i] = row < Sq ? delta[bh * Sq + row] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
    if (kt + 1 < kt_end) {
      cp_tile<BK, D, NT>(sK + (st ^ 1) * BK * D, kg, (kt + 1) * BK, Sk);
      cp_tile<BK, D, NT>(sV + (st ^ 1) * BK * D, vg, (kt + 1) * BK, Sk);
    }
    cp_async_commit();
    const int k0 = kt * BK;
    if (q0 + wrow >= Sq || (causal && k0 > qw0 + 15) ||
        (window > 0 && k0 + BK - 1 <= qw0 - window))
      continue;  // this warp's rows keep no key of the tile
    const bf16* cK = sK + st * BK * D;
    const bf16* cV = sV + st * BK * D;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows, fp32
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], b[4];
      load_a<CH>(a, sQ, wrow, kk, lane);
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        load_b<CH>(b, cK, j * 8, kk, lane);
        mma16816(s[j], a, b[0], b[1]);
        mma16816(s[j + 1], a, b[2], b[3]);
      }
      load_a<CH>(a, sDO, wrow, kk, lane);
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        load_b<CH>(b, cV, j * 8, kk, lane);
        mma16816(dp[j], a, b[0], b[1]);
        mma16816(dp[j + 1], a, b[2], b[3]);
      }
    }

    // dS = p (dP - delta) scale, into s
    const bool edge = rows_past || k0 + BK > Sk || (causal && k0 + BK - 1 > qw0) ||
                      (window > 0 && qw0 + 15 - k0 >= window);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = __expf(s[j][e] * scale - lse_r[r]);
        if (edge && !keep_pair(q0 + wrow + g + 8 * r, qw0 + g + 8 * r,
                               k0 + j * 8 + 2 * t + (e & 1), Sq, Sk, causal, window))
          p = 0.f;
        s[j][e] = p * (dp[j][e] - delta_r[r]) * scale;
      }
    uint32_t dsf[BK / 16][4];  // dS in q's dtype: the A operand of dS K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) pack_a(dsf[kk], s[2 * kk], s[2 * kk + 1]);

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t b[4];
        load_b_trans<CH>(b, cK, kk * 16, j, lane);
        mma16816(acc[j], dsf[kk], b[0], b[1]);
        mma16816(acc[j + 1], dsf[kk], b[2], b[3]);
      }
    }
  }

  cp_async_wait<0>();  // the Q copy is done even when no tile ran
  const float one[2] = {1.f, 1.f};
  store_acc_rows<D>(dq + bh * Sq * D, sQ, acc, wrow, q0 + wrow, Sq, one, lane);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V, then 2 stages of Q, of dO, of lse and of delta
  return sizeof(bf16) * (2 * BK * D + 4 * BQ * D) + sizeof(float) * 4 * BQ;
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk,
                          int causal, int window, float scale) {
  constexpr int CH = D / 8;
  // query columns of S^T and dP^T a pass: half a tile at D 128, so that dK,
  // dV, S^T and dP^T fit in registers together
  constexpr int QC = D >= 128 ? BQ / 2 : BQ;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BK * D;
  bf16* sQ = sV + BK * D;       // stage s at sQ + s * BQ * D
  bf16* sDO = sQ + 2 * BQ * D;  // stage s at sDO + s * BQ * D
  float* sLse = reinterpret_cast<float*>(sDO + 2 * BQ * D);  // stage s at sLse + s * BQ
  float* sDelta = sLse + 2 * BQ;

  const int k0 = blockIdx.y * BK;  // the first key tiles are the heaviest under causal
  const size_t bh = blockIdx.x;
  const bf16* qg = q + bh * Sq * D;
  const bf16* dog = dout + bh * Sq * D;
  const float* lse_g = lse + bh * Sq;
  const float* delta_g = delta + bh * Sq;
  const int q_shift = Sk - Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = warp * 16;
  const int kw0 = k0 + wrow;  // this warp's first key

  // query tiles that keep some pair with this key tile
  const int n_qt = (Sq + BQ - 1) / BQ;
  int qt_begin = 0, qt_end = n_qt;
  if (causal) {
    const int first = k0 - q_shift;  // first query row at or past key k0
    qt_begin = first > 0 ? first / BQ : 0;
  }
  if (window > 0) {
    const int last = k0 + BK - 1 + window - 1 - q_shift;  // last row within the window
    qt_end = last < 0 ? 0 : min(n_qt, last / BQ + 1);
  }

  auto load_q_tile = [&](int stage, int qt) {
    cp_tile<BQ, D, NT>(sQ + stage * BQ * D, qg, qt * BQ, Sq);
    cp_tile<BQ, D, NT>(sDO + stage * BQ * D, dog, qt * BQ, Sq);
    cp_rows<BQ, NT>(sLse + stage * BQ, lse_g, qt * BQ, Sq);
    cp_rows<BQ, NT>(sDelta + stage * BQ, delta_g, qt * BQ, Sq);
  };
  cp_tile<BK, D, NT>(sK, k + bh * Sk * D, k0, Sk);
  cp_tile<BK, D, NT>(sV, v + bh * Sk * D, k0, Sk);
  if (qt_begin < qt_end) load_q_tile(0, qt_begin);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int st = (qt - qt_begin) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile qt has landed; every warp is done with tile qt - 1
    if (qt + 1 < qt_end) load_q_tile(st ^ 1, qt + 1);
    cp_async_commit();
    const int q0 = qt * BQ;
    const bf16* cQ = sQ + st * BQ * D;
    const bf16* cDO = sDO + st * BQ * D;
    const float* cLse = sLse + st * BQ;
    const float* cDelta = sDelta + st * BQ;

#pragma unroll
    for (int h = 0; h < BQ / QC; ++h) {
      const int c0 = q0 + h * QC;   // first query row of this pass
      const int cp0 = c0 + q_shift;  // and its position
      if (c0 >= Sq || kw0 >= Sk || (causal && kw0 > cp0 + QC - 1) ||
          (window > 0 && cp0 - (kw0 + 15) >= window))
        continue;  // this warp's keys keep no pair with these queries

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x QC queries
      float s[QC / 8][4], dp[QC / 8][4];
#pragma unroll
      for (int j = 0; j < QC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], b[4];
        load_a<CH>(a, sK, wrow, kk, lane);
#pragma unroll
        for (int j = 0; j < QC / 8; j += 2) {
          load_b<CH>(b, cQ, h * QC + j * 8, kk, lane);
          mma16816(s[j], a, b[0], b[1]);
          mma16816(s[j + 1], a, b[2], b[3]);
        }
        load_a<CH>(a, sV, wrow, kk, lane);
#pragma unroll
        for (int j = 0; j < QC / 8; j += 2) {
          load_b<CH>(b, cDO, h * QC + j * 8, kk, lane);
          mma16816(dp[j], a, b[0], b[1]);
          mma16816(dp[j + 1], a, b[2], b[3]);
        }
      }

      // P^T into s, dS^T = P^T (dP^T - delta) scale into dp
      const bool edge = c0 + QC > Sq || kw0 + 16 > Sk || (causal && kw0 + 15 > cp0) ||
                        (window > 0 && cp0 + QC - 1 - kw0 >= window);
#pragma unroll
      for (int j = 0; j < QC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = h * QC + j * 8 + 2 * t + (e & 1);  // query row in the tile
          float p = __expf(s[j][e] * scale - cLse[col]);
          if (edge && !keep_pair(q0 + col, q0 + col + q_shift, kw0 + g + 8 * (e >> 1), Sq,
                                 Sk, causal, window))
            p = 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - cDelta[col]) * scale;
        }
      uint32_t pf[QC / 16][4], dsf[QC / 16][4];  // P^T in dO's dtype, dS^T in q's
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {
        pack_a(pf[kk], s[2 * kk], s[2 * kk + 1]);
        pack_a(dsf[kk], dp[2 * kk], dp[2 * kk + 1]);
      }

      // dV += P^T dO, dK += dS^T Q over this pass's queries
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < D / 8; j += 2) {
          uint32_t b[4];
          load_b_trans<CH>(b, cDO, h * QC + kk * 16, j, lane);
          mma16816(dv_acc[j], pf[kk], b[0], b[1]);
          mma16816(dv_acc[j + 1], pf[kk], b[2], b[3]);
          load_b_trans<CH>(b, cQ, h * QC + kk * 16, j, lane);
          mma16816(dk_acc[j], dsf[kk], b[0], b[1]);
          mma16816(dk_acc[j + 1], dsf[kk], b[2], b[3]);
        }
      }
    }
  }

  cp_async_wait<0>();  // the K/V copy is done even when no query tile ran
  const float one[2] = {1.f, 1.f};
  store_acc_rows<D>(dk + bh * Sk * D, sK, dk_acc, wrow, kw0, Sk, one, lane);
  store_acc_rows<D>(dv + bh * Sk * D, sV, dv_acc, wrow, kw0, Sk, one, lane);
}

// -- fp32: the first version ---------------------------------------------------

constexpr int BT = TILE;  // rows per tile, queries and keys alike
constexpr int NT32 = TILE_THREADS;  // four warps, each owning 16 rows

// Shared-memory plan of both fp32 kernels.  Row strides in elements; tiles
// are not padded, so the dkv kernel at D 128 fits in 227 KB.
template <int D>
struct Plan {
  static constexpr int LD = D;         // Q, K, V, dO tiles
  static constexpr int LDP = BT + 4;   // P, dS
  static constexpr int LDO = D;        // accumulators
  static constexpr size_t TILE_BYTES = align128(sizeof(float) * BT * LD);
  static constexpr size_t PT = align128(sizeof(float) * BT * LDP);
  static constexpr size_t ACC = align128(sizeof(float) * BT * LDO);
  static constexpr size_t ROW = align128(sizeof(float) * BT);
};

// lse and delta of rows [row0, row0 + 64); rows past the end read 0
__device__ __forceinline__ void load_rows(float* s_lse, float* s_delta,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta, int row0,
                                          int rows_total) {
  for (int i = threadIdx.x; i < BT; i += NT32) {
    const int gr = row0 + i;
    s_lse[i] = gr < rows_total ? lse[gr] : 0.f;
    s_delta[i] = gr < rows_total ? delta[gr] : 0.f;
  }
}

// p and dS of this warp's 16 query rows against one 64-key tile, written
// to sP (when given) and sDS, S and dP computed here by FMA.  Lane l takes
// keys l and l + 32.
template <int D>
__device__ __forceinline__ void grad_tile(float* sP, float* sDS, const float* sQ,
                                          const float* sK, const float* sDO, const float* sV,
                                          const float* s_lse, const float* s_delta, int wrow,
                                          int lane, int q0, int q_shift, int k0, int Sq,
                                          int Sk, int causal, int window, float scale) {
  using P = Plan<D>;
  for (int rr = 0; rr < 16; ++rr) {
    const int r = wrow + rr;
    const int qrow = q0 + r;
    const int qpos = qrow + q_shift;
    const float lse_r = s_lse[r];
    const float delta_r = s_delta[r];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = lane + 32 * u;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        s += sQ[r * P::LD + d] * sK[c * P::LD + d];
        dp += sDO[r * P::LD + d] * sV[c * P::LD + d];
      }
      float p = 0.f, ds = 0.f;
      if (keep_pair(qrow, qpos, k0 + c, Sq, Sk, causal, window)) {
        p = expf(s * scale - lse_r);
        ds = p * (dp - delta_r) * scale;
      }
      if (sP != nullptr) sP[r * P::LDP + c] = p;
      sDS[r * P::LDP + c] = ds;
    }
  }
}

// acc (16 rows of this warp, D cols, in shared memory) += A B, A the
// warp's 16 x 64 rows of `a` (or the transpose of a 64 x 16 column block
// when kTransA), B a 64 x D tile
template <int D, bool kTransA>
__device__ __forceinline__ void accumulate(float* acc, const float* a, const float* b, int wrow,
                                           int lane) {
  using P = Plan<D>;
  for (int rr = 0; rr < 16; ++rr) {
    const int r = wrow + rr;
    for (int c = lane; c < D; c += 32) {
      float s = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < BT; ++kk) {
        const float av = kTransA ? a[kk * P::LDP + r] : a[r * P::LDP + kk];
        s += av * b[kk * P::LD + c];
      }
      acc[r * P::LDO + c] += s;
    }
  }
}

// write rows [row0, row0 + 64) of a shared accumulator to global memory
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float* acc, int row0,
                                           int rows_total) {
  using P = Plan<D>;
  for (int i = threadIdx.x; i < BT * D; i += NT32) {
    const int r = i / D, c = i % D;
    if (row0 + r < rows_total) dst[(size_t)(row0 + r) * D + c] = acc[r * P::LDO + c];
  }
}

template <int D>
struct DqSmem {
  using P = Plan<D>;
  static constexpr size_t Q = 0, DO = Q + P::TILE_BYTES, K = DO + P::TILE_BYTES;
  static constexpr size_t V = K + P::TILE_BYTES, DS = V + P::TILE_BYTES;
  static constexpr size_t ACC = DS + P::PT, LSE = ACC + P::ACC, DELTA = LSE + P::ROW;
  static constexpr size_t BYTES = DELTA + P::ROW;
};

template <int D>
__global__ void __launch_bounds__(NT32)
flash_bwd_dq_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, int H, int Sq, int Sk, int causal, int window,
                         float scale) {
  using M = DqSmem<D>;
  using P = Plan<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + M::Q);
  float* sDO = reinterpret_cast<float*>(smem + M::DO);
  float* sK = reinterpret_cast<float*>(smem + M::K);
  float* sV = reinterpret_cast<float*>(smem + M::V);
  float* sDS = reinterpret_cast<float*>(smem + M::DS);
  float* sAcc = reinterpret_cast<float*>(smem + M::ACC);
  float* sLse = reinterpret_cast<float*>(smem + M::LSE);
  float* sDelta = reinterpret_cast<float*>(smem + M::DELTA);

  const int q0 = blockIdx.x * BT;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const int q_shift = Sk - Sq;
  const int qpos0 = q0 + q_shift;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wrow = warp * 16;

  load_tile<float, D>(sQ, q + bh * Sq * D, q0, Sq, P::LD);
  load_tile<float, D>(sDO, dout + bh * Sq * D, q0, Sq, P::LD);
  load_rows(sLse, sDelta, lse + bh * Sq, delta + bh * Sq, q0, Sq);
  for (int i = tid; i < BT * P::LDO; i += NT32) sAcc[i] = 0.f;

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
    load_tile<float, D>(sK, k + bh * Sk * D, k0, Sk, P::LD);
    load_tile<float, D>(sV, v + bh * Sk * D, k0, Sk, P::LD);
    __syncthreads();
    grad_tile<D>(nullptr, sDS, sQ, sK, sDO, sV, sLse, sDelta, wrow, lane, q0, q_shift, k0, Sq,
                 Sk, causal, window, scale);
    __syncwarp();
    accumulate<D, false>(sAcc, sDS, sK, wrow, lane);  // dQ += dS K
    __syncwarp();
  }
  __syncthreads();  // the zeroed accumulator is visible even with no tile
  store_rows<D>(dq + bh * Sq * D, sAcc, q0, Sq);
}

template <int D>
struct DkvSmem {
  using P = Plan<D>;
  static constexpr size_t K = 0, V = K + P::TILE_BYTES, Q = V + P::TILE_BYTES;
  static constexpr size_t DO = Q + P::TILE_BYTES, PP = DO + P::TILE_BYTES;
  static constexpr size_t DS = PP + P::PT, DK = DS + P::PT, DV = DK + P::ACC;
  static constexpr size_t LSE = DV + P::ACC, DELTA = LSE + P::ROW;
  static constexpr size_t BYTES = DELTA + P::ROW;
};

template <int D>
__global__ void __launch_bounds__(NT32)
flash_bwd_dkv_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int H, int Sq, int Sk,
                          int causal, int window, float scale) {
  using M = DkvSmem<D>;
  using P = Plan<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem + M::K);
  float* sV = reinterpret_cast<float*>(smem + M::V);
  float* sQ = reinterpret_cast<float*>(smem + M::Q);
  float* sDO = reinterpret_cast<float*>(smem + M::DO);
  float* sP = reinterpret_cast<float*>(smem + M::PP);
  float* sDS = reinterpret_cast<float*>(smem + M::DS);
  float* sDK = reinterpret_cast<float*>(smem + M::DK);
  float* sDV = reinterpret_cast<float*>(smem + M::DV);
  float* sLse = reinterpret_cast<float*>(smem + M::LSE);
  float* sDelta = reinterpret_cast<float*>(smem + M::DELTA);

  const int k0 = blockIdx.x * BT;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const int q_shift = Sk - Sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wrow = warp * 16;

  load_tile<float, D>(sK, k + bh * Sk * D, k0, Sk, P::LD);
  load_tile<float, D>(sV, v + bh * Sk * D, k0, Sk, P::LD);
  for (int i = tid; i < BT * P::LDO; i += NT32) {
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
    load_tile<float, D>(sQ, q + bh * Sq * D, q0, Sq, P::LD);
    load_tile<float, D>(sDO, dout + bh * Sq * D, q0, Sq, P::LD);
    load_rows(sLse, sDelta, lse + bh * Sq, delta + bh * Sq, q0, Sq);
    __syncthreads();
    grad_tile<D>(sP, sDS, sQ, sK, sDO, sV, sLse, sDelta, wrow, lane, q0, q_shift, k0, Sq, Sk,
                 causal, window, scale);
    __syncthreads();  // every warp's P/dS rows are in place
    accumulate<D, true>(sDV, sP, sDO, wrow, lane);  // dV += P^T dO
    accumulate<D, true>(sDK, sDS, sQ, wrow, lane);  // dK += dS^T Q
  }
  __syncthreads();
  store_rows<D>(dk + bh * Sk * D, sDK, k0, Sk);
  store_rows<D>(dv + bh * Sk * D, sDV, k0, Sk);
}

// -- launch ----------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int B, H, Sq, Sk, causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename Kern>
int prepare(Kern kern, size_t smem) {
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <int D>
int launch_dq(const Args& a, int dtype) {
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  if (dtype == 1) {
    constexpr size_t smem = dq_smem_bytes<D>();
    auto kern = flash_bwd_dq_bf16_kernel<D>;
    if (int err = prepare(kern, smem)) return err;
    dim3 grid(a.B * a.H, (a.Sq + BQ - 1) / BQ);
    kern<<<grid, NT, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), lse, delta,
        static_cast<bf16*>(a.dq), a.Sq, a.Sk, a.causal, a.window, a.scale);
  } else {
    constexpr size_t smem = DqSmem<D>::BYTES;
    auto kern = flash_bwd_dq_fp32_kernel<D>;
    if (int err = prepare(kern, smem)) return err;
    dim3 grid((a.Sq + BT - 1) / BT, a.H, a.B);
    kern<<<grid, NT32, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), lse, delta,
        static_cast<float*>(a.dq), a.H, a.Sq, a.Sk, a.causal, a.window, a.scale);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const Args& a, int dtype) {
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  if (dtype == 1) {
    constexpr size_t smem = dkv_smem_bytes<D>();
    auto kern = flash_bwd_dkv_bf16_kernel<D>;
    if (int err = prepare(kern, smem)) return err;
    dim3 grid(a.B * a.H, (a.Sk + BK - 1) / BK);
    kern<<<grid, NT, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), lse, delta,
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.Sq, a.Sk, a.causal, a.window,
        a.scale);
  } else {
    constexpr size_t smem = DkvSmem<D>::BYTES;
    static_assert(smem <= 232448, "dkv tile plan exceeds 227 KB of shared memory");
    auto kern = flash_bwd_dkv_fp32_kernel<D>;
    if (int err = prepare(kern, smem)) return err;
    dim3 grid((a.Sk + BT - 1) / BT, a.H, a.B);
    kern<<<grid, NT32, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), lse, delta,
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.H, a.Sq, a.Sk, a.causal,
        a.window, a.scale);
  }
  return (int)cudaGetLastError();
}

template <bool kDq>
int dispatch(int D, int dtype, const Args& a) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return kDq ? launch_dq<32>(a, dtype) : launch_dkv<32>(a, dtype);
    case 64: return kDq ? launch_dq<64>(a, dtype) : launch_dkv<64>(a, dtype);
    case 128: return kDq ? launch_dq<128>(a, dtype) : launch_dkv<128>(a, dtype);
    default: return (int)cudaErrorInvalidValue;
  }
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
