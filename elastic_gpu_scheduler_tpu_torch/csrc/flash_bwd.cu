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
// float32 (every ring-attention hop's backward, whatever the model's
// dtype, and float32 training, which carries the card-vs-CPU identity)
// replaces the same TPU kernels at their float32 precision: full float32
// FMAs (the TPU kernel's fp32 path is the "highest"-precision MXU product,
// and TF32 would not be).  What bounds it on this card: operations, on the
// CUDA cores.  At the ring hop (B 8, 16 heads, 512 queries against a 512-key
// shard, Dh 128) the five products take 10 Dh FLOPs a kept pair against
// 67 TFLOP/s, and the two-kernel design does seven, so its ceiling is 5/7 of
// the bound.  The first version read both operands of every FMA from
// unpadded shared tiles (32-way bank conflicts), kept the accumulators in
// shared memory, copied each tile synchronously and ran four warps an SM:
// 43x its bound.  The float32 kernels now (fp32_tile.cuh):
//   - the same two kernels and the same tile skipping, eight warps a block:
//     the dq kernel owns a 64-row query tile (the last ones first under
//     causal) and streams 64-key K/V tiles, the dkv kernel owns a 64-key
//     tile and streams 64-row Q/dO tiles with their lse and delta rows, each
//     through a 2-stage ring of 16-byte cp.async copies;
//   - every product as register micro-tiles in outer-product form: a
//     thread owns 4 rows x 4 columns of S and dP (S^T and dP^T in dkv) and 4
//     rows x Dh / 16 columns of dQ (of dK and of dV), reading 16-byte
//     vectors of padded, conflict-free tiles; the accumulators stay in
//     registers;
//   - dS (dq), P^T then dS^T (dkv) go to shared memory once a tile, for the
//     row group's own product with K, dO or Q; no atomics, every sum in a
//     fixed order: bitwise repeatable.

#include <math.h>

#include "attn_common.cuh"
#include "fp32_tile.cuh"
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

// -- fp32: register micro-tiles, cp.async, eight warps -----------------------

// dq: Q, dO, 2 stages of K and of V, dS
template <int D>
constexpr size_t dq_fp32_smem_bytes() {
  return f32::smem_bytes<D>(2 + 4, 1, 0);
}

template <int D>
__global__ void __launch_bounds__(f32::NT, 1)
flash_bwd_dq_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, int Sq, int Sk, int causal, int window,
                         float scale) {
  using namespace f32;
  constexpr int LD = ld<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sDO = sQ + BR * LD;
  float* sK = sDO + BR * LD;     // stage s at sK + s * BC * LD
  float* sV = sK + 2 * BC * LD;  // stage s at sV + s * BC * LD
  float* sDS = sV + 2 * BC * LD;

  const int n_qt = (Sq + BR - 1) / BR;
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y) * BR;
  const size_t bh = blockIdx.x;
  const float* kg = k + bh * Sk * D;
  const float* vg = v + bh * Sk * D;
  const int q_shift = Sk - Sq;
  const int qpos0 = q0 + q_shift;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;

  const int n_kt = (Sk + BC - 1) / BC;
  int kt_end = n_kt;
  if (causal) kt_end = min(n_kt, (qpos0 + BR - 1) / BC + 1);  // above-diagonal tiles
  int kt_begin = 0;
  if (window > 0) {
    const int lo = qpos0 - window + 1;  // earliest key any row of the tile keeps
    kt_begin = lo > 0 ? lo / BC : 0;
  }

  cp_tile<BR, D>(sQ, q + bh * Sq * D, q0, Sq, D);
  cp_tile<BR, D>(sDO, dout + bh * Sq * D, q0, Sq, D);
  if (kt_begin < kt_end) {
    cp_tile<BC, D>(sK, kg, kt_begin * BC, Sk, D);
    cp_tile<BC, D>(sV, vg, kt_begin * BC, Sk, D);
  }
  cp_async_commit();

  float lse_r[TR], delta_r[TR], acc[TR][D / 16];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = q0 + 4 * rg + i;
    lse_r[i] = row < Sq ? lse[bh * Sq + row] : 0.f;
    delta_r[i] = row < Sq ? delta[bh * Sq + row] : 0.f;
#pragma unroll
    for (int n = 0; n < D / 16; ++n) acc[i][n] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stg = (kt - kt_begin) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
    if (kt + 1 < kt_end) {
      cp_tile<BC, D>(sK + (stg ^ 1) * BC * LD, kg, (kt + 1) * BC, Sk, D);
      cp_tile<BC, D>(sV + (stg ^ 1) * BC * LD, vg, (kt + 1) * BC, Sk, D);
    }
    cp_async_commit();
    const float* cK = sK + stg * BC * LD;

    // S = Q K^T and dP = dO V^T for the thread's 4 rows x 4 keys
    float s[TR][TC], dp[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = dp[i][j] = 0.f;
    scores<D>(s, sQ, cK, rg, cg);
    scores<D>(dp, sDO, sV + stg * BC * LD, rg, cg);

    // dS = p (dP - delta) scale, p = 0 outside the mask
    const int k0 = kt * BC;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qrow = q0 + 4 * rg + i;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        float ds = 0.f;
        if (keep_pair(qrow, qrow + q_shift, k0 + cg + 16 * j, Sq, Sk, causal, window))
          ds = expf(s[i][j] * scale - lse_r[i]) * (dp[i][j] - delta_r[i]) * scale;
        sDS[(4 * rg + i) * LDP + cg + 16 * j] = ds;
      }
    }
    __syncwarp();  // the row group's dS rows are in place

    // dQ += dS K
    accumulate<D>(acc, sDS, cK, rg, cg);
  }

  cp_async_wait<0>();  // no copy outlives the block
  store_rows<D>(dq + bh * Sq * D, acc, q0, Sq, rg, cg);
}

// dkv: K, V, 2 stages of Q and of dO, P^T (then dS^T), 2 stages of the lse
// and delta rows
template <int D>
constexpr size_t dkv_fp32_smem_bytes() {
  return f32::smem_bytes<D>(2 + 4, 1, 4 * f32::BC);
}

template <int D>
__global__ void __launch_bounds__(f32::NT, 1)
flash_bwd_dkv_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk,
                          int causal, int window, float scale) {
  using namespace f32;
  constexpr int LD = ld<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + BR * LD;
  float* sQ = sV + BR * LD;       // stage s at sQ + s * BC * LD
  float* sDO = sQ + 2 * BC * LD;  // stage s at sDO + s * BC * LD
  float* sP = sDO + 2 * BC * LD;
  float* sLse = sP + BR * LDP;    // stage s at sLse + s * BC
  float* sDelta = sLse + 2 * BC;  // stage s at sDelta + s * BC

  const int k0 = blockIdx.y * BR;  // the first key tiles are the heaviest under causal
  const size_t bh = blockIdx.x;
  const float* qg = q + bh * Sq * D;
  const float* dog = dout + bh * Sq * D;
  const float* lse_g = lse + bh * Sq;
  const float* delta_g = delta + bh * Sq;
  const int q_shift = Sk - Sq;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;

  // query tiles that keep some pair with this key tile
  const int n_qt = (Sq + BC - 1) / BC;
  int qt_begin = 0, qt_end = n_qt;
  if (causal) {
    const int first = k0 - q_shift;  // first query row at or past key k0
    qt_begin = first > 0 ? first / BC : 0;
  }
  if (window > 0) {
    const int last = k0 + BR - 1 + window - 1 - q_shift;  // last row within the window
    qt_end = last < 0 ? 0 : min(n_qt, last / BC + 1);
  }

  auto load_q_tile = [&](int stage, int qt) {
    cp_tile<BC, D>(sQ + stage * BC * LD, qg, qt * BC, Sq, D);
    cp_tile<BC, D>(sDO + stage * BC * LD, dog, qt * BC, Sq, D);
    cp_rows<BC, f32::NT>(sLse + stage * BC, lse_g, qt * BC, Sq);
    cp_rows<BC, f32::NT>(sDelta + stage * BC, delta_g, qt * BC, Sq);
  };
  cp_tile<BR, D>(sK, k + bh * Sk * D, k0, Sk, D);
  cp_tile<BR, D>(sV, v + bh * Sk * D, k0, Sk, D);
  if (qt_begin < qt_end) load_q_tile(0, qt_begin);
  cp_async_commit();

  float dk_acc[TR][D / 16], dv_acc[TR][D / 16];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) dk_acc[i][n] = dv_acc[i][n] = 0.f;

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int stg = (qt - qt_begin) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile qt has landed; every warp is done with tile qt - 1
    if (qt + 1 < qt_end) load_q_tile(stg ^ 1, qt + 1);
    cp_async_commit();
    const int q0 = qt * BC;
    const float* cQ = sQ + stg * BC * LD;
    const float* cDO = sDO + stg * BC * LD;
    const float* cLse = sLse + stg * BC;
    const float* cDelta = sDelta + stg * BC;

    // S^T = K Q^T and dP^T = V dO^T for the thread's 4 keys x 4 queries
    float s[TR][TC], dp[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = dp[i][j] = 0.f;
    scores<D>(s, sK, cQ, rg, cg);
    scores<D>(dp, sV, cDO, rg, cg);

    // P^T into s, dS^T = P^T (dP^T - delta) scale into dp; 0 outside the mask
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int col = cg + 16 * j;  // query row in the tile
      const float lse_c = cLse[col], delta_c = cDelta[col];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        float p = 0.f;
        if (keep_pair(q0 + col, q0 + col + q_shift, k0 + 4 * rg + i, Sq, Sk, causal, window))
          p = expf(s[i][j] * scale - lse_c);
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - delta_c) * scale;
        sP[(4 * rg + i) * LDP + col] = p;
      }
    }
    __syncwarp();  // the row group's P^T rows are in place
    accumulate<D>(dv_acc, sP, cDO, rg, cg);  // dV += P^T dO
    __syncwarp();  // the row group has read its P^T rows
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) sP[(4 * rg + i) * LDP + cg + 16 * j] = dp[i][j];
    __syncwarp();
    accumulate<D>(dk_acc, sP, cQ, rg, cg);  // dK += dS^T Q
  }

  cp_async_wait<0>();  // no copy outlives the block
  store_rows<D>(dk + bh * Sk * D, dk_acc, k0, Sk, rg, cg);
  store_rows<D>(dv + bh * Sk * D, dv_acc, k0, Sk, rg, cg);
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
    constexpr size_t smem = dq_fp32_smem_bytes<D>();
    static_assert(smem <= 232448, "dq's float32 tiles exceed a block's shared memory");
    auto kern = flash_bwd_dq_fp32_kernel<D>;
    if (int err = prepare(kern, smem)) return err;
    dim3 grid(a.B * a.H, (a.Sq + f32::BR - 1) / f32::BR);
    kern<<<grid, f32::NT, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), lse, delta,
        static_cast<float*>(a.dq), a.Sq, a.Sk, a.causal, a.window, a.scale);
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
    constexpr size_t smem = dkv_fp32_smem_bytes<D>();
    static_assert(smem <= 232448, "dk/dv's float32 tiles exceed a block's shared memory");
    auto kern = flash_bwd_dkv_fp32_kernel<D>;
    if (int err = prepare(kern, smem)) return err;
    dim3 grid(a.B * a.H, (a.Sk + f32::BR - 1) / f32::BR);
    kern<<<grid, f32::NT, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), lse, delta,
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Sq, a.Sk, a.causal, a.window,
        a.scale);
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
