// Flash-attention forward (kernel K1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels `_flash_kernel_resident` and
// `_flash_kernel` of elastic_gpu_scheduler_tpu/ops/attention.py (launched by
// `_flash_forward_pallas`): out = softmax(Q K^T * scale + causal/window
// mask) V per (batch, head), plus the per-row logsumexp.
//
// What bounds it on this card.  At the training shape (B 8, H 16, S 1024,
// D 128, bf16, causal) a call moves 134 MB of q/k/v/o (plus 0.5 MB of
// lse) and does 34.4 GFLOP, ~256 FLOPs a byte, just under the H100's ridge
// of ~295: the bytes bound it (0.040 ms), the products close behind
// (0.035 ms).  At the serving prefill shapes (one sequence, 16 heads, Tpad
// 8-512) the grid is small (16-128 blocks of 64 rows on 132 SMs), so the
// limit there is how fast one block's loop runs.  The first version kept
// S, P and the output accumulator in shared memory, walked the softmax one
// row at a time, copied K/V synchronously and ran WMMA at 2 blocks an SM:
// 22x its bound.  The bf16 path is now register-resident:
//   - one block per (64-row query tile, batch * head), 4 warps, each
//     owning 16 query rows.  Under causal the grid starts with the
//     heaviest (last) query tiles;
//   - 64-key K/V tiles stream through a 2-stage ring of XOR-swizzled
//     shared memory by 16-byte cp.async: the next tile's copy is in flight
//     while the current one is multiplied; one __syncthreads a tile;
//   - Q's fragments are loaded into registers once (ldmatrix); Q K^T and
//     P V run on mma.sync.m16n8k16 (bf16 in, fp32 accumulate), K's
//     fragments by ldmatrix and V's by ldmatrix.trans, conflict-free
//     through the swizzle;
//   - S, the running max and sum and the output accumulator stay in
//     registers: a row's max and sum reduce over the 4 lanes of a quad,
//     and P, rounded to bf16 at the running max, is packed in registers
//     as the A operand of P V.  No fp32 tile goes to shared memory;
//   - only tiles on the diagonal, the window's edge or the ragged end are
//     masked element by element; a warp skips a tile its rows keep no key
//     of;
//   - the epilogue divides by l in registers and writes 16-byte rows
//     through the warp's own rows of the Q tile.
// At D 128, when 128-row tiles still give >= 2 blocks an SM (the training
// shape), the products go to wgmma instead (flash_fwd_wgmma_kernel,
// helpers in warpgroup.cuh): one block per 128-row query tile, a producer
// warp feeds Q and a 2-stage K/V ring by TMA into 128-byte swizzled
// shared memory, signalling mbarriers; two consumer warpgroups of 64
// query rows each run S = Q K^T as wgmma m64n64k16 with both operands in
// shared memory and O += P V as wgmma m64n128k16 with P from registers
// (the wgmma A-register layout is the mma.sync one, so the softmax code
// is the same) and V from shared memory, transposed by the descriptor.
// It measured faster than the mma.sync kernel at that shape on the card.
// Inside a tile a masked score is -inf and the running max starts at the
// reference's finite NEG_INF (-1e30), so a masked p is exactly 0 and the
// results equal those of masking with NEG_INF.
//
// float32 keeps the first version (it carries the float32 card-vs-CPU
// identities): one block per 64-row query tile, four warps, K/V through
// shared memory, plain FMA (the TPU kernel's fp32 path is the
// "highest"-precision MXU product, and TF32 would not be), the softmax
// statistics and the accumulator in shared memory.
// All paths: tiles wholly above the diagonal or below the window are
// skipped; a key past Sk is not a key; queries sit at the last Sq key
// positions (q_shift = Sk - Sq); rows with l == 0 write 0; lse = m +
// log(l).

#include <cudaTypedefs.h>
#include <math.h>

#include "attn_common.cuh"
#include "warp_mma.cuh"
#include "warpgroup.cuh"

namespace {

using namespace egs;

// -- bf16: registers, cp.async, mma.sync -------------------------------------

constexpr int BQ = 64;   // query rows a block
constexpr int BK = 64;   // keys a streamed tile
constexpr int NT = 128;  // four warps, each owning 16 query rows

template <int D>
constexpr size_t bf16_smem_bytes() {
  return sizeof(bf16) * (BQ * D + 4 * BK * D);  // Q, then 2 stages of K and of V
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                      int Sq, int Sk, int causal, int window, float scale) {
  constexpr int CH = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * D;      // stage s at sK + s * BK * D
  bf16* sV = sK + 2 * BK * D;  // stage s at sV + s * BK * D

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y) * BQ;
  const size_t bh = blockIdx.x;
  const bf16* kg = k + bh * Sk * D;
  const bf16* vg = v + bh * Sk * D;
  const int qpos0 = q0 + (Sk - Sq);  // absolute position of query row q0
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = warp * 16;      // this warp's first row in the tile
  const int qw0 = qpos0 + wrow;    // and its position

  const int n_kt = (Sk + BK - 1) / BK;
  int kt_end = n_kt;
  if (causal) kt_end = min(n_kt, (qpos0 + BQ - 1) / BK + 1);  // above-diagonal tiles
  int kt_begin = 0;
  if (window > 0) {
    const int lo = qpos0 - window + 1;  // earliest key any row of the tile keeps
    kt_begin = lo > 0 ? lo / BK : 0;
  }

  cp_tile<BQ, D, NT>(sQ, q + bh * Sq * D, q0, Sq);
  if (kt_begin < kt_end) {
    cp_tile<BK, D, NT>(sK, kg, kt_begin * BK, Sk);
    cp_tile<BK, D, NT>(sV, vg, kt_begin * BK, Sk);
  }
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};          // this lane's share of their running sums

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
    if (kt + 1 < kt_end) {
      cp_tile<BK, D, NT>(sK + (st ^ 1) * BK * D, kg, (kt + 1) * BK, Sk);
      cp_tile<BK, D, NT>(sV + (st ^ 1) * BK * D, vg, (kt + 1) * BK, Sk);
    }
    cp_async_commit();
    if (kt == kt_begin) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) load_a<CH>(qf[kk], sQ, wrow, kk, lane);
    }
    const int k0 = kt * BK;
    if (q0 + wrow >= Sq || (causal && k0 > qw0 + 15) ||
        (window > 0 && k0 + BK - 1 <= qw0 - window))
      continue;  // this warp's rows keep no key of the tile
    const bf16* cK = sK + st * BK * D;
    const bf16* cV = sV + st * BK * D;

    // S = Q K^T for this warp's 16 rows, fp32
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        uint32_t b[4];
        load_b<CH>(b, cK, j * 8, kk, lane);
        mma16816(s[j], qf[kk], b[0], b[1]);
        mma16816(s[j + 1], qf[kk], b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale;
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > qw0) ||
                      (window > 0 && qw0 + 15 - k0 >= window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!keeps(qw0 + g + (e >> 1) * 8, k0 + j * 8 + 2 * t + (e & 1), Sk, causal, window))
            s[j][e] = -INFINITY;
    }

    // online softmax of rows g and g + 8, in registers
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = __expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = __expf(s[j][e] - mx[e >> 1]);
      rs[0] += s[j][0] + s[j][1];
      rs[1] += s[j][2] + s[j][3];
    }
    uint32_t pf[BK / 16][4];  // P in V's dtype: the A operand of P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) pack_a(pf[kk], s[2 * kk], s[2 * kk + 1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t b[4];
        load_b_trans<CH>(b, cV, kk * 16, j, lane);
        mma16816(acc[j], pf[kk], b[0], b[1]);
        mma16816(acc[j + 1], pf[kk], b[2], b[3]);
      }
    }
  }

  // out = O / l (l == 0 -> 0), lse = m + log(l)
  cp_async_wait<0>();  // the Q copy is done even when no tile ran
  float ls[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = quad_sum(l[i]);
    ls[i] = li == 0.f ? 1.f : li;
  }
  store_acc_rows<D>(o + bh * Sq * D, sQ, acc, wrow, q0 + wrow, Sq, ls, lane);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + wrow + g + 8 * i;
      if (row < Sq) lse[bh * Sq + row] = m[i] + logf(ls[i]);
    }
  }
}

// -- bf16, D 128, 128-row tiles: wgmma + TMA -----------------------------------

namespace wgk {
constexpr int BQ = 128;  // two consumer warpgroups of 64 query rows
constexpr int BK = 64;   // keys a tile
constexpr int D = 128;
constexpr int NS = 2;    // stages of the K/V ring
constexpr int NT = 288;  // 8 consumer warps, then 1 producer warp
constexpr uint32_t HALF_Q = BQ * 128;   // bytes of a 64-column half of the Q tile
constexpr uint32_t HALF_KV = BK * 128;  // of a K or V tile
constexpr uint32_t Q_BYTES = 2 * HALF_Q;
constexpr uint32_t KV_BYTES = 2 * HALF_KV;  // one K or one V tile
constexpr size_t SMEM = 1024 + Q_BYTES + 2 * NS * KV_BYTES + 8 * (2 * NS + 1);
}  // namespace wgk

__global__ void __launch_bounds__(wgk::NT, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                       float* __restrict__ lse, int Sq, int Sk, int causal, int window,
                       float scale) {
  constexpr int BQ = wgk::BQ, BK = wgk::BK, D = wgk::D, NS = wgk::NS;
  constexpr uint32_t HALF_Q = wgk::HALF_Q, HALF_KV = wgk::HALF_KV;
  constexpr uint32_t Q_BYTES = wgk::Q_BYTES, KV_BYTES = wgk::KV_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sK = smem + Q_BYTES;      // stage s at sK + s * KV_BYTES
  unsigned char* sV = sK + NS * KV_BYTES;  // stage s at sV + s * KV_BYTES
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + NS * KV_BYTES);  // K and V landed
  uint64_t* empty = full + NS;     // both consumer warpgroups are done with the stage
  uint64_t* qbar = empty + NS;     // the Q tile landed

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y) * BQ;
  const int bh = blockIdx.x;
  const int qpos0 = q0 + (Sk - Sq);
  const int n_kt = (Sk + BK - 1) / BK;
  int kt_end = n_kt;
  if (causal) kt_end = min(n_kt, (qpos0 + BQ - 1) / BK + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int lo = qpos0 - window + 1;
    kt_begin = lo > 0 ? lo / BK : 0;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // the producer: one thread issues every copy
    if (lane == 0) {
      mbar_expect_tx(qbar, Q_BYTES);
      for (int h = 0; h < 2; ++h) tma_load_3d(smem + h * HALF_Q, &tm_q, qbar, h * 64, q0, bh);
      for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
        const int s = i % NS;
        if (i >= NS) mbar_wait(&empty[s], ((i / NS) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * KV_BYTES);
        for (int h = 0; h < 2; ++h) {
          tma_load_3d(sK + s * KV_BYTES + h * HALF_KV, &tm_k, &full[s], h * 64, kt * BK, bh);
          tma_load_3d(sV + s * KV_BYTES + h * HALF_KV, &tm_v, &full[s], h * 64, kt * BK, bh);
        }
      }
    }
    return;
  }

  const int wgi = warp / 4;  // consumer warpgroup: tile rows 64 wgi ..
  const int g = lane / 4, t = lane % 4;
  const int wrow = warp * 16;  // this warp's first row in the tile
  const int qw0 = qpos0 + wrow;
  const int qg0 = qpos0 + 64 * wgi;  // the warpgroup's first query position
  float acc[64];  // O: 16 C tiles of 8 columns
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);
  for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
    const int s = i % NS;
    mbar_wait(&full[s], (i / NS) & 1);
    const int k0 = kt * BK;
    const bool skip = q0 + 64 * wgi >= Sq || (causal && k0 > qg0 + 63) ||
                      (window > 0 && k0 + BK - 1 <= qg0 - window);
    if (!skip) {
      const unsigned char* cK = sK + s * KV_BYTES;
      const unsigned char* cV = sV + s * KV_BYTES;
      float sacc[32];  // S: 8 C tiles of 8 keys
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // byte of the k-step in a 128-byte row
        const uint64_t da = sw128_desc(smem + (kk / 4) * HALF_Q + wgi * 64 * 128 + off, 16, 1024);
        const uint64_t db = sw128_desc(cK + (kk / 4) * HALF_KV + off, 16, 1024);
        wgmma_ss_m64n64k16(sacc, da, db, kk > 0);
      }
      wg_commit();
      wg_wait0();
      fence_regs(sacc);

#pragma unroll
      for (int i2 = 0; i2 < 32; ++i2) sacc[i2] *= scale;
      const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > qw0) ||
                        (window > 0 && qw0 + 15 - k0 >= window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!keeps(qw0 + g + (e >> 1) * 8, k0 + j * 8 + 2 * t + (e & 1), Sk, causal, window))
              sacc[4 * j + e] = -INFINITY;
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        alpha[r] = __expf(m[r] - mx[r]);
        m[r] = mx[r];
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[4 * j + e] = __expf(sacc[4 * j + e] - mx[e >> 1]);
        rs[0] += sacc[4 * j] + sacc[4 * j + 1];
        rs[1] += sacc[4 * j + 2] + sacc[4 * j + 3];
      }
      uint32_t pf[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pf[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
        pf[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pf[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pf[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_m64n128k16(acc, pf[kk], sw128_desc(cV + kk * 16 * 128, HALF_KV, 1024));
      wg_commit();
      wg_wait0();
      fence_regs(acc);
    }
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);  // this warpgroup is done with s
  }

  // out = O / l through the warp's own rows of the Q tile (its warpgroup's
  // products are done, and no other warpgroup reads these rows)
  float ls[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float li = quad_sum(l[r]);
    ls[r] = li == 0.f ? 1.f : li;
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow + g + 8 * r;
      unsigned char* p = smem + (j / 8) * HALF_Q + row * 128 + (((j % 8) ^ (row & 7)) * 16) + 4 * t;
      *reinterpret_cast<uint32_t*>(p) =
          pack_bf16(acc[4 * j + 2 * r] / ls[r], acc[4 * j + 2 * r + 1] / ls[r]);
    }
  }
  __syncwarp();
  for (int i = lane; i < 16 * 16; i += 32) {
    const int row = wrow + i / 16, c = i % 16;
    const int grow = q0 + row;
    if (grow < Sq)
      *reinterpret_cast<uint4*>(o + ((size_t)bh * Sq + grow) * D + c * 8) =
          *reinterpret_cast<const uint4*>(smem + (c / 8) * HALF_Q + row * 128 +
                                          (((c % 8) ^ (row & 7)) * 16));
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wrow + g + 8 * r;
      if (row < Sq) lse[(size_t)bh * Sq + row] = m[r] + logf(ls[r]);
    }
  }
}

// a 3-D tensor map (D 128, rows, batch * heads) of bf16 with boxes of 64
// columns x box_rows rows, 128-byte swizzled; rows past the end read 0
int make_tensor_map(CUtensorMap* map, const void* base, int rows, int bh, int box_rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult res;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &res);
    if (err != cudaSuccess) return (int)err;
    if (res != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  cuuint64_t dims[3] = {128, (cuuint64_t)rows, (cuuint64_t)bh};
  cuuint64_t strides[2] = {128 * sizeof(bf16), (cuuint64_t)rows * 128 * sizeof(bf16)};
  cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int launch_wgmma(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                 int Sq, int Sk, int causal, int window, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_tensor_map(&tq, q, Sq, B * H, wgk::BQ);
  if (!err) err = make_tensor_map(&tk, k, Sk, B * H, wgk::BK);
  if (!err) err = make_tensor_map(&tv, v, Sk, B * H, wgk::BK);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(flash_fwd_wgmma_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wgk::SMEM);
  if (err) return err;
  dim3 grid(B * H, (Sq + wgk::BQ - 1) / wgk::BQ);
  flash_fwd_wgmma_kernel<<<grid, wgk::NT, wgk::SMEM, stream>>>(tq, tk, tv, static_cast<bf16*>(o),
                                                     static_cast<float*>(lse), Sq, Sk, causal,
                                                     window, scale);
  return (int)cudaGetLastError();
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                int Sq, int Sk, int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = bf16_smem_bytes<D>();
  auto kern = flash_fwd_bf16_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), Sq, Sk, causal, window, scale);
  return (int)cudaGetLastError();
}

// bf16 takes the wgmma kernel at D 128 while its 128-row tiles still give
// >= 2 blocks an SM, else the 64-row mma.sync kernel
template <int D>
int dispatch_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                  int H, int Sq, int Sk, int causal, int window, float scale, cudaStream_t s) {
  if constexpr (D == 128) {
    if ((long)B * H * ((Sq + wgk::BQ - 1) / wgk::BQ) >= 2L * sm_count())
      return launch_wgmma(q, k, v, o, lse, B, H, Sq, Sk, causal, window, scale, s);
  }
  return launch_bf16<D>(q, k, v, o, lse, B, H, Sq, Sk, causal, window, scale, s);
}

// -- fp32: the first version ---------------------------------------------------

constexpr int BQ32 = TILE;  // query rows per block
constexpr int NT32 = TILE_THREADS;  // four warps, each owning 16 query rows

template <int D>
__global__ void __launch_bounds__(NT32)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int H, int Sq, int Sk, int causal, int window,
                      float scale) {
  using Lay = FwdLayout<float, D>;
  constexpr int LD = Lay::LD, LDS = Lay::LDS, LDP = Lay::LDP, LDO = Lay::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + Lay::Q_OFF);
  float* sK = reinterpret_cast<float*>(smem + Lay::K_OFF);
  float* sV = reinterpret_cast<float*>(smem + Lay::V_OFF);
  float* sS = reinterpret_cast<float*>(smem + Lay::S_OFF);
  float* sP = reinterpret_cast<float*>(smem + Lay::P_OFF);
  float* sO = reinterpret_cast<float*>(smem + Lay::O_OFF);
  float* sM = reinterpret_cast<float*>(smem + Lay::M_OFF);
  float* sL = reinterpret_cast<float*>(smem + Lay::L_OFF);
  float* sA = reinterpret_cast<float*>(smem + Lay::A_OFF);

  const int q0 = blockIdx.x * BQ32;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const float* qg = q + bh * Sq * D;
  const float* kg = k + bh * Sk * D;
  const float* vg = v + bh * Sk * D;
  const int qpos0 = q0 + (Sk - Sq);  // absolute position of query row q0
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wrow = warp * 16;  // this warp's first row in the tile

  load_tile<float, D>(sQ, qg, q0, Sq, LD);
  for (int i = tid; i < BQ32 * LDO; i += NT32) sO[i] = 0.f;
  if (tid < BQ32) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  const int n_kt = (Sk + TILE - 1) / TILE;
  int kt_end = n_kt;
  if (causal) kt_end = min(n_kt, (qpos0 + BQ32 - 1) / TILE + 1);  // above-diagonal tiles
  int kt_begin = 0;
  if (window > 0) {
    const int lo = qpos0 - window + 1;  // earliest key any row of the tile keeps
    kt_begin = lo > 0 ? lo / TILE : 0;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();  // the previous tile's K/V are no longer read
    load_tile<float, D>(sK, kg, k0, Sk, LD);
    load_tile<float, D>(sV, vg, k0, Sk, LD);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows (raw dot products)
    for (int rr = 0; rr < 16; ++rr) {
      const int r = wrow + rr;
      for (int c = lane; c < TILE; c += 32) {
        float acc = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) acc += sQ[r * LD + d] * sK[c * LD + d];
        sS[r * LDS + c] = acc;
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
      for (int u = 0; u < 2; ++u) sP[r * LDP + lane + 32 * u] = p[u];
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
    for (int rr = 0; rr < 16; ++rr) {
      const int r = wrow + rr;
      const float a = sA[r];
      for (int c = lane; c < D; c += 32) {
        float acc = 0.f;
#pragma unroll 8
        for (int kk = 0; kk < TILE; ++kk) acc += sP[r * LDP + kk] * sV[kk * LD + c];
        sO[r * LDO + c] = sO[r * LDO + c] * a + acc;
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
    float* og = o + (bh * Sq + row) * D;
    for (int c = lane; c < D; c += 32) og[c] = sO[r * LDO + c] / ls;
    if (lane == 0) lse[bh * Sq + row] = sM[r] + logf(ls);
  }
}

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                int Sq, int Sk, int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = FwdLayout<float, D>::BYTES;
  auto kern = flash_fwd_fp32_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ32 - 1) / BQ32, H, B);
  kern<<<grid, NT32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), H, Sq, Sk, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_dtype(int dtype, const void* q, const void* k, const void* v, void* o, void* lse,
                   int B, int H, int Sq, int Sk, int causal, int window, float scale,
                   cudaStream_t s) {
  if (dtype == 1) return dispatch_bf16<D>(q, k, v, o, lse, B, H, Sq, Sk, causal, window, scale, s);
  if (dtype == 0) return launch_fp32<D>(q, k, v, o, lse, B, H, Sq, Sk, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B,H,Sq,D), k/v (B,H,Sk,D) contiguous, Sq <= Sk; o like q; lse (B,H,Sq)
// fp32.  dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int egs_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             int B, int H, int Sq, int Sk, int D, int dtype, int causal,
                             int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return dispatch_dtype<32>(dtype, q, k, v, o, lse, B, H, Sq, Sk, causal, window, scale, s);
    case 64: return dispatch_dtype<64>(dtype, q, k, v, o, lse, B, H, Sq, Sk, causal, window, scale, s);
    case 128: return dispatch_dtype<128>(dtype, q, k, v, o, lse, B, H, Sq, Sk, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* egs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
