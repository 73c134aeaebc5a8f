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
//   - a key past Sk is no key at all;
//   - p is rounded to V's dtype before the P V product, while l sums the
//     unrounded p; products take native-dtype operands, sums are fp32.
//
// What bounds it on this card: bytes, at the engine's shapes (T <= 256
// new queries against a bucketed page span of M <= 1024 keys, Dh 128,
// bf16, 16 query heads on 8 kv-heads): a key's K and V rows (4 Dh bytes)
// serve at most T (H / Hkv) kept pairs of 4 Dh FLOPs, and the fp32 pv
// output adds bytes.  At those shapes one block a (64-row query tile,
// head) gave 16-64 blocks on 132 SMs, each reading its kv-head's K/V once
// a query head, synchronously, with S, P and the output accumulator in
// shared memory: 82x its bound and 3.7x SDPA.  The bf16 path is now
// register-resident, after K1's mma.sync kernel (csrc/flash_fwd.cu):
//   - one K/V read for the whole GQA group: a block's 64 rows are the
//     n_rep query heads of one kv-head over 64 / n_rep query positions
//     (32 x 2 at 16q/8kv), four warps of 16 rows;
//   - 64-key K/V tiles stream through a 2-stage cp.async ring in
//     XOR-swizzled shared memory; Q K^T and P V run on mma.sync.m16n8k16
//     from ldmatrix fragments; S, P (packed to bf16 as the A operand), the
//     fp32 pv accumulator, m and l stay in registers, row reductions over
//     the 4 lanes of a quad;
//   - the keys are split across blocks when the query tiles x kv-heads x
//     batch give fewer than ~2 blocks an SM: a block takes a contiguous
//     run of key tiles and writes a partial (pv, m, l) to fp32 scratch, and
//     flash_stats_kernel_combine folds the partials in split order, as ring
//     attention merges its hops (m = max, each side scaled by
//     exp(m_old - m)), so rows that keep no key still end with l = Sk and
//     pv = sum v.  The split count comes from the shapes and offsets
//     (flash_stats_plan), so the host reads nothing from the device;
//   - q, k and v are read where they lie, through their batch, head and
//     row strides (the last dimension contiguous), so the prefix engine's
//     transposed views need no copy;
//   - the running max starts at NEG_INF and a masked logit IS NEG_INF (not
//     -inf, as in K1): a masked p is exp(NEG_INF - m), 1 while the row has
//     seen no kept key and 0 after; a key past Sk is -inf, p = 0.  Only
//     tiles on a warp's diagonal or the ragged end are masked element by
//     element.  Tiles wholly above the diagonal are skipped (by a block or
//     a warp) only when every row in question keeps key 0, since then they
//     add exp(NEG_INF - m) = 0.
// No atomics and every sum in a fixed order: bitwise repeatable.
//
// float32 (every ring-attention hop, whatever the model's dtype, and the
// float32 engines' prefixed prefills) replaces the same TPU kernel at its
// float32 precision: full float32 FMAs (TF32 would not keep the
// reference's float32 einsums).  What bounds it on this card: operations,
// on the CUDA cores.  At the ring hop (B 8, 16 heads, 512 queries against a
// 512-key shard, Dh 128) a kept pair costs 4 Dh FLOPs against 67 TFLOP/s,
// far above the bytes of q, k, v and the fp32 outputs.  The first version
// read both operands of every FMA from shared memory (4-way bank
// conflicts), kept the pv accumulator in shared memory, copied each tile
// synchronously and ran four warps an SM: 16x its bound, 3.3x the plain
// einsum.  The float32 path now (fp32_tile.cuh):
//   - one block per (64-row query tile, head, batch), eight warps, the
//     later query tiles first under causal; kv-head by index, with the
//     strides;
//   - 64-key K/V tiles stream through a 2-stage ring of 16-byte cp.async
//     copies, the next tile in flight during the current one's products;
//   - S = Q K^T and pv += P V as register micro-tiles in outer-product
//     form: a thread owns 4 rows x 4 keys of S and 4 rows x Dh / 16
//     columns of pv, reading 16-byte vectors of padded, conflict-free
//     tiles; pv, m and l stay in registers, row reductions over the 16
//     lanes of a row group; P goes to shared memory once a tile, for the
//     row group's own P V;
//   - the semantics above (NEG_INF for a masked key, -inf past Sk, tiles
//     above the diagonal skipped only when every row keeps key 0), never
//     split.

#include <limits.h>
#include <math.h>

#include <algorithm>

#include "attn_common.cuh"
#include "fp32_tile.cuh"
#include "warp_mma.cuh"

namespace {

using namespace egs;

constexpr int TARGET_BLOCKS = 2 * 132;  // two blocks an SM of an H100
constexpr int MIN_SPLIT_TILES = 2;      // key tiles a split takes at least

// Strides, in elements, of q (B, H, Sq, D), k and v (B, Hkv, Sk, D): the
// last dimension is contiguous.
struct Strides {
  long long qs, qh, qb, ks, kh, kb, vs, vh, vb;
};

// -- bf16: GQA-packed rows, registers, cp.async, mma.sync, split keys ---------

constexpr int BQ = 64;   // rows a block: n_rep heads x 64 / n_rep query positions
constexpr int BK = 64;   // keys a streamed tile
constexpr int NT = 128;  // four warps, each owning 16 rows

template <int D>
constexpr size_t bf16_smem_bytes() {
  return sizeof(bf16) * (BQ * D + 4 * BK * D);  // Q, then 2 stages of K and of V
}

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The launch plan of the bf16 path, stated once: query positions a block
// (QT), query tiles, key tiles a split (tps) and splits.
struct Plan {
  int QT, n_qt, tps, splits;
};

Plan flash_stats_plan(int B, int H, int Hkv, int Sq, int Sk, int causal, int q_offset,
                      int k_offset) {
  Plan p;
  const int n_rep = H / Hkv;
  p.QT = BQ / n_rep;
  p.n_qt = ceil_div(Sq, p.QT);
  const int n_kt = ceil_div(Sk, BK);
  const int diag = q_offset - k_offset;
  // key tiles of the block that runs the most: all when a row keeps no key
  int kt_max = n_kt;
  if (causal && diag >= 0) kt_max = std::min(n_kt, (Sq - 1 + diag) / BK + 1);
  const int blocks = p.n_qt * Hkv * B;
  int splits = 1;
  if (blocks < TARGET_BLOCKS && kt_max >= 2 * MIN_SPLIT_TILES)
    splits = std::min(ceil_div(TARGET_BLOCKS, blocks), kt_max / MIN_SPLIT_TILES);
  p.tps = splits > 1 ? ceil_div(kt_max, splits) : (kt_max > 0 ? kt_max : 1);
  p.splits = splits > 1 ? ceil_div(kt_max, p.tps) : 1;
  return p;
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_stats_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, float* __restrict__ pv,
                        float* __restrict__ m_out, float* __restrict__ l_out, Strides st, int H,
                        int Hkv, int Sq, int Sk, int causal, int q_offset, int k_offset,
                        float scale, int tps, int splits) {
  constexpr int CH = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * D;      // stage s at sK + s * BK * D
  bf16* sV = sK + 2 * BK * D;  // stage s at sV + s * BK * D

  const int n_rep = H / Hkv, QT = BQ / n_rep;
  const int q0 = blockIdx.x * QT, hk = blockIdx.y;
  const int b = blockIdx.z / splits, split = blockIdx.z % splits;
  const int diag = q_offset - k_offset;  // key j is kept by query i iff j <= i + diag
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = warp * 16;
  const bf16* kg = k + b * st.kb + hk * st.kh;
  const bf16* vg = v + b * st.vb + hk * st.vh;

  // this lane's rows g and g + 8: (query head rep, query index qi)
  int rep[2], qi[2];
  bool valid[2];
  int lo = INT_MAX, hi = -1;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = wrow + g + 8 * e;
    rep[e] = r / QT;
    qi[e] = q0 + r % QT;
    valid[e] = rep[e] < n_rep && qi[e] < Sq;
    if (valid[e]) {
      lo = min(lo, qi[e]);
      hi = max(hi, qi[e]);
    }
  }
  const int wlo = __reduce_min_sync(0xffffffffu, lo);  // the warp's query range
  const int whi = __reduce_max_sync(0xffffffffu, hi);

  // key tiles: above the diagonal skipped only when every row keeps key 0
  const int n_kt = ceil_div(Sk, BK);
  int kt_end = n_kt;
  if (causal && q0 + diag >= 0) kt_end = min(n_kt, (min(q0 + QT, Sq) - 1 + diag) / BK + 1);
  const int kt_begin = split * tps;
  kt_end = min(kt_end, kt_begin + tps);

  // the Q rows (gathered across the group's heads) and the first K/V tile
  for (int i = threadIdx.x; i < BQ * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const int rp = r / QT, qq = q0 + r % QT;
    const bool ok = rp < n_rep && qq < Sq;
    const bf16* src = ok ? q + b * st.qb + (hk * n_rep + rp) * st.qh + qq * st.qs + c * 8 : q;
    cp_async16(sQ + tile_off<CH>(r, c), src, ok);
  }
  if (kt_begin < kt_end) {
    cp_tile<BK, D, NT>(sK, kg, kt_begin * BK, Sk, st.ks);
    cp_tile<BK, D, NT>(sV, vg, kt_begin * BK, Sk, st.vs);
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
    const int stg = (kt - kt_begin) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
    if (kt + 1 < kt_end) {
      cp_tile<BK, D, NT>(sK + (stg ^ 1) * BK * D, kg, (kt + 1) * BK, Sk, st.ks);
      cp_tile<BK, D, NT>(sV + (stg ^ 1) * BK * D, vg, (kt + 1) * BK, Sk, st.vs);
    }
    cp_async_commit();
    if (kt == kt_begin) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) load_a<CH>(qf[kk], sQ, wrow, kk, lane);
    }
    const int k0 = kt * BK;
    if (whi < 0 || (causal && wlo + diag >= 0 && k0 > whi + diag))
      continue;  // no row of the warp, or a tile that adds exp(NEG_INF - m) = 0 to each
    const bf16* cK = sK + stg * BK * D;
    const bf16* cV = sV + stg * BK * D;

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
        uint32_t bb[4];
        load_b<CH>(bb, cK, j * 8, kk, lane);
        mma16816(s[j], qf[kk], bb[0], bb[1]);
        mma16816(s[j + 1], qf[kk], bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale;
    if (k0 + BK > Sk || (causal && k0 + BK - 1 > wlo + diag)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + 2 * t + (e & 1);
          if (key >= Sk)
            s[j][e] = -INFINITY;  // not a key
          else if (causal && key > qi[e >> 1] + diag)
            s[j][e] = NEG_INF;  // a masked logit
        }
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
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = expf(s[j][e] - mx[e >> 1]);
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

    // pv += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t bb[4];
        load_b_trans<CH>(bb, cV, kk * 16, j, lane);
        mma16816(acc[j], pf[kk], bb[0], bb[1]);
        mma16816(acc[j + 1], pf[kk], bb[2], bb[3]);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  // this split's (pv, m, l): the output itself with one split, else its
  // partial in the scratch, split-major
  const size_t rows = (size_t)(gridDim.z / splits) * H * Sq;
  float* pvs = pv + split * rows * D;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float ls = quad_sum(l[e]);
    if (!valid[e]) continue;
    const size_t row = ((size_t)b * H + hk * n_rep + rep[e]) * Sq + qi[e];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(pvs + row * D + j * 8 + 2 * t) =
          make_float2(acc[j][2 * e], acc[j][2 * e + 1]);
    if (t == 0) {
      m_out[split * rows + row] = m[e];
      l_out[split * rows + row] = ls;
    }
  }
}

// (pv, m, l) = the splits' partials folded in split order
__global__ void __launch_bounds__(256)
flash_stats_kernel_combine(const float* __restrict__ part, float* __restrict__ pv,
                           float* __restrict__ m, float* __restrict__ l, int rows, int D,
                           int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)rows * D) return;
  const size_t row = i / D;
  const float* pm = part + (size_t)splits * rows * D;
  const float* pl = pm + (size_t)splits * rows;
  float mm = pm[row], ll = pl[row], aa = part[i];
  for (int s = 1; s < splits; ++s)
    fold_stats(mm, ll, aa, pm[(size_t)s * rows + row], pl[(size_t)s * rows + row],
               part[(size_t)s * rows * D + i]);
  pv[i] = aa;
  if (i % D == 0) {
    m[row] = mm;
    l[row] = ll;
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* pv, void* m, void* l,
                void* part, int B, int H, int Hkv, int Sq, int Sk, const Strides& st,
                int causal, int q_offset, int k_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = bf16_smem_bytes<D>();
  if (H / Hkv > BQ) return (int)cudaErrorInvalidValue;
  const Plan p = flash_stats_plan(B, H, Hkv, Sq, Sk, causal, q_offset, k_offset);
  if (p.splits > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  auto kern = flash_stats_kernel_bf16<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t rows = (size_t)B * H * Sq;
  float* out_pv = static_cast<float*>(p.splits > 1 ? part : pv);
  float* out_m = p.splits > 1 ? out_pv + p.splits * rows * D : static_cast<float*>(m);
  float* out_l = p.splits > 1 ? out_m + p.splits * rows : static_cast<float*>(l);
  dim3 grid(p.n_qt, Hkv, B * p.splits);
  kern<<<grid, NT, smem, stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                   static_cast<const bf16*>(v), out_pv, out_m, out_l, st, H,
                                   Hkv, Sq, Sk, causal, q_offset, k_offset, scale, p.tps,
                                   p.splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  flash_stats_kernel_combine<<<(unsigned)((rows * D + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(pv), static_cast<float*>(m),
      static_cast<float*>(l), (int)rows, D, p.splits);
  return (int)cudaGetLastError();
}

// -- float32: register micro-tiles, cp.async, eight warps ----------------------

// A block: 64 query rows of one head (f32::BR), 64-key K/V tiles (f32::BC)
// in a 2-stage cp.async ring; Q, the ring and the P tile in shared memory.
template <int D>
constexpr size_t fp32_smem_bytes() {
  return f32::smem_bytes<D>(1 + 4, 1, 0);  // Q, 2 stages of K and of V; P
}

template <int D>
__global__ void __launch_bounds__(f32::NT, 1)
flash_stats_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ pv,
                   float* __restrict__ m_out, float* __restrict__ l_out, Strides st, int H,
                   int Hkv, int Sq, int Sk, int causal, int q_offset, int k_offset,
                   float scale) {
  using namespace f32;
  constexpr int LD = ld<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + BR * LD;      // stage s at sK + s * BC * LD
  float* sV = sK + 2 * BC * LD;  // stage s at sV + s * BC * LD
  float* sP = sV + 2 * BC * LD;

  // the later query tiles, which keep more key tiles under causal, first
  const int n_qt = ceil_div(Sq, BR);
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.z : (int)blockIdx.z) * BR;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (H / Hkv);  // this head's kv-head
  const float* kg = k + b * st.kb + hk * st.kh;
  const float* vg = v + b * st.vb + hk * st.vh;
  const int diag = q_offset - k_offset;  // key j is kept by query i iff j <= i + diag
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;

  // key tiles: above the diagonal skipped only when every row keeps key 0
  const int n_kt = ceil_div(Sk, BC);
  int kt_end = n_kt;
  if (causal && q0 + diag >= 0) kt_end = min(n_kt, (q0 + BR - 1 + diag) / BC + 1);

  cp_tile<BR, D>(sQ, q + b * st.qb + h * st.qh, q0, Sq, st.qs);
  if (kt_end > 0) {
    cp_tile<BC, D>(sK, kg, 0, Sk, st.ks);
    cp_tile<BC, D>(sV, vg, 0, Sk, st.vs);
  }
  cp_async_commit();

  float o[TR][D / 16];
  float m[TR], l[TR];  // each lane of a row group holds its rows' running max and sum
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < D / 16; ++n) o[i][n] = 0.f;
  }

  for (int kt = 0; kt < kt_end; ++kt) {
    const int stg = kt & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
    if (kt + 1 < kt_end) {
      cp_tile<BC, D>(sK + (stg ^ 1) * BC * LD, kg, (kt + 1) * BC, Sk, st.ks);
      cp_tile<BC, D>(sV + (stg ^ 1) * BC * LD, vg, (kt + 1) * BC, Sk, st.vs);
    }
    cp_async_commit();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
    scores<D>(s, sQ, sK + stg * BC * LD, rg, cg);

    // online softmax of the thread's rows: a masked key is the logit
    // NEG_INF, a key past Sk is no key at all (-inf, p = 0)
    const int k0 = kt * BC;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = q0 + 4 * rg + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int key = k0 + cg + 16 * j;
        const bool real = key < Sk;
        const bool kept = real && (!causal || key <= row + diag);
        s[i][j] = kept ? s[i][j] * scale : (real ? NEG_INF : -INFINITY);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = row_max(mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        sP[(4 * rg + i) * LDP + cg + 16 * j] = p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < D / 16; ++n) o[i][n] *= alpha;
    }
    __syncwarp();  // the row group's P rows are in place

    // pv += P V
    accumulate<D>(o, sP, sV + stg * BC * LD, rg, cg);
  }
  cp_async_wait<0>();  // no copy outlives the block

  const size_t bh = (size_t)b * H + h;
  store_rows<D>(pv + bh * Sq * D, o, q0, Sq, rg, cg);
  if (cg == 0) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = q0 + 4 * rg + i;
      if (row < Sq) {
        m_out[bh * Sq + row] = m[i];
        l_out[bh * Sq + row] = l[i];
      }
    }
  }
}

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, void* pv, void* m, void* l, int B,
                int H, int Hkv, int Sq, int Sk, const Strides& st, int causal, int q_offset,
                int k_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = fp32_smem_bytes<D>();
  static_assert(smem <= 232448, "K3's float32 tiles exceed a block's shared memory");
  auto kern = flash_stats_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B, ceil_div(Sq, f32::BR));
  kern<<<grid, f32::NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(pv), static_cast<float*>(m), static_cast<float*>(l), st, H, Hkv, Sq,
      Sk, causal, q_offset, k_offset, scale);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch(int dtype, const void* q, const void* k, const void* v, void* pv, void* m,
             void* l, void* part, int B, int H, int Hkv, int Sq, int Sk, const Strides& st,
             int causal, int q_offset, int k_offset, float scale, cudaStream_t s) {
  if (dtype == 1)
    return launch_bf16<D>(q, k, v, pv, m, l, part, B, H, Hkv, Sq, Sk, st, causal, q_offset,
                          k_offset, scale, s);
  if (dtype == 0)
    return launch_fp32<D>(q, k, v, pv, m, l, B, H, Hkv, Sq, Sk, st, causal, q_offset, k_offset,
                          scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Splits of the keys one call takes (1: no scratch, no combine kernel);
// the wrapper allocates splits x B x H x Sq x (D + 2) fp32 words of
// scratch when more.  dtype: 0 = float32 (never split), 1 = bfloat16.
extern "C" int egs_flash_block_stats_splits(int B, int H, int Hkv, int Sq, int Sk, int dtype,
                                            int causal, int q_offset, int k_offset) {
  if (dtype != 1 || Hkv <= 0 || H % Hkv || Sq <= 0) return 1;
  return flash_stats_plan(B, H, Hkv, Sq, Sk, causal, q_offset, k_offset).splits;
}

// q (B,H,Sq,D), k/v (B,Hkv,Sk,D) with Hkv dividing H, each with its row,
// head and batch strides in elements (last dimension contiguous, 16-byte
// aligned rows); pv (B,H,Sq,D) fp32; m, l (B,H,Sq) fp32; part: the
// scratch of egs_flash_block_stats_splits (null with one split).  dtype:
// 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int egs_flash_block_stats(const void* q, const void* k, const void* v, void* pv,
                                     void* m, void* l, void* part, int B, int H, int Hkv,
                                     int Sq, int Sk, int D, long long q_row, long long q_head,
                                     long long q_batch, long long k_row, long long k_head,
                                     long long k_batch, long long v_row, long long v_head,
                                     long long v_batch, int dtype, int causal, int q_offset,
                                     int k_offset, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || H % Hkv) return (int)cudaErrorInvalidValue;
  const Strides st{q_row, q_head, q_batch, k_row, k_head, k_batch, v_row, v_head, v_batch};
  switch (D) {
    case 32:
      return dispatch<32>(dtype, q, k, v, pv, m, l, part, B, H, Hkv, Sq, Sk, st, causal,
                          q_offset, k_offset, scale, s);
    case 64:
      return dispatch<64>(dtype, q, k, v, pv, m, l, part, B, H, Hkv, Sq, Sk, st, causal,
                          q_offset, k_offset, scale, s);
    case 128:
      return dispatch<128>(dtype, q, k, v, pv, m, l, part, B, H, Hkv, Sq, Sk, st, causal,
                           q_offset, k_offset, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
