// Paged decode / verify attention (kernel K2) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_paged_kernel` of
// elastic_gpu_scheduler_tpu/ops/paged_attention.py (launched by
// `paged_attention`): attention read straight from the serving engine's
// page pool, never gathered into a contiguous copy.  Query w of row b sits
// at position lengths[b] + w and attends to every key position <= its own,
// restricted to the sliding window when window > 0; the key at position t
// lives in pool page tables[b, t / ps], slot t % ps.
//
// What bounds it on this card: bytes.  Each live K/V page is read once and
// the arithmetic is a few FLOPs per byte, far below the H100's ridge point.
// At the engine's shapes (8 rows, 8 kv-heads) one block a (kv-head, row)
// gives 64 blocks on 132 SMs, so what limits a call is how fast one
// block's walk over a row's ~30 live pages goes: the first version spent
// four block barriers and a serial 128-step dot product a page, and ran
// ~70x above its bound.  This design:
//   - splits the pages across blocks (flash-decoding): the grid is
//     (kv-head x row group, batch row, split), each split a fixed run of
//     pages, its count from the table's width NB and the grid's other
//     dimensions (never from `lengths`, which stay on the device); a split
//     writes an fp32 partial (acc, m, l) and paged_attn_combine_kernel
//     folds the splits in order, as ring attention merges its hops, then
//     divides by max(l, 1e-30).  One split writes the output directly;
//   - four warps a block, each on its own 16-key chunks of the split
//     (chunk c to warp c mod 4), with no block barrier until the end: a
//     warp copies a chunk's K and V rows (and an int8 pool's scales) into
//     its own 2-stage ring of shared memory by 16-byte cp.async, so the
//     next chunk is in flight while this one is computed;
//   - a half-warp a key: lane j of a half holds dims j Dh/16.. of the key
//     and of the block's query rows (in registers), and its partial dot
//     products reduce over 4 shuffles; the online softmax runs per warp in
//     registers (the running max is shared by both halves, each half sums
//     its own keys), and so does acc += p v; the warps fold their
//     (acc, m, l) through shared memory in warp order at the end;
//   - a block takes up to 4 of a kv-head's n_rep x W query rows, kept in
//     registers (GQA never expands K/V); more rows take more row groups in
//     the grid (the verify window's 8 rows at 16q/8kv: two);
//   - keys past the last query, keys past the table, and keys below the
//     earliest query's window are neither read nor computed; a masked key's
//     logit is -inf while the running max starts at the reference's finite
//     NEG_INF, so its p is exactly 0, as exp(NEG_INF - m) is in the
//     reference; a split with no live key writes m = NEG_INF, l = 0,
//     acc = 0, which the fold weights by exp(NEG_INF - m) = 0.
// All math in fp32 (the TPU kernel upcasts q, k and v), the scale applied
// after the dot.  No atomics and every sum in a fixed order: bitwise
// repeatable.
// int8 pools (the reference's kv_int8 engine): K/V rows stored as int8
// with one fp32 scale per (token, kv-head).  The rows stay int8 through
// the copy into shared memory; each value is dequantised as it is read
// into registers, through the compute dtype T exactly as the reference's
// `_dequant` does (int8 -> fp32, times the scale, rounded to T, back to
// fp32), so the kernel and the gather engine see the same K/V values and
// stay token-identical.  Each (token, kv-head) scale is copied once.

#include "attn_common.cuh"
#include "warp_mma.cuh"

namespace {

using namespace egs;

constexpr int NW = 4;              // warps a block
constexpr int NTHREADS = NW * 32;
constexpr int CHUNK = 16;          // key positions a warp takes at a time
constexpr int RG_MAX = 4;          // query rows a block
constexpr int TARGET_BLOCKS = 2 * 132;  // two blocks an SM of an H100

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// query rows a block holds for R query rows of a kv-head: 2 or RG_MAX (a
// lane keeps 8 scores and Dh / 16 dims of q and of acc a row in registers)
__host__ __device__ constexpr int row_block(int R) { return R <= 2 ? 2 : RG_MAX; }

// The split rule, stated once: the table's NB pages are cut into runs of
// a multiple of NW pages (one a warp) so that the grid reaches
// TARGET_BLOCKS blocks where the pages allow it.
int pages_per_split(int B, int Hkv, int groups, int NB) {
  if (NB <= 0) return NW;
  const int base = B * Hkv * groups > 0 ? B * Hkv * groups : 1;
  int want = ceil_div(TARGET_BLOCKS, base);
  if (want > ceil_div(NB, NW)) want = ceil_div(NB, NW);
  if (want < 1) want = 1;
  return ceil_div(ceil_div(NB, want), NW) * NW;
}

int n_splits(int B, int Hkv, int groups, int NB) {
  const int s = ceil_div(NB, pages_per_split(B, Hkv, groups, NB));
  return s > 1 ? s : 1;
}

// One warp's ring stage: a chunk's K and V rows, then (int8) their scales.
template <typename P, int Dh>
struct Stage {
  static constexpr int ROW_BYTES = Dh * (int)sizeof(P);
  static constexpr int CPR = ROW_BYTES / 16;       // 16-byte pieces a key row
  static constexpr int PIECES = CHUNK * CPR / 32;  // a lane's pieces of a K (or V) chunk
  static constexpr int VEC = 16 / (int)sizeof(P);  // elements a piece
  static constexpr size_t BYTES = 2 * CHUNK * ROW_BYTES + 2 * CHUNK * sizeof(float);
  static_assert(CHUNK * CPR % 32 == 0, "whole pieces a lane");
};

template <typename P, int Dh>
constexpr size_t smem_bytes() {
  return NW * 2 * Stage<P, Dh>::BYTES;
}

// element i of type E packed in 32-bit words, as a float
__device__ __forceinline__ float word_elem(const uint32_t* w, int i, float) {
  return __uint_as_float(w[i]);
}
__device__ __forceinline__ float word_elem(const uint32_t* w, int i, __nv_bfloat16) {
  const uint32_t x = w[i / 2];
  return __uint_as_float(i % 2 ? x & 0xffff0000u : x << 16);
}
__device__ __forceinline__ float word_elem(const uint32_t* w, int i, int8_t) {
  return (float)((int)(w[i / 4] << (24 - 8 * (i % 4))) >> 24);
}

// N values of type E at p (N * sizeof(E) bytes, so aligned) as floats, in
// one vector load where they fill 16 bytes (8 bf16, 4 fp32, 16 int8)
template <typename E, int N>
__device__ __forceinline__ void load_vals(float (&f)[N], const E* p) {
  constexpr int BYTES = N * (int)sizeof(E);
  uint32_t w[BYTES >= 4 ? BYTES / 4 : 1];
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = x.x;
      w[4 * i + 1] = x.y;
      w[4 * i + 2] = x.z;
      w[4 * i + 3] = x.w;
    }
  } else if constexpr (BYTES == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x;
    w[1] = x.y;
  } else if constexpr (BYTES == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    static_assert(BYTES == 2, "2 to 16n bytes");
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = word_elem(w, i, E());
}

// T: q / out and compute dtype; P: pool element (T, or int8_t with scales)
template <typename T, typename P, int Dh, int RG>
__global__ void __launch_bounds__(NTHREADS, 1)  // (, 1): ptxas spilled at 72-168 registers
paged_attn_kernel(const T* __restrict__ q, const P* __restrict__ pool_k,
                  const P* __restrict__ pool_v, const float* __restrict__ scales_k,
                  const float* __restrict__ scales_v, const int* __restrict__ tables,
                  const int* __restrict__ lengths, T* __restrict__ out,
                  float* __restrict__ part, int W, int Hn, int Hkv, int ps, int NB, int window,
                  float scale, int split_tokens) {
  constexpr bool kInt8 = std::is_same<P, int8_t>::value;
  using St = Stage<P, Dh>;
  constexpr int DPL = Dh / 16;  // dims a lane holds of a key row
  extern __shared__ __align__(16) unsigned char smem[];

  const int n_rep = Hn / Hkv, R = n_rep * W;
  const int groups = ceil_div(R, RG);
  const int hk = blockIdx.x / groups, r0 = (blockIdx.x % groups) * RG;
  const int b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int half = lane / 16, j = lane % 16;
  unsigned char* ring = smem + warp * 2 * St::BYTES;

  // this lane's dims of the block's query rows r0.. (row r = (w, rep)),
  // zeros past R
  float qf[RG][DPL];
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    const int rr = r0 + r < R ? r0 + r : 0;
    load_vals<T, DPL>(qf[r], q + (((size_t)b * W + rr / n_rep) * Hn + hk * n_rep + rr % n_rep) *
                                     Dh + j * DPL);
    if (r0 + r >= R)
#pragma unroll
      for (int e = 0; e < DPL; ++e) qf[r][e] = 0.f;
  }

  // live keys of this split: [t_begin, t_end)
  const int length = lengths[b];
  const int last = min(length + W - 1, NB * ps - 1);  // the last query's position, in the table
  const int lo_live = window > 0 ? max(0, length - window + 1) : 0;  // earliest query's window
  const int cbase = split * split_tokens;
  const int t_begin = max(cbase, lo_live);
  const int t_end = min(cbase + split_tokens, last + 1);
  const int c_first = t_begin < t_end ? (t_begin - cbase) / CHUNK : 0;
  const int c_end = t_begin < t_end ? (t_end - 1 - cbase) / CHUNK + 1 : 0;

  auto issue = [&](int c, int st) {
    P* sK = reinterpret_cast<P*>(ring + st * St::BYTES);
    P* sV = sK + CHUNK * Dh;
    float* sS = reinterpret_cast<float*>(sV + CHUNK * Dh);
    const int c0 = cbase + c * CHUNK;
#pragma unroll
    for (int n = 0; n < St::PIECES; ++n) {
      const int i = lane + 32 * n, tok = i / St::CPR, pc = i % St::CPR;
      const int kpos = c0 + tok;
      const bool ok = kpos >= t_begin && kpos < t_end;
      const size_t row =
          ok ? ((size_t)tables[(size_t)b * NB + kpos / ps] * ps + kpos % ps) * Hkv + hk : 0;
      cp_async16(sK + tok * Dh + pc * St::VEC, pool_k + row * Dh + pc * St::VEC, ok);
      cp_async16(sV + tok * Dh + pc * St::VEC, pool_v + row * Dh + pc * St::VEC, ok);
    }
    if constexpr (kInt8) {
      const int kpos = c0 + j;
      const bool ok = kpos >= t_begin && kpos < t_end;
      const size_t row =
          ok ? ((size_t)tables[(size_t)b * NB + kpos / ps] * ps + kpos % ps) * Hkv + hk : 0;
      cp_async4(sS + lane, (half ? scales_v : scales_k) + row, ok);
    }
  };

  float m[RG], l[RG], acc[RG][DPL];
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }

  int c = c_first + warp;
  if (c < c_end) issue(c, 0);
  cp_async_commit();
  for (int it = 0; c < c_end; ++it, c += NW) {
    if (c + NW < c_end) issue(c + NW, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();  // every lane's copies of chunk c have landed
    const P* sK = reinterpret_cast<const P*>(ring + (it & 1) * St::BYTES);
    const P* sV = sK + CHUNK * Dh;
    const float* sS = reinterpret_cast<const float*>(sV + CHUNK * Dh);
    const int c0 = cbase + c * CHUNK;

    // scores of keys 2i + half, reduced over the half-warp
    float s[CHUNK / 2][RG];
#pragma unroll
    for (int i = 0; i < CHUNK / 2; ++i) {
      const int tok = 2 * i + half, kpos = c0 + tok;
      float kf[DPL];
      load_vals<P, DPL>(kf, sK + tok * Dh + j * DPL);
      if constexpr (kInt8) {
#pragma unroll
        for (int e = 0; e < DPL; ++e) kf[e] = to_float(from_float<T>(kf[e] * sS[tok]));
      }
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < DPL; ++e) a += qf[r][e] * kf[e];
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        const int qpos = length + (r0 + r) / n_rep;
        const bool keep = r0 + r < R && kpos >= t_begin && kpos < t_end && kpos <= qpos &&
                          (window <= 0 || qpos - kpos < window);
        s[i][r] = keep ? a * scale : -INFINITY;
      }
    }

    // online softmax: the running max is the warp's, each half sums its keys
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      float mx = m[r];
#pragma unroll
      for (int i = 0; i < CHUNK / 2; ++i) mx = fmaxf(mx, s[i][r]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float alpha = expf(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < CHUNK / 2; ++i) {
        s[i][r] = expf(s[i][r] - mx);
        sum += s[i][r];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] *= alpha;
    }

    // acc += p v over this half's keys
#pragma unroll
    for (int i = 0; i < CHUNK / 2; ++i) {
      const int tok = 2 * i + half;
      float vf[DPL];
      load_vals<P, DPL>(vf, sV + tok * Dh + j * DPL);
      if constexpr (kInt8) {
#pragma unroll
        for (int e = 0; e < DPL; ++e) vf[e] = to_float(from_float<T>(vf[e] * sS[CHUNK + tok]));
      }
#pragma unroll
      for (int r = 0; r < RG; ++r)
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] += s[i][r] * vf[e];
    }
    __syncwarp();  // the stage is read before the next chunk overwrites it
  }

  // the two halves' sums (a + b in both halves: equal bits)
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 16);
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], 16);
  }

  // the warps' (acc, m, l) through shared memory (each warp's own ring),
  // folded in warp order
  cp_async_wait<0>();
  __syncthreads();
  float* mine = reinterpret_cast<float*>(ring);  // acc (RG, Dh), m (RG), l (RG)
  if (half == 0) {
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int e = 0; e < DPL; ++e) mine[r * Dh + j * DPL + e] = acc[r][e];
  }
  if (lane < RG) {
#pragma unroll
    for (int r = 0; r < RG; ++r)
      if (r == lane) {
        mine[RG * Dh + r] = m[r];
        mine[RG * Dh + RG + r] = l[r];
      }
  }
  __syncthreads();
  const unsigned char* rings = smem;
  const int NR = gridDim.y * W * Hn;  // output rows
  for (int i = tid; i < RG * Dh; i += NTHREADS) {
    const int r = i / Dh, d = i % Dh;
    if (r0 + r >= R) continue;
    const float* w0 = reinterpret_cast<const float*>(rings);
    float mm = w0[RG * Dh + r], ll = w0[RG * Dh + RG + r], aa = w0[i];
    for (int w = 1; w < NW; ++w) {
      const float* ww = reinterpret_cast<const float*>(rings + w * 2 * St::BYTES);
      fold_stats(mm, ll, aa, ww[RG * Dh + r], ww[RG * Dh + RG + r], ww[i]);
    }
    const int rr = r0 + r;
    const size_t row = ((size_t)b * W + rr / n_rep) * Hn + hk * n_rep + rr % n_rep;
    if (gridDim.z == 1) {
      out[row * Dh + d] = from_float<T>(aa / fmaxf(ll, 1e-30f));
    } else {
      part[((size_t)split * NR + row) * Dh + d] = aa;
      if (d == 0) {
        float* pm = part + (size_t)gridDim.z * NR * Dh;
        pm[(size_t)split * NR + row] = mm;
        pm[(size_t)gridDim.z * NR + (size_t)split * NR + row] = ll;
      }
    }
  }
}

// out = the splits' partials folded in split order, over max(l, 1e-30)
template <typename T>
__global__ void __launch_bounds__(256)
paged_attn_combine_kernel(const float* __restrict__ part, T* __restrict__ out, int NR, int Dh,
                          int S) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)NR * Dh) return;
  const size_t row = i / Dh;
  const float* pm = part + (size_t)S * NR * Dh;
  const float* pl = pm + (size_t)S * NR;
  float mm = pm[row], ll = pl[row], aa = part[i];
  for (int s = 1; s < S; ++s)
    fold_stats(mm, ll, aa, pm[(size_t)s * NR + row], pl[(size_t)s * NR + row],
         part[(size_t)s * NR * Dh + i]);
  out[i] = from_float<T>(aa / fmaxf(ll, 1e-30f));
}

template <typename T, typename P, int Dh, int RG>
int launch(const void* q, const void* pk, const void* pv, const void* sk, const void* sv,
           const void* tables, const void* lengths, void* out, void* part, int B, int W,
           int Hn, int Hkv, int ps, int NB, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<P, Dh>();
  static_assert(smem <= 232448, "K2 rings exceed a block's shared memory");
  const int groups = ceil_div((Hn / Hkv) * W, RG);
  const int pps = pages_per_split(B, Hkv, groups, NB);
  const int S = n_splits(B, Hkv, groups, NB);
  if (S > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  auto kern = paged_attn_kernel<T, P, Dh, RG>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv * groups, B, S);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(pk), static_cast<const P*>(pv),
      static_cast<const float*>(sk), static_cast<const float*>(sv),
      static_cast<const int*>(tables), static_cast<const int*>(lengths), static_cast<T*>(out),
      static_cast<float*>(part), W, Hn, Hkv, ps, NB, window, scale, pps * ps);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  const int NR = B * W * Hn;
  paged_attn_combine_kernel<T><<<ceil_div(NR * Dh, 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), NR, Dh, S);
  return (int)cudaGetLastError();
}

template <typename T, typename P, int Dh>
int dispatch_rows(const void* q, const void* pk, const void* pv, const void* sk, const void* sv,
                  const void* tables, const void* lengths, void* out, void* part, int B, int W,
                  int Hn, int Hkv, int ps, int NB, int window, float scale, cudaStream_t s) {
  switch (row_block((Hn / Hkv) * W)) {
    case 2:
      return launch<T, P, Dh, 2>(q, pk, pv, sk, sv, tables, lengths, out, part, B, W, Hn, Hkv,
                                 ps, NB, window, scale, s);
    default:
      return launch<T, P, Dh, RG_MAX>(q, pk, pv, sk, sv, tables, lengths, out, part, B, W, Hn,
                                      Hkv, ps, NB, window, scale, s);
  }
}

template <typename T, typename P>
int dispatch_d(int Dh, const void* q, const void* pk, const void* pv, const void* sk,
               const void* sv, const void* tables, const void* lengths, void* out, void* part,
               int B, int W, int Hn, int Hkv, int ps, int NB, int window, float scale,
               cudaStream_t s) {
  if (Hkv <= 0 || Hn % Hkv || W <= 0 || ps <= 0) return (int)cudaErrorInvalidValue;
  switch (Dh) {
    case 32:
      return dispatch_rows<T, P, 32>(q, pk, pv, sk, sv, tables, lengths, out, part, B, W, Hn,
                                     Hkv, ps, NB, window, scale, s);
    case 64:
      return dispatch_rows<T, P, 64>(q, pk, pv, sk, sv, tables, lengths, out, part, B, W, Hn,
                                     Hkv, ps, NB, window, scale, s);
    case 128:
      return dispatch_rows<T, P, 128>(q, pk, pv, sk, sv, tables, lengths, out, part, B, W, Hn,
                                      Hkv, ps, NB, window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of dynamic shared memory one block needs at head dim Dh for a pool
// of pool_bytes an element (the wrapper checks it against the card's limit
// before launching); -1 for what the kernel does not take.
extern "C" long long egs_paged_attention_smem(int Dh, int pool_bytes) {
  if (Dh <= 0 || pool_bytes <= 0) return -1;
  return (long long)NW * 2 * (2 * CHUNK * Dh * pool_bytes + 2 * CHUNK * 4);
}

// fp32 words of scratch the call needs for its splits' partials (0 with
// one split); the wrapper allocates them
extern "C" long long egs_paged_attention_workspace(int B, int W, int Hn, int Hkv, int Dh,
                                                   int NB) {
  if (Hkv <= 0 || Hn % Hkv || W <= 0) return 0;
  const int groups = ceil_div((Hn / Hkv) * W, row_block((Hn / Hkv) * W));
  const int S = n_splits(B, Hkv, groups, NB);
  return S > 1 ? (long long)S * B * W * Hn * (Dh + 2) : 0;
}

// q (B,W,Hn,Dh); pools (n_pages,ps,Hkv,Dh) in q's dtype; tables (B,NB) and
// lengths (B,) int32; out like q; part: egs_paged_attention_workspace fp32
// words (null when 0).  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError().
extern "C" int egs_paged_attention(const void* q, const void* pool_k, const void* pool_v,
                                   const void* tables, const void* lengths, void* out,
                                   void* part, int B, int W, int Hn, int Hkv, int Dh, int ps,
                                   int NB, int dtype, int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(Dh, q, pool_k, pool_v, nullptr, nullptr,
                                                    tables, lengths, out, part, B, W, Hn, Hkv,
                                                    ps, NB, window, scale, s);
  if (dtype == 0)
    return dispatch_d<float, float>(Dh, q, pool_k, pool_v, nullptr, nullptr, tables, lengths,
                                    out, part, B, W, Hn, Hkv, ps, NB, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// As egs_paged_attention over an int8 pool: pools (n_pages,ps,Hkv,Dh) int8,
// scales (n_pages,ps,Hkv) fp32; dtype is q's, and the compute dtype the
// K/V values are dequantised through.
extern "C" int egs_paged_attention_int8(const void* q, const void* pool_k, const void* pool_v,
                                        const void* scales_k, const void* scales_v,
                                        const void* tables, const void* lengths, void* out,
                                        void* part, int B, int W, int Hn, int Hkv, int Dh,
                                        int ps, int NB, int dtype, int window, float scale,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, int8_t>(Dh, q, pool_k, pool_v, scales_k, scales_v, tables,
                                             lengths, out, part, B, W, Hn, Hkv, ps, NB, window,
                                             scale, s);
  if (dtype == 0)
    return dispatch_d<float, int8_t>(Dh, q, pool_k, pool_v, scales_k, scales_v, tables,
                                     lengths, out, part, B, W, Hn, Hkv, ps, NB, window, scale,
                                     s);
  return (int)cudaErrorInvalidValue;
}
