// Expert-indexed / int8 weight product (kernel KE) for Hopper, sm_90a.
//
//   y[t] = x[t] @ W[ids[t]]      x (T, K), W (E, K, N), y (T, N)
//
// W is the compute dtype (bf16 or fp32) or int8 `q8` with per-column fp32
// scales (E, 1, N); ids (T,) int32 on the device, or none (every token on
// expert 0: the dense int8 case, E = 1).  Sums in fp32; y in the compute
// dtype or fp32, as the caller asks.
//
// Replaces no Pallas kernel.  In the reference this work is XLA's:
//   - the `wmat` fusion (elastic_gpu_scheduler_tpu/models/quantize.py:62-71),
//     where `q8.astype(dtype) * scale` folds into the matmul's weight read
//     so that int8 weights are read as int8 and never written out dense;
//   - `_moe_ffn_serve`'s expert products
//     (elastic_gpu_scheduler_tpu/models/serving.py:397-405, the per-token
//     gather of expert matrices at decode size, and :428-441, the sorted
//     `lax.ragged_dot` grouped form at prefill size).
// In PyTorch, `wmat` then `torch.matmul` writes a dense copy of every
// weight at every use, and the gather form copies T expert matrices.  This
// kernel reads each weight in place, as int8 where it is int8, and touches
// only the experts some token chose.
//
// Dequantisation gives the reference's values bit for bit, in registers:
//   bf16:  bf16(float(q) * float(bf16(scale)))   (q and the scale cast to
//          bf16, the product rounded to bf16 once: the product of two bf16
//          values is exact in fp32);
//   fp32:  float(q) * scale.
//
// What bounds it on this card: weight bytes at decode size (a few tokens
// an expert, ~2 FLOPs a weight byte, far below the ridge), operations at
// prefill size (T in the hundreds).  This first design is simple and
// right; what it does about the bound:
//   - the grid is (N tiles of 64 columns, expert x token run, K splits).
//     A block finds its expert's tokens itself: it scans `ids` in order
//     (ballots and a block prefix) for its run of them (find_tokens).
//     Nothing is read on the host, so a captured CUDA graph replays it for
//     any routing; a block whose expert has no token in its run exits
//     after the scan, so an expert no token chose costs no weight read.
//     Each weight element is read once a block and used for all of the
//     block's tokens;
//   - bf16 x (every bf16 model's product) takes tensor cores,
//     expert_matmul_mma_kernel: 4 warps, runs of 16 tokens (64 where an
//     expert averages more than 16), double-buffered swizzled tiles of 64
//     K rows, an int8 weight dequantised once a block on its way to shared
//     memory, mma.sync.m16n8k16 with fp32 sums.  At decode a run holds one
//     or two real tokens: the tiles' spare rows cost nothing the bytes
//     do not already bound;
//   - float32 x, or a shape the tensor-core tiles do not take (N not a
//     multiple of 16, unaligned rows), takes CUDA cores,
//     expert_matmul_kernel: fp32 FMAs (exact products, as float32 models
//     need), runs of 8 tokens staged in shared memory, 8 columns x 32 K
//     slices of threads, each keeping 64 bytes of weight rows in flight,
//     the slices folded by shuffles and then by warp in a fixed order;
//   - K is split across blocks when the grid would hold fewer than two
//     blocks an SM (a few tokens over a narrow N: the int8 dense
//     projections at decode) or when a CUDA-core block could not stage its
//     K range; each split writes an fp32 partial and
//     expert_matmul_combine_kernel adds them in order.
// The plan (kernel, runs, splits) comes from the shapes only (make_plan,
// egs_expert_matmul_plan).  No atomics, every sum in a fixed order:
// bitwise repeatable, and a token's row never depends on which other
// tokens share the call.  wgmma, TMA and a deeper weight pipeline are
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "warp_mma.cuh"

namespace {

constexpr int NT = 64;          // output columns a block
constexpr int MT = 8;           // tokens a block
constexpr int NTHREADS = 256;
constexpr int NCG = NT / 8;     // column groups (8 columns a thread)
constexpr int NKS = NTHREADS / NCG;  // K slices: 32
constexpr int NWARPS = NTHREADS / 32;
constexpr int SMEM = 32768;     // x rows staged, then the fold's partials
constexpr int TARGET_BLOCKS = 2 * 132;  // two blocks an SM of an H100

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// K rows a block can stage for its MT tokens
__host__ __device__ constexpr int max_rows(int x_bytes) { return SMEM / (MT * x_bytes); }

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One thread's 8 columns of a weight row as loaded (raw bits; converted
// and dequantised at use, so a loaded row costs 2 to 8 registers).
// Weight rows a thread keeps in flight: 64 bytes of them.
template <typename TW, bool VEC> struct Row;
template <> struct Row<__nv_bfloat16, true> {
  static constexpr int IN_FLIGHT = 4;
  uint4 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p, int, int) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void get(float (&o)[8]) const {
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = __bfloat162float(b[j]);
  }
};
template <> struct Row<int8_t, true> {
  static constexpr int IN_FLIGHT = 8;
  uint2 v;
  __device__ __forceinline__ void load(const int8_t* p, int, int) {
    v = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void get(float (&o)[8]) const {
    const int8_t* q = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = (float)q[j];
  }
};
template <> struct Row<float, true> {
  static constexpr int IN_FLIGHT = 2;
  float4 a, b;
  __device__ __forceinline__ void load(const float* p, int, int) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void get(float (&o)[8]) const {
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
};
// N not a multiple of 8, or a misaligned weight: column by column
template <typename TW> struct Row<TW, false> {
  static constexpr int IN_FLIGHT = 2;
  float f[8];
  __device__ __forceinline__ void load(const TW* p, int n0, int N) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (n0 + j < N) {
        if constexpr (std::is_same<TW, int8_t>::value) f[j] = (float)p[j];
        else f[j] = to_f(p[j]);
      } else {
        f[j] = 0.0f;
      }
    }
  }
  __device__ __forceinline__ void get(float (&o)[8]) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = f[j];
  }
};

// The block's tokens: the run [first, first + MTOK) of those routed to
// expert e (every token when ids is null), in token order, into tok.
// Returns their count (uniform across the block; <= 0: nothing to do).
template <int MTOK, int NTH>
__device__ __forceinline__ int find_tokens(const int* __restrict__ ids, int T, int e, int first,
                                           int* tok, int* warp_cnt) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  int cnt;
  if (ids == nullptr) {
    for (int i = tid; i < MTOK; i += NTH) tok[i] = first + i;
    cnt = min(MTOK, T - first);
  } else {
    int base = 0;
    for (int t0 = 0; t0 < T && base < first + MTOK; t0 += NTH) {
      const int t = t0 + tid;
      const bool f = t < T && __ldg(ids + t) == e;
      const unsigned bal = __ballot_sync(0xffffffffu, f);
      if (lane == 0) warp_cnt[wid] = __popc(bal);
      __syncthreads();
      int off = base, total = 0;
#pragma unroll
      for (int i = 0; i < NTH / 32; ++i) {
        off += i < wid ? warp_cnt[i] : 0;
        total += warp_cnt[i];
      }
      if (f) {
        const int r = off + __popc(bal & ((1u << lane) - 1u)) - first;
        if (r >= 0 && r < MTOK) tok[r] = t;
      }
      base += total;
      __syncthreads();
    }
    cnt = min(MTOK, base - first);
  }
  if (cnt > 0) __syncthreads();  // tok is written
  return cnt;
}

template <typename TX, typename TW, typename TO, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
expert_matmul_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                     const float* __restrict__ scale, const int* __restrict__ ids,
                     TO* __restrict__ out, float* __restrict__ part, int T, int K, int N,
                     int chunks, int rows_per_split) {
  using R = Row<TW, VEC>;
  constexpr int G = R::IN_FLIGHT;
  __shared__ int tok[MT];
  __shared__ int warp_cnt[NWARPS];
  __shared__ __align__(16) unsigned char smem[SMEM];
  TX* xs = reinterpret_cast<TX*>(smem);        // [MT][rows]: this block's x
  float* red = reinterpret_cast<float*>(smem);  // [NWARPS][MT][NT], after the sums

  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int e = blockIdx.y / chunks, c = blockIdx.y % chunks;
  const int first = c * MT;

  const int cnt = find_tokens<MT, NTHREADS>(ids, T, e, first, tok, warp_cnt);
  if (cnt <= 0) return;  // uniform across the block

  // stage the block's x rows (its K range, its tokens) once
  const int kb = blockIdx.z * rows_per_split;
  const int nrows = min(K, kb + rows_per_split) - kb;
  for (int i = tid; i < cnt * nrows; i += NTHREADS) {
    const int m = i / nrows, kk = i - m * nrows;
    xs[m * nrows + kk] = x[(size_t)tok[m] * K + kb + kk];
  }

  const int cg = tid % NCG, ks = tid / NCG;
  const int n0 = blockIdx.x * NT + cg * 8;
  const bool live_cols = n0 < N;
  const TW* wr = w + ((size_t)e * K + kb) * N + n0;  // row kb of expert e, column n0
  float sc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float s = 1.0f;
    if (scale != nullptr && n0 + j < N) {
      s = __ldg(scale + (size_t)e * N + n0 + j);
      if (std::is_same<TX, __nv_bfloat16>::value) s = bf16r(s);
    }
    sc[j] = s;
  }

  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.0f;

  // the first group of rows is in flight while x lands in shared memory
  R cur[G], nxt[G];
  if (live_cols) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const int k = ks + r * NKS;
      if (k < nrows) cur[r].load(wr + (size_t)k * N, n0, N);
    }
  }
  __syncthreads();
  if (live_cols) {
    for (int kk = ks; kk < nrows; kk += NKS * G) {
      // the next group's loads go out before this group is used
      const int kn = kk + NKS * G;
#pragma unroll
      for (int r = 0; r < G; ++r) {
        const int k = kn + r * NKS;
        if (k < nrows) nxt[r].load(wr + (size_t)k * N, n0, N);
      }
#pragma unroll
      for (int r = 0; r < G; ++r) {
        const int k = kk + r * NKS;
        if (k < nrows) {
          float wv[8];
          cur[r].get(wv);
          if constexpr (std::is_same<TW, int8_t>::value) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              // sc holds the scale already rounded through TX
              const float v = wv[j] * sc[j];
              wv[j] = std::is_same<TX, __nv_bfloat16>::value ? bf16r(v) : v;
            }
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m < cnt) {
              const float xv = to_f(xs[m * nrows + k]);
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xv, wv[j], acc[m][j]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < G; ++r) cur[r] = nxt[r];
    }
  }
  __syncthreads();  // x is read; its shared memory takes the fold

  // fold the 4 K slices of a warp (lanes cg, cg + 8, cg + 16, cg + 24),
  // then the 8 warps in order
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  if (lane < NCG) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if (m < cnt)
#pragma unroll
        for (int j = 0; j < 8; ++j) red[(wid * MT + m) * NT + cg * 8 + j] = acc[m][j];
  }
  __syncthreads();
  for (int o = tid; o < cnt * NT; o += NTHREADS) {
    const int m = o / NT, col = o % NT;
    const int n = blockIdx.x * NT + col;
    if (n >= N) continue;
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < NWARPS; ++i) s += red[(i * MT + m) * NT + col];
    if (part != nullptr)
      part[((size_t)blockIdx.z * T + tok[m]) * N + n] = s;
    else
      out[(size_t)tok[m] * N + n] = from_f<TO>(s);
  }
}

// y = the splits' partials added in split order
template <typename TO>
__global__ void expert_matmul_combine_kernel(const float* __restrict__ part,
                                             TO* __restrict__ out, long long TN, int S) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < TN;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int z = 0; z < S; ++z) s += part[z * TN + i];
    out[i] = from_f<TO>(s);
  }
}

// -- the tensor-core path: bf16 x --------------------------------------------
//
// A block of 4 warps takes 64 columns of a run of up to 16 x MTI tokens:
// each step the block copies the run's x (cp.async) and 64 K rows of the
// weight into double-buffered swizzled shared tiles, an int8 weight dequantised
// on the way (the reference's bf16(bf16(q) * bf16(scale)), two values a
// rounding: the product is exact in fp32), and each warp runs
// mma.sync.m16n8k16 (bf16 in, fp32 sums) for its 16 columns over the
// token tiles that hold tokens.  The next step's weight rows are in
// registers, and its x rows in flight, while this step's products run (a
// second step ahead, in a second register set, gained little at decode
// and lost more at prefill to the registers it takes).

constexpr int MM_THREADS = 128;
constexpr int MM_KS = 64;       // K rows a step
constexpr int MM_CH = 8;        // 16-byte chunks of a 64-wide bf16 tile row

template <typename TW> struct MmRows;  // a thread's weight segments a step
template <> struct MmRows<int8_t> {
  // 64 rows x 64 int8 columns = 256 segments of 16 columns: 2 a thread
  static constexpr int SEG = 2;
  uint4 v[SEG];
};
template <> struct MmRows<__nv_bfloat16> {
  // 64 rows x 64 bf16 columns = 512 segments of 8 columns: 4 a thread
  static constexpr int SEG = 4;
  uint4 v[SEG];
};

template <typename TW>
__device__ __forceinline__ void mm_load_w(MmRows<TW>& r, const TW* __restrict__ w, int k0,
                                          int nrows, int n0, int N) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < MmRows<TW>::SEG; ++i) {
    const int seg = tid + i * MM_THREADS;
    int row, col;
    if constexpr (std::is_same<TW, int8_t>::value) {
      row = seg >> 2, col = (seg & 3) * 16;
    } else {
      row = seg >> 3, col = (seg & 7) * 8;
    }
    const bool ok = k0 + row < nrows && n0 + col < N;
    r.v[i] = ok ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)(k0 + row) * N + n0 + col))
                : make_uint4(0u, 0u, 0u, 0u);
  }
}

// the step's weight rows into the shared tile (k along rows, n along
// chunks), an int8 row dequantised with the thread's 16 column scales
template <typename TW>
__device__ __forceinline__ void mm_store_w(egs::bf16* ws, const MmRows<TW>& r,
                                           const float (&sc)[16]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < MmRows<TW>::SEG; ++i) {
    const int seg = tid + i * MM_THREADS;
    if constexpr (std::is_same<TW, int8_t>::value) {
      const int row = seg >> 2, c0 = (seg & 3) * 2;
      const int8_t* q = reinterpret_cast<const int8_t*>(&r.v[i]);
      uint4 lo, hi;
      uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
      uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        l[j] = egs::pack_bf16((float)q[2 * j] * sc[2 * j], (float)q[2 * j + 1] * sc[2 * j + 1]);
        h[j] = egs::pack_bf16((float)q[8 + 2 * j] * sc[8 + 2 * j],
                              (float)q[9 + 2 * j] * sc[9 + 2 * j]);
      }
      *reinterpret_cast<uint4*>(ws + egs::tile_off<MM_CH>(row, c0)) = lo;
      *reinterpret_cast<uint4*>(ws + egs::tile_off<MM_CH>(row, c0 + 1)) = hi;
    } else {
      const int row = seg >> 3, c = seg & 7;
      *reinterpret_cast<uint4*>(ws + egs::tile_off<MM_CH>(row, c)) = r.v[i];
    }
  }
}

// the step's x rows (the block's tokens, K rows k0.. of its range) by
// cp.async; rows past the tokens, or past the range, are zeros
template <int MTI>
__device__ __forceinline__ void mm_copy_x(egs::bf16* xs, const egs::bf16* __restrict__ x,
                                          const int* tok, int cnt, int K, int kb, int k0,
                                          int nrows) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < MTI * 16 * MM_CH / MM_THREADS; ++i) {
    const int idx = tid + i * MM_THREADS;
    const int r = idx >> 3, c = idx & 7;
    const bool ok = r < cnt && k0 + c * 8 < nrows;
    const egs::bf16* src = ok ? x + (size_t)tok[r] * K + kb + k0 + c * 8 : x;
    egs::cp_async16(xs + egs::tile_off<MM_CH>(r, c), src, ok);
  }
  egs::cp_async_commit();
}

// MTI: m16 token tiles a block (1 where an expert's tokens come in
// units, at decode; 4 where they come in tens)
template <typename TW, typename TO, int MTI>
__global__ void __launch_bounds__(MM_THREADS)
expert_matmul_mma_kernel(const egs::bf16* __restrict__ x, const TW* __restrict__ w,
                         const float* __restrict__ scale, const int* __restrict__ ids,
                         TO* __restrict__ out, float* __restrict__ part, int T, int K, int N,
                         int chunks, int rows_per_split) {
  constexpr int TOK = MTI * 16;
  __shared__ int tok[TOK];
  __shared__ int warp_cnt[MM_THREADS / 32];
  __shared__ __align__(128) egs::bf16 xs[2][TOK * MM_KS];
  __shared__ __align__(128) egs::bf16 ws[2][MM_KS * 64];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e = blockIdx.y / chunks, c = blockIdx.y % chunks;
  const int cnt = find_tokens<TOK, MM_THREADS>(ids, T, e, c * TOK, tok, warp_cnt);
  if (cnt <= 0) return;  // uniform across the block
  const int mtiles = (cnt + 15) / 16;
  const int n0 = blockIdx.x * 64;
  const int kb = blockIdx.z * rows_per_split;
  const int nrows = min(K, kb + rows_per_split) - kb;
  const TW* we = w + ((size_t)e * K + kb) * N;

  // this thread's 16 column scales, rounded through bf16 (int8 only)
  float sc[16];
  if constexpr (std::is_same<TW, int8_t>::value) {
    const int col0 = (tid & 3) * 16;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + col0 + j;
      sc[j] = n < N ? bf16r(__ldg(scale + (size_t)e * N + n)) : 0.0f;
    }
  }

  float acc[MTI][2][4];
#pragma unroll
  for (int mi = 0; mi < MTI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.0f;

  const int steps = (nrows + MM_KS - 1) / MM_KS;
  MmRows<TW> rows;
  mm_load_w<TW>(rows, we, 0, nrows, n0, N);
  mm_copy_x<MTI>(xs[0], x, tok, cnt, K, kb, 0, nrows);
  mm_store_w<TW>(ws[0], rows, sc);
  egs::cp_async_wait<0>();
  __syncthreads();
  for (int st = 0; st < steps; ++st) {
    const int buf = st & 1;
    const bool more = st + 1 < steps;
    if (more) {
      mm_load_w<TW>(rows, we, (st + 1) * MM_KS, nrows, n0, N);
      mm_copy_x<MTI>(xs[buf ^ 1], x, tok, cnt, K, kb, (st + 1) * MM_KS, nrows);
    }
#pragma unroll
    for (int kk = 0; kk < MM_KS / 16; ++kk) {
      uint32_t b[4];
      egs::load_b_trans<MM_CH>(b, ws[buf], kk * 16, 2 * warp, lane);
#pragma unroll
      for (int mi = 0; mi < MTI; ++mi) {
        if (mi < mtiles) {
          uint32_t a[4];
          egs::load_a<MM_CH>(a, xs[buf], mi * 16, kk, lane);
          egs::mma16816(acc[mi][0], a, b[0], b[1]);
          egs::mma16816(acc[mi][1], a, b[2], b[3]);
        }
      }
    }
    if (more) {
      mm_store_w<TW>(ws[buf ^ 1], rows, sc);
      egs::cp_async_wait<0>();
    }
    __syncthreads();
  }

  // C tile (mi, ni): rows mi*16 + g (+8), columns n0 + (2 warp + ni) * 8 + 2t (+1)
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MTI; ++mi) {
    if (mi >= mtiles) continue;
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const int n = n0 + (2 * warp + ni) * 8 + 2 * t;
      if (n >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mi * 16 + g + 8 * h;
        if (r >= cnt) continue;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (part != nullptr) {
          *reinterpret_cast<float2*>(part + ((size_t)blockIdx.z * T + tok[r]) * N + n) =
              make_float2(v0, v1);
        } else if constexpr (std::is_same<TO, float>::value) {
          *reinterpret_cast<float2*>(out + (size_t)tok[r] * N + n) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<uint32_t*>(out + (size_t)tok[r] * N + n) = egs::pack_bf16(v0, v1);
        }
      }
    }
  }
}

// The plan of a call, stated once and from the shapes only: the kernel
// (tensor cores for bf16 x on aligned rows, CUDA cores for float32 x and
// odd shapes), token runs a block, and the K split.  K is split so
// that the grid's blocks that can hold tokens reach TARGET_BLOCKS, each
// split at least 256 rows, and (CUDA cores) at most the rows a block
// stages.
struct Plan {
  bool mma;
  int mti;     // m16 token tiles a block (tensor cores)
  int chunks;  // token runs an expert
  int rows;    // K rows a split
  int splits;
};

Plan make_plan(int T, int K, int N, int E, bool dense, int dtype, bool aligned) {
  Plan p;
  p.mma = dtype == 1 && aligned && N % 16 == 0 && K % 8 == 0;
  p.mti = T <= 16 * (dense ? 1 : E) ? 1 : 4;
  p.chunks = ceil_div(T, p.mma ? 16 * p.mti : MT);
  const int tiles = ceil_div(N, NT);
  const int used = T < E ? T : E;  // experts at most some token chose
  const int live = tiles * (dense || p.chunks > used ? p.chunks : used);
  int s = ceil_div(TARGET_BLOCKS, live > 0 ? live : 1);
  const int cap = K / 256 > 1 ? K / 256 : 1;
  if (s > cap) s = cap;
  const int x_bytes = dtype == 1 ? 2 : 4;
  if (!p.mma && s < ceil_div(K, max_rows(x_bytes))) s = ceil_div(K, max_rows(x_bytes));
  const int unit = p.mma ? MM_KS : 32;
  p.rows = ceil_div(ceil_div(K, s), unit) * unit;
  p.splits = ceil_div(K, p.rows);
  return p;
}

template <typename TX, typename TW, typename TO>
int launch(const void* x, const void* w, const void* scale, const void* ids, void* out,
           void* part, int T, int K, int N, int E, bool aligned, cudaStream_t stream) {
  const bool dense = ids == nullptr;
  const Plan pl = make_plan(T, K, N, E, dense, std::is_same<TX, float>::value ? 0 : 1, aligned);
  const long long gy = (long long)(dense ? 1 : E) * pl.chunks;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  if (pl.splits > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid(ceil_div(N, NT), (unsigned)gy, pl.splits);
  float* p = pl.splits > 1 ? static_cast<float*>(part) : nullptr;
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  const float* sp = static_cast<const float*>(scale);
  const int* ip = static_cast<const int*>(ids);
  TO* op = static_cast<TO*>(out);
  if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
    if (pl.mma && pl.mti == 1)
      expert_matmul_mma_kernel<TW, TO, 1><<<grid, MM_THREADS, 0, stream>>>(
          xp, wp, sp, ip, op, p, T, K, N, pl.chunks, pl.rows);
    else if (pl.mma)
      expert_matmul_mma_kernel<TW, TO, 4><<<grid, MM_THREADS, 0, stream>>>(
          xp, wp, sp, ip, op, p, T, K, N, pl.chunks, pl.rows);
  }
  if (!pl.mma) {
    if (N % 8 == 0 && aligned)
      expert_matmul_kernel<TX, TW, TO, true><<<grid, NTHREADS, 0, stream>>>(
          xp, wp, sp, ip, op, p, T, K, N, pl.chunks, pl.rows);
    else
      expert_matmul_kernel<TX, TW, TO, false><<<grid, NTHREADS, 0, stream>>>(
          xp, wp, sp, ip, op, p, T, K, N, pl.chunks, pl.rows);
  }
  if (pl.splits > 1) {
    const long long TN = (long long)T * N;
    const int blocks = (int)((TN + 255) / 256 < 4 * 132 ? (TN + 255) / 256 : 4 * 132);
    expert_matmul_combine_kernel<TO><<<blocks, 256, 0, stream>>>(p, static_cast<TO*>(out), TN,
                                                                 pl.splits);
  }
  return (int)cudaGetLastError();
}

template <typename TX, typename TW>
int launch_out(int out_f32, const void* x, const void* w, const void* scale, const void* ids,
               void* out, void* part, int T, int K, int N, int E, bool aligned,
               cudaStream_t s) {
  if (out_f32)
    return launch<TX, TW, float>(x, w, scale, ids, out, part, T, K, N, E, aligned, s);
  return launch<TX, TW, TX>(x, w, scale, ids, out, part, T, K, N, E, aligned, s);
}

}  // namespace

// fp32 words of scratch the call needs for its K splits' partials (0 with
// one split); the wrapper allocates them.  dense: no ids (E = 1); dtype:
// x's (0 = float32, 1 = bfloat16); aligned: x and w start on 16 bytes.
extern "C" long long egs_expert_matmul_workspace(int T, int K, int N, int E, int dense,
                                                int dtype, int aligned) {
  if (T <= 0 || K <= 0 || N <= 0 || E <= 0) return 0;
  const Plan p = make_plan(T, K, N, E, dense != 0, dtype, aligned != 0);
  return p.splits > 1 ? (long long)p.splits * T * N : 0;
}

// The plan of a call: K splits (1: no combine kernel runs) times 2 when
// the tensor-core kernel runs.
extern "C" int egs_expert_matmul_plan(int T, int K, int N, int E, int dense, int dtype,
                                      int aligned) {
  if (T <= 0 || K <= 0 || N <= 0 || E <= 0) return 2;
  const Plan p = make_plan(T, K, N, E, dense != 0, dtype, aligned != 0);
  return p.splits * 2 + (p.mma ? 1 : 0);
}

// x (T, K) in the compute dtype (0 = float32, 1 = bfloat16); w (E, K, N)
// in that dtype, or int8 (w_int8 = 1) with scale (E, N) fp32; ids (T,)
// int32 in [0, E), or null (every token on expert 0); out (T, N) in the
// compute dtype, or fp32 (out_f32 = 1); part: egs_expert_matmul_workspace
// fp32 words (null when 0).  All contiguous; aligned as the wrapper found
// them (checked).  Returns cudaGetLastError().
extern "C" int egs_expert_matmul(const void* x, const void* w, const void* scale,
                                 const void* ids, void* out, void* part, int T, int K, int N,
                                 int E, int dtype, int w_int8, int out_f32, int aligned,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0 || K <= 0 || N <= 0 || E <= 0) return (int)cudaErrorInvalidValue;
  if (w_int8 && scale == nullptr) return (int)cudaErrorInvalidValue;
  if (aligned && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16))
    return (int)cudaErrorMisalignedAddress;
  const bool al = aligned != 0;
  if (dtype == 1) {
    if (w_int8)
      return launch_out<__nv_bfloat16, int8_t>(out_f32, x, w, scale, ids, out, part, T, K, N,
                                               E, al, s);
    return launch_out<__nv_bfloat16, __nv_bfloat16>(out_f32, x, w, nullptr, ids, out, part, T,
                                                    K, N, E, al, s);
  }
  if (dtype == 0) {
    if (w_int8)
      return launch_out<float, int8_t>(out_f32, x, w, scale, ids, out, part, T, K, N, E, al, s);
    return launch_out<float, float>(out_f32, x, w, nullptr, ids, out, part, T, K, N, E, al, s);
  }
  return (int)cudaErrorInvalidValue;
}
