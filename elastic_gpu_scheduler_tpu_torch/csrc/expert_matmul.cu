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
// Dequantisation gives the reference's values bit for bit:
//   bf16:  bf16(float(q) * float(bf16(scale)))   (q and the scale as bf16,
//          their product rounded to bf16 once: mul.rn.bf16x2);
//   fp32:  float(q) * scale.
//
// What bounds it on this card: weight bytes at decode size (a few tokens
// an expert, ~2 FLOPs a weight byte, far below the ridge), and at prefill
// size weight bytes (MoE, 64 tokens an expert) or operations (a dense
// int8 product at T 512).  Weight bytes run at the memory's rate only with
// ~32 KB in flight on every SM (3.35 TB/s at ~1 us of latency).  The
// design, for bf16 x (every bf16 model's product):
//   - decode runs, an expert averaging <= 16 tokens (the int8 dense
//     projections, MoE decode, MoE + int8 decode): expert_matmul_ring_kernel.
//     One producer warp keeps a ring of 4 stages of raw weight tiles in
//     flight with TMA (64 K rows x 128 bytes, 8 KB a stage: 128 int8 or 64
//     bf16 columns; mbarriers), so a block alone has 32 KB of weight bytes
//     in flight.  int8 stays int8 in shared memory.  The block's x rows (a
//     run of 8 tokens, or 16 where an expert averages more than 8, over its
//     K range) are staged once.  Four consumer warps take the products with
//     mma.sync.m16n8k16 with A and B swapped: W^T is the m16 side,
//     dequantised from shared memory into A fragments in registers, and the
//     tokens the n8 side, so 8 decode tokens fill the instruction.  The K
//     index within an instruction is permuted (slots 2t, 2t+1, 8+2t, 9+2t of
//     thread t hold K rows 4t..4t+3) so that each thread reads 4 whole rows
//     of 8 columns and one 8-byte x word a k-step.  A warp releases a stage
//     after a proxy fence: its reads are generic, the next TMA write into the
//     stage is not, and without the fence that write can land first;
//   - K split without a combine pass: when the tiles alone give fewer blocks
//     than SMs (a few tokens over a narrow N), or K passes 2048 rows, the K
//     splits of one output tile form a thread-block cluster (at most 8, the
//     portable size).  Each block folds its warps' partials in shared
//     memory; then each adds a share of the tile over the cluster's partials
//     read from distributed shared memory (16 bytes a read), in split order,
//     and writes y.  One launch, no fp32 partial in device memory; an
//     unsplit call is launched without a cluster and skips this step;
//   - grouped runs, an expert averaging more than 16 tokens (MoE prefill,
//     int8 dense prefill): expert_matmul_wgmma_kernel.  The same producer
//     warp and ring bring 64 K rows x 128 columns a stage: bf16 by two TMA
//     boxes straight into the 128-byte-swizzled layout wgmma reads B from,
//     int8 as raw bytes that the consumers dequantise into such a tile (the
//     next stage's while the current products run).  Two consumer
//     warpgroups take runs of 128 tokens (64 rows each) with
//     wgmma.m64n128k16, A (x) in registers, loaded by ldmatrix from each
//     warp's own cp.async ring of its 16 token rows;
//   - float32 x, or a shape the tiles do not take (N not a multiple of 16,
//     K not a multiple of 8, unaligned rows, K over 8 x 2048), takes CUDA
//     cores, expert_matmul_kernel: fp32 FMAs (exact products, as float32
//     models need), runs of 8 tokens staged in shared memory, 8 columns x
//     32 K slices of threads, each keeping 64 bytes of weight rows in
//     flight, the slices folded by shuffles and then by warp in a fixed
//     order; its K splits write fp32 partials that
//     expert_matmul_combine_kernel adds in order.
// A block finds its expert's tokens itself: it scans `ids` in order
// (ballots and a block prefix) for its run of them (find_tokens).  A token
// whose id lies outside [0, E) (another rank's expert, on an expert mesh)
// gets a zero row: the grid holds one more expert's worth of runs, whose
// blocks find such tokens and write their rows' columns (or, split over K
// on CUDA cores, their partials) as zeros, as the plain version does.  Nothing
// is read on the host, so a captured CUDA graph replays it for any
// routing; a block whose expert has no token in its run (and so its whole
// cluster) exits after the scan, so an expert no token chose costs no
// weight read (one scan of the ids a block: 8 to 512 ids, next to a
// weight stream of 0.2 to 28 MB).  The plan (route, runs, splits, cluster) comes from the
// shapes only (make_plan, egs_expert_matmul_plan).  The weight's tensor map
// is encoded on the host at every call and passed by value
// (__grid_constant__), so a captured graph keeps it.  No atomics, every sum
// in a fixed order: bitwise repeatable, and a token's row never depends on
// which other tokens share the call.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "warp_mma.cuh"
#include "warpgroup.cuh"

namespace {

constexpr int NT = 64;          // output columns a block
constexpr int MT = 8;           // tokens a block
constexpr int NTHREADS = 256;
constexpr int NCG = NT / 8;     // column groups (8 columns a thread)
constexpr int NKS = NTHREADS / NCG;  // K slices: 32
constexpr int NWARPS = NTHREADS / 32;
constexpr int SMEM = 32768;     // x rows staged, then the fold's partials
constexpr int TARGET_BLOCKS = 2 * 132;  // two blocks an SM of an H100 (CUDA cores)

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
// expert e (every token when ids is null; e == E: those whose id lies
// outside [0, E)), in token order, into tok.  Returns their count
// (uniform across the block; <= 0: nothing to do).
template <int MTOK, int NTH>
__device__ __forceinline__ int find_tokens(const int* __restrict__ ids, int T, int e, int E,
                                           int first, int* tok, int* warp_cnt) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  int cnt;
  if (ids == nullptr) {
    for (int i = tid; i < MTOK; i += NTH) tok[i] = first + i;
    cnt = min(MTOK, T - first);
  } else {
    int base = 0;
    for (int t0 = 0; t0 < T && base < first + MTOK; t0 += NTH) {
      const int t = t0 + tid;
      const int id = t < T ? __ldg(ids + t) : -1;
      const bool f = t < T && (e < E ? id == e : (unsigned)id >= (unsigned)E);
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

// The foreign tokens' rows, columns [n0, n0 + BN) of them, as zeros.
template <typename TO, int BN>
__device__ __forceinline__ void zero_rows(TO* __restrict__ out, const int* tok, int cnt, int n0,
                                          int N) {
  for (int o = threadIdx.x; o < cnt * BN; o += blockDim.x) {
    const int n = n0 + o % BN;
    if (n < N) out[(size_t)tok[o / BN] * N + n] = from_f<TO>(0.0f);
  }
}

template <typename TX, typename TW, typename TO, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
expert_matmul_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                     const float* __restrict__ scale, const int* __restrict__ ids,
                     TO* __restrict__ out, float* __restrict__ part, int T, int K, int N,
                     int E, int chunks, int rows_per_split) {
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

  const int cnt = find_tokens<MT, NTHREADS>(ids, T, e, E, first, tok, warp_cnt);
  if (cnt <= 0) return;  // uniform across the block
  if (e == E) {  // foreign ids: zero rows, or this split's zero partials
    if (part != nullptr)
      zero_rows<float, NT>(part + (size_t)blockIdx.z * T * N, tok, cnt, blockIdx.x * NT, N);
    else
      zero_rows<TO, NT>(out, tok, cnt, blockIdx.x * NT, N);
    return;
  }

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

// -- Hopper pieces: clusters, proxies, int8 to bf16 -----------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster; orders shared-memory writes
// before it with reads after it, across the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// a shared-memory address of this block as block `rank` of the cluster
// holds it, and an fp32 read of it there
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// barrier 1 over the n consumer threads (the producer warp never joins)
__device__ __forceinline__ void consumers_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Four int8 values biased to unsigned (the word ^ 0x80808080); value J as
// an exact fp32: its byte as the low mantissa byte of 2^23, minus 2^23 + 128
template <int J>
__device__ __forceinline__ float q8f(uint32_t biased) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 | J)) - 8388736.0f;
}

// (lo, hi) as a bf16 pair, for fp32 values that bf16 holds exactly (|q|
// <= 128): the high halves of their bits
__device__ __forceinline__ uint32_t bf16_pair_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// a * b in bf16, each product rounded once to nearest even
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf16_bits(float s) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(s));
}

template <typename TO>
__device__ __forceinline__ void store_pair(TO* p, float a, float b) {
  if constexpr (std::is_same<TO, float>::value) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    *reinterpret_cast<uint32_t*>(p) = egs::pack_bf16(a, b);
  }
}

// columns 4q % BN .. + 3 of token tok[4q / BN] of the tile at n0 (N a
// multiple of 16: four columns are all in or all out)
template <typename TO>
__device__ __forceinline__ void store4(TO* __restrict__ out, const int* tok, float4 v, int q,
                                       int BN, int n0, int N) {
  const int o = 4 * q, n = n0 + o % BN;
  if (n >= N) return;
  TO* p = out + (size_t)tok[o / BN] * N + n;
  if constexpr (std::is_same<TO, float>::value) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(egs::pack_bf16(v.x, v.y), egs::pack_bf16(v.z, v.w));
  }
}

// -- decode runs: the TMA weight ring, swapped mma.sync, split K in a cluster ---

namespace ring {
constexpr int ROWS = 64;         // K rows a stage
constexpr int NS = 4;            // stages in the ring: 32 KB in flight a block
constexpr int TOK = 16;          // tokens a run at most: two n8 tiles
constexpr int CONSUMERS = 128;   // four consumer warps
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int MAX_ROWS = 2048;   // K rows a split: x staged once, <= 66 KB
constexpr int SPLIT_ROWS = 1024; // K rows a split at most past MAX_ROWS: a long K
                                 // over a narrow N needs more blocks
constexpr int TARGET = 66;       // blocks that can hold tokens, the split aims at:
                                 // half the SMs (timed on an H100: fewer splits
                                 // leave too few SMs streaming, more cost more in
                                 // the cluster than they gain)
constexpr int XPAD = 16;         // bf16 padding an x row (32 bytes: no conflicts)

// columns a block (128 bytes a stage row), and the consumer warps' layout
template <typename TW> struct Tile {
  static constexpr int BN = std::is_same<TW, int8_t>::value ? 128 : 64;
  static constexpr int STAGE = ROWS * BN * (int)sizeof(TW);  // 8 KB
  static constexpr int WC = BN / 64;                // warps across the columns (64 each)
  static constexpr int WK = CONSUMERS / 32 / WC;    // and across a stage's k16 steps
  static constexpr int KPW = ROWS / 16 / WK;        // k16 steps a warp takes of a stage
  static_assert(WK * KPW * 16 == ROWS, "the warps split a stage's k16 steps evenly");
  // after the loop the ring holds the warps' fp32 partials, [WK][TOK][BN],
  // and then in their first slice the block's sums
  static_assert(WK * TOK * BN * 4 <= NS * STAGE, "the partials fit the ring");
};

template <typename TW>
inline size_t smem_bytes(int rows, int tok) {
  return 1024 + (size_t)NS * Tile<TW>::STAGE + (size_t)tok * (rows + XPAD) * 2 + 16 * NS;
}
}  // namespace ring

// NT8: n8 tiles of tokens a run (runs of 8 or 16 tokens)
template <typename TW, typename TO, int NT8>
__global__ void __launch_bounds__(ring::THREADS)
expert_matmul_ring_kernel(const __grid_constant__ CUtensorMap tm_w, const egs::bf16* __restrict__ x,
                          const float* __restrict__ scale, const int* __restrict__ ids,
                          TO* __restrict__ out, int T, int K, int N, int E, int chunks,
                          int rows_per_split) {
  using namespace ring;
  constexpr bool INT8 = std::is_same<TW, int8_t>::value;
  constexpr int BN = Tile<TW>::BN, WC = Tile<TW>::WC, WK = Tile<TW>::WK;
  constexpr int KPW = Tile<TW>::KPW, STAGE = Tile<TW>::STAGE;
  constexpr int RT = 8 * NT8;  // tokens a run
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int xstride = rows_per_split + XPAD;
  egs::bf16* xs = reinterpret_cast<egs::bf16*>(smem + NS * STAGE);  // [RT][xstride]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + NS * STAGE + RT * xstride * 2);
  uint64_t* empty = full + NS;
  __shared__ int tok[RT];
  __shared__ int warp_cnt[THREADS / 32];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      egs::mbar_init(&full[s], 1);
      egs::mbar_init(&empty[s], CONSUMERS / 32);
    }
    egs::mbar_fence_init();
  }
  __syncthreads();
  const int e = blockIdx.y / chunks, c = blockIdx.y % chunks;
  const int cnt = find_tokens<RT, THREADS>(ids, T, e, E, c * RT, tok, warp_cnt);
  if (cnt <= 0) return;  // uniform across the block and its cluster
  if (e == E) {  // foreign ids: zero rows, by the first split (no cluster sync)
    if (blockIdx.z == 0) zero_rows<TO, BN>(out, tok, cnt, blockIdx.x * BN, N);
    return;
  }

  const int n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * rows_per_split;
  const int steps = ceil_div(min(K, kb + rows_per_split) - kb, ROWS);

  if (warp == CONSUMERS / 32) {  // the producer: one thread issues every copy
    if (lane == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % NS;
        if (i >= NS) egs::mbar_wait(&empty[s], ((i / NS) & 1) ^ 1);
        egs::mbar_expect_tx(&full[s], STAGE);
        egs::tma_load_3d(smem + s * STAGE, &tm_w, &full[s], n0, kb + i * ROWS, e);
      }
    }
    __syncwarp();
  } else {
    // the run's x rows over the split's K range, once (zeros past K)
    const int ch = rows_per_split / 8;
    for (int i = tid; i < cnt * ch; i += CONSUMERS) {
      const int m = i / ch, cc = i - m * ch;
      const int k = kb + cc * 8;
      const bool ok = k < K;
      egs::cp_async16(xs + m * xstride + cc * 8, ok ? x + (size_t)tok[m] * K + k : x, ok);
    }
    egs::cp_async_commit();

    const int wc = warp % WC, wk = warp / WC;
    const int g = lane >> 2, t = lane & 3;
    const int col0 = wc * 64 + 8 * g;  // the thread's 8 columns of the tile
    // int8: their scales through bf16, each as a (s, s) pair
    uint32_t sp[8];
    if constexpr (INT8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + col0 + j;
        const uint32_t b = bf16_bits(n < N ? __ldg(scale + (size_t)e * N + n) : 0.0f);
        sp[j] = b | (b << 16);
      }
    }
    const bool two = NT8 == 2 && cnt > 8;  // the second n8 tile of tokens holds some
    float acc[4][2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
    egs::cp_async_wait<0>();
    consumers_sync(CONSUMERS);

    for (int i = 0; i < steps; ++i) {
      const int s = i % NS;
      egs::mbar_wait(&full[s], (i / NS) & 1);
      const unsigned char* st = smem + s * STAGE;
#pragma unroll
      for (int j = 0; j < KPW; ++j) {
        const int r0 = (wk + j * WK) * 16 + 4 * t;  // the thread's 4 rows of the stage
        // A fragments of 4 m16 tiles: tile i's row g is column col0 + 2i,
        // its row g + 8 column col0 + 2i + 1; K slots (2t, 2t+1) are rows
        // r0, r0 + 1 and slots (8+2t, 9+2t) rows r0 + 2, r0 + 3
        uint32_t a[4][4];
        if constexpr (INT8) {
          float f[4][8];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const uint2 raw = *reinterpret_cast<const uint2*>(st + (r0 + r) * BN + col0);
            const uint32_t lo = raw.x ^ 0x80808080u, hi = raw.y ^ 0x80808080u;
            f[r][0] = q8f<0>(lo);
            f[r][1] = q8f<1>(lo);
            f[r][2] = q8f<2>(lo);
            f[r][3] = q8f<3>(lo);
            f[r][4] = q8f<0>(hi);
            f[r][5] = q8f<1>(hi);
            f[r][6] = q8f<2>(hi);
            f[r][7] = q8f<3>(hi);
          }
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            a[m][0] = bf16x2_mul(bf16_pair_exact(f[0][2 * m], f[1][2 * m]), sp[2 * m]);
            a[m][1] = bf16x2_mul(bf16_pair_exact(f[0][2 * m + 1], f[1][2 * m + 1]), sp[2 * m + 1]);
            a[m][2] = bf16x2_mul(bf16_pair_exact(f[2][2 * m], f[3][2 * m]), sp[2 * m]);
            a[m][3] = bf16x2_mul(bf16_pair_exact(f[2][2 * m + 1], f[3][2 * m + 1]), sp[2 * m + 1]);
          }
        } else {
          uint4 raw[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            raw[r] = *reinterpret_cast<const uint4*>(st + (r0 + r) * BN * 2 + col0 * 2);
          const uint32_t* w0 = reinterpret_cast<const uint32_t*>(&raw[0]);
          const uint32_t* w1 = reinterpret_cast<const uint32_t*>(&raw[1]);
          const uint32_t* w2 = reinterpret_cast<const uint32_t*>(&raw[2]);
          const uint32_t* w3 = reinterpret_cast<const uint32_t*>(&raw[3]);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            a[m][0] = __byte_perm(w0[m], w1[m], 0x5410);
            a[m][1] = __byte_perm(w0[m], w1[m], 0x7632);
            a[m][2] = __byte_perm(w2[m], w3[m], 0x5410);
            a[m][3] = __byte_perm(w2[m], w3[m], 0x7632);
          }
        }
        // B fragments: token g (and 8 + g), K rows r0 .. r0 + 3: one 8-byte word
        const int kx = i * ROWS + r0;
        const uint2 b0 = *reinterpret_cast<const uint2*>(xs + g * xstride + kx);
#pragma unroll
        for (int m = 0; m < 4; ++m) egs::mma16816(acc[m][0], a[m], b0.x, b0.y);
        if (two) {
          const uint2 b1 = *reinterpret_cast<const uint2*>(xs + (8 + g) * xstride + kx);
#pragma unroll
          for (int m = 0; m < 4; ++m) egs::mma16816(acc[m][1], a[m], b1.x, b1.y);
        }
      }
      // the stage's reads (generic proxy) are ordered before the next TMA
      // write into it (async proxy): without the fence, the write can land
      // first on a busy card
      fence_async_shared();
      __syncwarp();
      if (lane == 0) egs::mbar_arrive(&empty[s]);  // this warp is done with stage s
    }

    // the warps' partials into the ring's memory (every stage is consumed),
    // [wk][token][column]; C (m, n): column col0 + 2i (+1 for m >= 8), token n
    consumers_sync(CONSUMERS);
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      if (nt == 1 && !two) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tk = nt * 8 + 2 * t + h;
        float4* p = reinterpret_cast<float4*>(red + (wk * TOK + tk) * BN + col0);
        p[0] = make_float4(acc[0][nt][h], acc[0][nt][2 + h], acc[1][nt][h], acc[1][nt][2 + h]);
        p[1] = make_float4(acc[2][nt][h], acc[2][nt][2 + h], acc[3][nt][h], acc[3][nt][2 + h]);
      }
    }
    consumers_sync(CONSUMERS);
    // the warps' partials added in order, 4 columns a thread: y when K is
    // not split, else the block's sums, kept in the first slice
    float4* red4 = reinterpret_cast<float4*>(red);
    for (int q = tid; q < cnt * BN / 4; q += CONSUMERS) {
      float4 v = red4[q];
#pragma unroll
      for (int z = 1; z < WK; ++z) v = add4(v, red4[z * TOK * BN / 4 + q]);
      if (gridDim.z == 1)
        store4<TO>(out, tok, v, q, BN, n0, N);
      else
        red4[q] = v;
    }
  }
  if (gridDim.z == 1) return;  // one split: no cluster

  // the cluster is this tile's K splits: each block adds a share of the
  // tile over every split's sums, in split order, 4 columns a thread, and
  // writes it
  cluster_sync();
  const int S = (int)cluster_size(), rank = (int)cluster_rank();
  const int total = cnt * BN / 4;
  const int share = ceil_div(total, S);
  const int q_end = min(total, (rank + 1) * share);
  const uint32_t base = egs::smem_u32(smem);
  for (int q = rank * share + tid; q < q_end; q += THREADS) {
    float4 p[8];
#pragma unroll
    for (int z = 0; z < 8; ++z)  // every load out before the first add
      if (z < S) p[z] = ld_cluster4(cluster_map(base + 16u * q, (uint32_t)z));
    float4 v = p[0];
#pragma unroll
    for (int z = 1; z < 8; ++z)
      if (z < S) v = add4(v, p[z]);
    store4<TO>(out, tok, v, q, BN, n0, N);
  }
  cluster_sync();  // no block leaves while another reads its sums
}

// -- grouped runs: the TMA weight ring feeding wgmma ------------------------------

namespace grp {
constexpr int ROWS = 64;          // K rows a stage
constexpr int BN = 128;           // columns a block
constexpr int TOK = 128;          // tokens a run: two consumer warpgroups of 64
constexpr int NS = 4;             // stages in the weight ring
constexpr int XS = 2;             // stages in each warp's x ring
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr uint32_t HALF = ROWS * 128;    // a 64-column half of a bf16 tile: 8 KB
constexpr uint32_t TILE = 2 * HALF;      // a bf16 weight tile
constexpr int XTILE = 16 * 64;           // a warp's 16 x rows of a stage (bf16 elements)

template <typename TW> struct Stage {
  static constexpr bool INT8 = std::is_same<TW, int8_t>::value;
  static constexpr uint32_t BYTES = INT8 ? 8192 : TILE;  // raw int8, or the bf16 tile
  static constexpr uint32_t DEQ = INT8 ? 2 * TILE : 0;   // two dequantised tiles
  static constexpr size_t SMEM =
      1024 + NS * BYTES + DEQ + (CONSUMERS / 32) * XS * XTILE * 2 + 16 * NS;
};
}  // namespace grp

// A warp's 16 x rows of one stage (a null row: past the run's tokens,
// zeros), 64 K columns from k0, into its swizzled tile by cp.async (one
// group); lane copies rows lane / 8 + 4 j
__device__ __forceinline__ void copy_x_rows(egs::bf16* tile, const egs::bf16* const (&src)[4],
                                            const egs::bf16* any, int k0, int K, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = (lane >> 3) + 4 * j, c = lane & 7;
    const int k = k0 + c * 8;
    const bool ok = src[j] != nullptr && k < K;
    egs::cp_async16(tile + egs::tile_off<8>(r, c), ok ? src[j] + k : any, ok);
  }
  egs::cp_async_commit();
}

template <int N>
__device__ __forceinline__ void fence_regs_u(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(r[i][q])::"memory");
}

// Stage i of the grouped kernel's ring, raw int8 rows, dequantised into a
// 128-byte-swizzled bf16 tile (16-byte chunk c of row r, in its 64-column
// half, at chunk c ^ (r % 8), as TMA writes a bf16 tile), made visible to
// wgmma.  The thread takes rows tid / 8 and 32 + tid / 8, columns dcol ..
// dcol + 15, with their scale pairs sp.
__device__ __forceinline__ void dequantise_stage(const unsigned char* ring, unsigned char* deq,
                                                 uint64_t* full, const uint32_t (&sp)[8],
                                                 int dcol, int tid, int i) {
  const int s = i % grp::NS;
  egs::mbar_wait(&full[s], (i / grp::NS) & 1);
  const unsigned char* raw = ring + s * 8192;
  unsigned char* dq = deq + (i & 1) * grp::TILE;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = (tid >> 3) + 32 * j;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + r * 128 + dcol);
    const uint32_t wv[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                            v.w ^ 0x80808080u};
    uint32_t o[8];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      o[2 * p] = bf16x2_mul(bf16_pair_exact(q8f<0>(wv[p]), q8f<1>(wv[p])), sp[2 * p]);
      o[2 * p + 1] = bf16x2_mul(bf16_pair_exact(q8f<2>(wv[p]), q8f<3>(wv[p])), sp[2 * p + 1]);
    }
    const int c0 = (dcol & 63) >> 3;
    unsigned char* row = dq + (dcol >> 6) * grp::HALF + r * 128;
    *reinterpret_cast<uint4*>(row + ((c0 ^ (r & 7)) << 4)) = make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(row + (((c0 + 1) ^ (r & 7)) << 4)) =
        make_uint4(o[4], o[5], o[6], o[7]);
  }
  fence_async_shared();  // the tile is read by wgmma (the async proxy)
}

template <typename TW, typename TO>
__global__ void __launch_bounds__(grp::THREADS, 1)
expert_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_w,
                           const egs::bf16* __restrict__ x, const float* __restrict__ scale,
                           const int* __restrict__ ids, TO* __restrict__ out, int T, int K,
                           int N, int E, int chunks) {
  using namespace grp;
  constexpr bool INT8 = Stage<TW>::INT8;
  constexpr uint32_t SB = Stage<TW>::BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* deq = smem + NS * SB;  // int8: two dequantised bf16 tiles
  egs::bf16* xring = reinterpret_cast<egs::bf16*>(deq + Stage<TW>::DEQ);
  uint64_t* full = reinterpret_cast<uint64_t*>(xring + (CONSUMERS / 32) * XS * XTILE);
  uint64_t* empty = full + NS;
  __shared__ int tok[TOK];
  __shared__ int warp_cnt[THREADS / 32];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      egs::mbar_init(&full[s], 1);
      egs::mbar_init(&empty[s], INT8 ? 1 : 2);  // int8: after the dequantisation
    }
    egs::mbar_fence_init();
  }
  __syncthreads();
  const int e = blockIdx.y / chunks, c = blockIdx.y % chunks;
  const int cnt = find_tokens<TOK, THREADS>(ids, T, e, E, c * TOK, tok, warp_cnt);
  if (cnt <= 0) return;  // uniform across the block
  if (e == E) {  // foreign ids: zero rows
    zero_rows<TO, BN>(out, tok, cnt, blockIdx.x * BN, N);
    return;
  }
  const int n0 = blockIdx.x * BN;
  const int steps = ceil_div(K, ROWS);

  if (warp == 8) {  // the producer: one thread issues every copy
    if (lane == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % NS;
        if (i >= NS) egs::mbar_wait(&empty[s], ((i / NS) & 1) ^ 1);
        egs::mbar_expect_tx(&full[s], SB);
        if constexpr (INT8) {
          egs::tma_load_3d(smem + s * SB, &tm_w, &full[s], n0, i * ROWS, e);
        } else {
          for (int h = 0; h < 2; ++h)
            egs::tma_load_3d(smem + s * SB + h * HALF, &tm_w, &full[s], n0 + 64 * h, i * ROWS, e);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int wrow = wg * 64 + (warp & 3) * 16;  // the warp's 16 rows of the run
  const bool live = wg * 64 < cnt;             // uniform in the warpgroup
  const egs::bf16* src[4];                     // the x rows this lane copies
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = wrow + (lane >> 3) + 4 * j;
    src[j] = r < cnt ? x + (size_t)tok[r] * K : nullptr;
  }
  egs::bf16* xw = xring + warp * XS * XTILE;  // the warp's x ring
  // int8: the thread dequantises rows tid / 8 and 32 + tid / 8, columns
  // 16 (tid % 8) .. + 15; their scales through bf16, in column pairs
  const int dcol = 16 * (tid & 7);
  uint32_t sp[8];
  if constexpr (INT8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + dcol + 2 * j;
      const float s0 = n < N ? __ldg(scale + (size_t)e * N + n) : 0.0f;
      const float s1 = n + 1 < N ? __ldg(scale + (size_t)e * N + n + 1) : 0.0f;
      sp[j] = bf16_bits(s0) | (bf16_bits(s1) << 16);
    }
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  copy_x_rows(xw, src, x, 0, K, lane);
  if constexpr (INT8) {
    dequantise_stage(smem, deq, full, sp, dcol, tid, 0);
    consumers_sync(CONSUMERS);
    if (tid == 0) egs::mbar_arrive(&empty[0]);
  }
  for (int i = 0; i < steps; ++i) {
    const int s = i % NS;
    // x: the next stage's copy goes out, this stage's is waited for
    if (i + 1 < steps)
      copy_x_rows(xw + ((i + 1) % XS) * XTILE, src, x, (i + 1) * ROWS, K, lane);
    else
      egs::cp_async_commit();  // an empty group keeps the count
    egs::cp_async_wait<1>();
    __syncwarp();
    const egs::bf16* xt = xw + (i % XS) * XTILE;
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) egs::load_a<8>(a[kk], xt, 0, kk, lane);
    const unsigned char* b;
    if constexpr (INT8) {
      b = deq + (i & 1) * TILE;
    } else {
      egs::mbar_wait(&full[s], (i / NS) & 1);
      b = smem + s * SB;
    }
    if (live) {
      egs::fence_regs(acc);
      egs::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        egs::wgmma_rs_m64n128k16(acc, a[kk], egs::sw128_desc(b + kk * 16 * 128, HALF, 1024));
      egs::wg_commit();
    }
    // int8: the next stage is dequantised while the products run
    if constexpr (INT8) {
      if (i + 1 < steps) dequantise_stage(smem, deq, full, sp, dcol, tid, i + 1);
    }
    if (live) {
      egs::wg_wait0();
      egs::fence_regs(acc);
      fence_regs_u(a);  // a stays untouched until the products have read it
    }
    __syncwarp();  // the warp's x tile of this stage is read: it may be refilled
    if constexpr (INT8) {
      // the next tile is whole, and every product has read this one
      consumers_sync(CONSUMERS);
      if (tid == 0 && i + 1 < steps) egs::mbar_arrive(&empty[(i + 1) % NS]);
    } else {
      if ((tid & 127) == 0) egs::mbar_arrive(&empty[s]);  // this warpgroup is done with s
    }
  }
  if (!live) return;

  // C (row, column): rows g (+8) of the warp's 16, columns 8j + 2t (+1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wrow + g + 8 * h;
    if (r >= cnt) continue;
    TO* orow = out + (size_t)tok[r] * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      if (n < N) store_pair<TO>(orow + n, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// -- the plan and the launches -------------------------------------------------

enum Route { CORES = 0, RING = 1, GROUPED = 2 };

// The plan of a call, stated once and from the shapes only.  bf16 x on
// aligned rows with N a multiple of 16 and K of 8 takes tensor cores:
// the wgmma kernel where an expert averages more than a run of 16 tokens,
// else the ring kernel, whose K is split (a cluster of at most 8, each
// split at least 256 rows) so that the grid's blocks that can hold tokens
// reach ring::TARGET, and past 2048 rows into splits of at most 1024.
// Anything else takes CUDA cores, split toward TARGET_BLOCKS (each split at
// most the rows a block stages).
struct Plan {
  int route;
  int tok;     // tokens a run
  int chunks;  // runs an expert
  int rows;    // K rows a split
  int splits;  // ring: the cluster; CUDA cores: partials and the combine kernel
};

Plan make_plan(int T, int K, int N, int E, bool dense, int dtype, bool w_int8, bool aligned) {
  Plan p;
  const bool tc = dtype == 1 && aligned && N % 16 == 0 && K % 8 == 0;
  const int used = T < E ? T : E;  // experts at most some token chose
  if (tc && T > ring::TOK * (dense ? 1 : E)) {
    p.route = GROUPED;
    p.tok = grp::TOK;
    p.chunks = ceil_div(T, p.tok);
    p.rows = K;
    p.splits = 1;
    return p;
  }
  const bool ring_k = K <= 8 * ring::MAX_ROWS;
  p.route = tc && ring_k ? RING : CORES;
  // ring runs of 8 tokens where an expert averages at most 8, else 16
  p.tok = p.route == RING ? (T <= 8 * (dense ? 1 : E) ? 8 : ring::TOK) : MT;
  p.chunks = ceil_div(T, p.tok);
  const int bn = p.route != RING ? NT
                 : w_int8 ? ring::Tile<int8_t>::BN : ring::Tile<__nv_bfloat16>::BN;
  const int live = ceil_div(N, bn) * (dense || p.chunks > used ? p.chunks : used);
  int s = ceil_div(p.route == RING ? ring::TARGET : TARGET_BLOCKS, live > 0 ? live : 1);
  const int cap = K / 256 > 1 ? K / 256 : 1;
  if (s > cap) s = cap;
  int unit;
  if (p.route == RING) {
    if (K > ring::MAX_ROWS && s < ceil_div(K, ring::SPLIT_ROWS)) s = ceil_div(K, ring::SPLIT_ROWS);
    if (s > 8) s = 8;
    if (s < ceil_div(K, ring::MAX_ROWS)) s = ceil_div(K, ring::MAX_ROWS);
    unit = ring::ROWS;
  } else {
    const int x_bytes = dtype == 1 ? 2 : 4;
    if (s < ceil_div(K, max_rows(x_bytes))) s = ceil_div(K, max_rows(x_bytes));
    unit = 32;
  }
  p.rows = ceil_div(ceil_div(K, s), unit) * unit;
  p.splits = ceil_div(K, p.rows);
  return p;
}

// W (E, K, N) as a 3-D tensor map (N, K, E) with boxes of box_rows K rows
// x box_cols columns, rows and columns past the end read 0
int weight_map(CUtensorMap* map, const void* w, bool int8, int K, int N, int E, int box_cols,
               int box_rows, bool swizzle, CUtensorMapL2promotion l2) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult res;
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &res);
    if (err != cudaSuccess) return (int)err;
    if (res != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t es = int8 ? 1 : 2;
  cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  cuuint64_t strides[2] = {(cuuint64_t)N * es, (cuuint64_t)K * N * es};
  cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = encode(map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      3, const_cast<void*>(w), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                      l2, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename TW, typename TO, int NT8>
int launch_ring(const Plan& pl, const void* x, const void* w, const void* scale, const void* ids,
                void* out, int T, int K, int N, int E, unsigned gy, cudaStream_t stream) {
  constexpr bool INT8 = std::is_same<TW, int8_t>::value;
  constexpr int BN = ring::Tile<TW>::BN;
  CUtensorMap tm;
  int err = weight_map(&tm, w, INT8, K, N, E, BN, ring::ROWS, false,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
  if (err) return err;
  const size_t smem = ring::smem_bytes<TW>(pl.rows, 8 * NT8);
  auto kern = expert_matmul_ring_kernel<TW, TO, NT8>;
  err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ceil_div(N, BN), gy, pl.splits);
  cfg.blockDim = dim3(ring::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = pl.splits;
  cfg.attrs = attr;
  cfg.numAttrs = pl.splits > 1 ? 1 : 0;  // one split: no cluster
  const egs::bf16* xp = static_cast<const egs::bf16*>(x);
  const float* sp = static_cast<const float*>(scale);
  const int* ip = static_cast<const int*>(ids);
  TO* op = static_cast<TO*>(out);
  int chunks = pl.chunks, rows = pl.rows;
  void* args[] = {&tm, &xp, &sp, &ip, &op, &T, &K, &N, &E, &chunks, &rows};
  err = (int)cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kern), args);
  if (err) return err;
  return (int)cudaGetLastError();
}

template <typename TW, typename TO>
int launch_grouped(const Plan& pl, const void* x, const void* w, const void* scale,
                   const void* ids, void* out, int T, int K, int N, int E, unsigned gy,
                   cudaStream_t stream) {
  constexpr bool INT8 = std::is_same<TW, int8_t>::value;
  CUtensorMap tm;
  int err = weight_map(&tm, w, INT8, K, N, E, INT8 ? 128 : 64, grp::ROWS, !INT8,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (err) return err;
  constexpr size_t smem = grp::Stage<TW>::SMEM;
  auto kern = expert_matmul_wgmma_kernel<TW, TO>;
  err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const dim3 grid(ceil_div(N, grp::BN), gy, 1);
  kern<<<grid, grp::THREADS, smem, stream>>>(
      tm, static_cast<const egs::bf16*>(x), static_cast<const float*>(scale),
      static_cast<const int*>(ids), static_cast<TO*>(out), T, K, N, E, pl.chunks);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW, typename TO>
int launch(const void* x, const void* w, const void* scale, const void* ids, void* out,
           void* part, int T, int K, int N, int E, bool aligned, cudaStream_t stream) {
  constexpr bool INT8 = std::is_same<TW, int8_t>::value;
  const bool dense = ids == nullptr;
  const Plan pl = make_plan(T, K, N, E, dense, std::is_same<TX, float>::value ? 0 : 1, INT8,
                            aligned);
  // one more expert's runs: the blocks that zero foreign ids' rows
  const long long gy = (long long)(dense ? 1 : E + 1) * pl.chunks;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
    if (pl.route == RING && pl.tok == 8)
      return launch_ring<TW, TO, 1>(pl, x, w, scale, ids, out, T, K, N, E, (unsigned)gy, stream);
    if (pl.route == RING)
      return launch_ring<TW, TO, 2>(pl, x, w, scale, ids, out, T, K, N, E, (unsigned)gy, stream);
    if (pl.route == GROUPED)
      return launch_grouped<TW, TO>(pl, x, w, scale, ids, out, T, K, N, E, (unsigned)gy,
                                    stream);
  }
  if (pl.splits > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid(ceil_div(N, NT), (unsigned)gy, pl.splits);
  float* p = pl.splits > 1 ? static_cast<float*>(part) : nullptr;
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  const float* sp = static_cast<const float*>(scale);
  const int* ip = static_cast<const int*>(ids);
  TO* op = static_cast<TO*>(out);
  if (N % 8 == 0 && aligned)
    expert_matmul_kernel<TX, TW, TO, true><<<grid, NTHREADS, 0, stream>>>(
        xp, wp, sp, ip, op, p, T, K, N, E, pl.chunks, pl.rows);
  else
    expert_matmul_kernel<TX, TW, TO, false><<<grid, NTHREADS, 0, stream>>>(
        xp, wp, sp, ip, op, p, T, K, N, E, pl.chunks, pl.rows);
  if (pl.splits > 1) {
    const long long TN = (long long)T * N;
    const int blocks = (int)((TN + 255) / 256 < 4 * 132 ? (TN + 255) / 256 : 4 * 132);
    expert_matmul_combine_kernel<TO><<<blocks, 256, 0, stream>>>(p, op, TN, pl.splits);
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

// fp32 words of scratch the call needs for its K splits' partials (0 unless
// CUDA cores split K); the wrapper allocates them.  dense: no ids (E = 1);
// dtype: x's (0 = float32, 1 = bfloat16); w_int8: an int8 weight; aligned:
// x and w start on 16 bytes.
extern "C" long long egs_expert_matmul_workspace(int T, int K, int N, int E, int dense,
                                                int dtype, int w_int8, int aligned) {
  if (T <= 0 || K <= 0 || N <= 0 || E <= 0) return 0;
  const Plan p = make_plan(T, K, N, E, dense != 0, dtype, w_int8 != 0, aligned != 0);
  return p.route == CORES && p.splits > 1 ? (long long)p.splits * T * N : 0;
}

// The plan of a call: route (0 CUDA cores, 1 the ring kernel, 2 the wgmma
// kernel) | K splits << 4 (the ring kernel's cluster; 1: one split) | the
// weight ring's stages << 8 (0 on CUDA cores).
extern "C" int egs_expert_matmul_plan(int T, int K, int N, int E, int dense, int dtype,
                                      int w_int8, int aligned) {
  if (T <= 0 || K <= 0 || N <= 0 || E <= 0) return 1 << 4;
  const Plan p = make_plan(T, K, N, E, dense != 0, dtype, w_int8 != 0, aligned != 0);
  const int stages = p.route == RING ? ring::NS : p.route == GROUPED ? grp::NS : 0;
  return p.route | (p.splits << 4) | (stages << 8);
}

// x (T, K) in the compute dtype (0 = float32, 1 = bfloat16); w (E, K, N)
// in that dtype, or int8 (w_int8 = 1) with scale (E, N) fp32; ids (T,)
// int32 (a row whose id lies outside [0, E) is written as zeros), or null
// (every token on expert 0); out (T, N) in the
// compute dtype, or fp32 (out_f32 = 1); part: egs_expert_matmul_workspace
// fp32 words (null when 0).  All contiguous; aligned as the wrapper found
// them (checked).  Returns the launch's error, else cudaGetLastError().
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
