// Helpers the port's attention kernels share: K1 (flash_fwd.cu), K2
// (paged_attention.cu), K3 (flash_stats.cu) and K4 (flash_bwd.cu).
// Conversions between the storage types and fp32 and the warp reductions
// (K2, K3, and the fp32 paths of K1 and K4), the finite NEG_INF of the
// masked logit (all four), 128-byte shared-memory alignment, the
// synchronous 64-row tile load (K3 and the fp32 paths of K1 and K4), and
// the shared-memory plan of K3 and of K1's fp32 path (FwdLayout).  The
// bf16 paths of K1 and K4 build on warp_mma.cuh instead.
// ops/_build.py digests this header with the sources, so an edit here
// rebuilds every kernel.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace egs {

constexpr int TILE = 64;           // rows of a flash tile, queries or keys
constexpr int TILE_WARPS = TILE / 16;  // each warp owns 16 rows
constexpr int TILE_THREADS = TILE_WARPS * 32;
constexpr float NEG_INF = -1e30f;  // finite masked logit, as in the reference

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [row0, row0 + TILE) of a (rows_total, D) row-major matrix into a
// shared tile of stride ld, 16 bytes a thread a step, by a block of
// TILE_THREADS threads; rows past the end are zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int row0,
                                          int rows_total, int ld) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int i = threadIdx.x; i < TILE * CHUNKS; i += TILE_THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * VEC;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < rows_total) val = *reinterpret_cast<const uint4*>(src + (size_t)gr * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// Shared-memory plan of K3 and of K1's fp32 path: a query tile, a K
// and a V tile, fp32 scores, P in T, the fp32 output accumulator and the
// per-row m, l and alpha.  Row strides are padded so every row starts
// 16-byte aligned and every WMMA fragment pointer 32-byte aligned.
template <typename T, int D>
struct FwdLayout {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int LD = D + (kBf16 ? 8 : 4);      // Q, K, V tiles
  static constexpr int LDS = TILE + 4;                // scores, fp32
  static constexpr int LDP = TILE + (kBf16 ? 8 : 4);  // P, in T
  static constexpr int LDO = D + 4;                   // output accumulator, fp32
  static constexpr size_t Q_OFF = 0;
  static constexpr size_t K_OFF = Q_OFF + align128(sizeof(T) * TILE * LD);
  static constexpr size_t V_OFF = K_OFF + align128(sizeof(T) * TILE * LD);
  static constexpr size_t S_OFF = V_OFF + align128(sizeof(T) * TILE * LD);
  static constexpr size_t P_OFF = S_OFF + align128(sizeof(float) * TILE * LDS);
  static constexpr size_t O_OFF = P_OFF + align128(sizeof(T) * TILE * LDP);
  static constexpr size_t M_OFF = O_OFF + align128(sizeof(float) * TILE * LDO);
  static constexpr size_t L_OFF = M_OFF + align128(sizeof(float) * TILE);
  static constexpr size_t A_OFF = L_OFF + align128(sizeof(float) * TILE);
  static constexpr size_t BYTES = A_OFF + align128(sizeof(float) * TILE);
};

}  // namespace egs
