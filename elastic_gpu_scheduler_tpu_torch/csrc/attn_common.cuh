// Helpers the port's attention kernels share: K1 (flash_fwd.cu), K2
// (paged_attention.cu), K3 (flash_stats.cu) and K4 (flash_bwd.cu).
// Conversions between the storage types and fp32 (K2, K3), the finite
// NEG_INF of the masked logit (all four) and the fold of split partials (K2
// and K3).  The bf16 paths of K1, K3 and K4 build on warp_mma.cuh, their
// fp32 paths on fp32_tile.cuh.
// ops/_build.py digests this header with the sources, so an edit here
// rebuilds every kernel.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace egs {

constexpr float NEG_INF = -1e30f;  // finite masked logit, as in the reference

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// fold the statistics (m_b, l_b) and accumulator a_b of a later run of
// keys into the running (m, l, a), as ring attention merges its hops:
// m = max(m, m_b), each side scaled by exp(m_old - m) (K2's and K3's
// merges; all-NEG_INF sides weigh exp(0) = 1)
__device__ __forceinline__ void fold_stats(float& m, float& l, float& a, float mb, float lb,
                                           float ab) {
  const float mn = fmaxf(m, mb);
  const float x = expf(m - mn), y = expf(mb - mn);
  a = a * x + ab * y;
  l = l * x + lb * y;
  m = mn;
}

}  // namespace egs
