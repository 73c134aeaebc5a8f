// Register micro-tiles of the float32 attention kernels: K1's float32 path
// (flash_fwd.cu), K3's (flash_stats.cu) and K4's float32 dq and dk/dv
// kernels (flash_bwd.cu).
//
// Products stay full float32 FMAs on the CUDA cores (no TF32: the float32
// paths are held to the reference's float32 einsums).  A block of eight
// warps owns a 64-row tile (queries in K3 and dq, keys in dk/dv) and streams
// 64-row tiles of the other side through a 2-stage ring of 16-byte cp.async
// copies.  Thread t owns rows 4 rg .. 4 rg + 3 of the block's tile, rg = t /
// 16, and:
//   - of a 64 x 64 score tile, the columns cg, cg + 16, cg + 32, cg + 48 (cg
//     = t % 16): a 4 x 4 micro-tile, each step of the D-long reduction four
//     16-byte loads of each side for 64 FMAs;
//   - of a 64 x D accumulator (O, dQ, dK, dV), D / 16 columns, one or two
//     vectors of VW floats whose 16 lanes of a row group cover a row
//     contiguously: each step of the 64-long reduction four 16-byte loads of
//     P (or dS) and D / 16 floats of the other operand for D / 4 FMAs a row.
// K1 also runs a block of four warps on a 32-row query tile: the same
// layout, rg < 8 (the copies take the block's thread count).
// The 16 lanes of a row group are half a warp, so a row's max and sum are
// shuffles over 16 lanes, and a P / dS tile that a row group writes and then
// reads needs only __syncwarp.  Tiles are padded to D + 4 floats a row (P and
// dS to 68), so the rows the eight lanes of a quarter warp read at one d fall
// in eight distinct 16-byte bank groups, and the two row groups of a warp
// (rows 4 apart) in distinct banks: no shared read or write conflicts.
// ops/_build.py digests this header with the sources.

#pragma once

#include "warp_mma.cuh"

namespace egs {
namespace f32 {

constexpr int NT = 256;      // eight warps
constexpr int BR = 64;       // rows of the block's own tile
constexpr int BC = 64;       // rows of a streamed tile: the score tile's columns
constexpr int TR = 4;        // rows a thread
constexpr int TC = 4;        // score columns a thread, 16 apart
constexpr int LDP = BC + 4;  // row stride of a P / dS tile

// row stride of a D-wide tile
template <int D>
__host__ __device__ constexpr int ld() {
  return D + 4;
}

// bytes of `tiles` D-wide 64-row tiles, `ptiles` P / dS tiles and `words`
// fp32 words
template <int D>
constexpr size_t smem_bytes(int tiles, int ptiles, int words) {
  return sizeof(float) * ((size_t)tiles * BR * ld<D>() + (size_t)ptiles * BR * LDP + words);
}

// rows [row0, row0 + ROWS) of a (rows_total, D) float32 matrix whose rows lie
// src_ld elements apart (16-byte aligned) into a tile of stride D + 4, by 16-
// byte cp.async by a block of THREADS threads; rows past the end are
// zero-filled.  The caller commits.
template <int ROWS, int D, int THREADS = NT>
__device__ __forceinline__ void cp_tile(float* dst, const float* __restrict__ src, int row0,
                                        int rows_total, long long src_ld) {
  constexpr int CH = D / 4;
  static_assert(ROWS * CH % THREADS == 0, "whole copy rounds");
#pragma unroll
  for (int n = 0; n < ROWS * CH / THREADS; ++n) {
    const int i = threadIdx.x + n * THREADS;
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < rows_total;
    cp_async16(dst + r * ld<D>() + c * 4, src + (ok ? row0 + r : 0) * src_ld + c * 4, ok);
  }
}

// s[i][j] += A[4 rg + i] . B[cg + 16 j] over the D columns of both tiles
// (stride D + 4), d in order
template <int D>
__device__ __forceinline__ void scores(float (&s)[TR][TC], const float* A, const float* B,
                                       int rg, int cg) {
  constexpr int LD = ld<D>();
  const float* a0 = A + 4 * rg * LD;
  const float* b0 = B + cg * LD;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 b[TC];
#pragma unroll
    for (int j = 0; j < TC; ++j) b[j] = *reinterpret_cast<const float4*>(b0 + 16 * j * LD + d);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(a0 + i * LD + d);
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        s[i][j] = fmaf(a.x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a.y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a.z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a.w, b[j].w, s[i][j]);
      }
    }
  }
}

// A thread's columns of a D-wide accumulator: NV vectors of VW floats,
// vector v at column v * 16 VW + cg VW
template <int D>
struct Cols {
  static constexpr int N = D / 16;
  static constexpr int VW = N >= 4 ? 4 : N;
  static constexpr int NV = N / VW;
  __device__ static int col(int v, int cg) { return v * 16 * VW + cg * VW; }
};

// VW floats at p (16- or 8-byte aligned) into x[0..VW)
template <int VW>
__device__ __forceinline__ void load_vec(float* x, const float* p) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    static_assert(VW == 2, "vectors of 2 or 4 floats");
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  }
}

template <int VW>
__device__ __forceinline__ void store_vec(float* p, const float* x) {
  if constexpr (VW == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// acc[i][:] += P[4 rg + i][c] B[c][thread's columns] over the BC columns c
// of P (stride LDP) and the BC rows of B (stride D + 4), c in order
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[TR][D / 16], const float* P,
                                           const float* B, int rg, int cg) {
  using C = Cols<D>;
  constexpr int LD = ld<D>();
  const float* p0 = P + 4 * rg * LDP;
#pragma unroll 2
  for (int c = 0; c < BC; c += 4) {
    float4 p[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) p[i] = *reinterpret_cast<const float4*>(p0 + i * LDP + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float b[C::N];
#pragma unroll
      for (int v = 0; v < C::NV; ++v)
        load_vec<C::VW>(b + v * C::VW, B + (c + e) * LD + C::col(v, cg));
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float pc = comp(p[i], e);
#pragma unroll
        for (int n = 0; n < C::N; ++n) acc[i][n] = fmaf(pc, b[n], acc[i][n]);
      }
    }
  }
}

// rows 4 rg + i of an accumulator to rows row0 + 4 rg + i (those below
// rows_total) of a (rows, D) matrix
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float (&acc)[TR][D / 16],
                                           int row0, int rows_total, int rg, int cg) {
  using C = Cols<D>;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = row0 + 4 * rg + i;
    if (row >= rows_total) continue;
#pragma unroll
    for (int v = 0; v < C::NV; ++v)
      store_vec<C::VW>(dst + (size_t)row * D + C::col(v, cg), acc[i] + v * C::VW);
  }
}

// max and sum over the 16 lanes of a row group
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace f32
}  // namespace egs
