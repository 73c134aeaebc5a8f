// Warp-level building blocks of the bf16 paths of K1 (flash_fwd.cu), K3
// (flash_stats.cu) and K4 (flash_bwd.cu), and the copies of K2
// (paged_attention.cu): 16-byte cp.async copies into XOR-swizzled shared
// tiles, ldmatrix fragment loads, and mma.sync.m16n8k16 (bf16 in, fp32
// accumulate), all as inline PTX for sm_90a.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16, row-major, 4 regs: (g, 2t..2t+1), (g+8, 2t..), (g, 8+2t..),
//     (g+8, 8+2t..);
//   B 16x8, "col", 2 regs: (k 2t..2t+1, n g), (k 8+2t.., n g);
//   C 16x8 fp32, 4 regs: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
// So two C tiles side by side, rounded and packed in pairs, are the A
// fragment of the next product: an attention kernel's P never leaves
// registers.
//
// A shared tile holds rows of D bf16 (CH = D / 8 chunks of 16 bytes).
// Chunk c of row r is stored at chunk swz(r, c) of its row, so the eight
// rows one 8x8 ldmatrix reads, and the eight chunks a cp.async warp
// writes, fall in eight different 16-byte bank groups.

#pragma once

#include "attn_common.cuh"

namespace egs {

using bf16 = __nv_bfloat16;

template <int CH>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(CH == 4 || CH % 8 == 0, "rows of 32, 64 or 128 bf16");
  if constexpr (CH == 4) {
    return c ^ ((r >> 1) & 3);  // two rows share a 128-byte line
  } else {
    return c ^ (r & 7);
  }
}

// element offset of chunk c of row r in a swizzled tile
template <int CH>
__device__ __forceinline__ int tile_off(int r, int c) {
  return (r * CH + swz<CH>(r, c)) * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without a register round trip; zero-filled
// when !ok (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + ROWS) of a (rows_total, D) bf16 matrix whose rows lie
// ld elements apart (16-byte aligned) into a swizzled shared tile, by a
// block of NT threads; rows past the end are zeros.  The caller commits
// the group.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* __restrict__ src, int row0,
                                        int rows_total, size_t ld = D) {
  constexpr int CH = D / 8;
  static_assert(ROWS * CH % NT == 0, "whole copy rounds");
#pragma unroll
  for (int n = 0; n < ROWS * CH / NT; ++n) {
    const int i = threadIdx.x + n * NT;
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < rows_total;
    cp_async16(dst + tile_off<CH>(r, c), src + (size_t)(ok ? row0 + r : 0) * ld + c * 8, ok);
  }
}

// rows [row0, row0 + ROWS) of an fp32 vector into shared memory; zeros past
// the end
template <int ROWS, int NT>
__device__ __forceinline__ void cp_rows(float* dst, const float* __restrict__ src, int row0,
                                        int rows_total) {
  for (int i = threadIdx.x; i < ROWS; i += NT) {
    const bool ok = row0 + i < rows_total;
    cp_async4(dst + i, src + (ok ? row0 + i : 0), ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// A fragment: rows row0..row0+15, columns 16 kk..16 kk+15 of a tile
template <int CH>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int row0, int kk,
                                       int lane) {
  ldsm_x4(a, tile + tile_off<CH>(row0 + (lane & 15), 2 * kk + (lane >> 4)));
}

// B fragments of two n-tiles whose n runs along the tile's rows (row0..+7
// in b[0..1], row0+8..+15 in b[2..3]) and k along columns 16 kk..+15: the
// tile is B transposed (K for Q K^T)
template <int CH>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile, int row0, int kk,
                                       int lane) {
  ldsm_x4(b, tile + tile_off<CH>(row0 + ((lane >> 4) << 3) + (lane & 7),
                                 2 * kk + ((lane >> 3) & 1)));
}

// B fragments whose k runs along the tile's rows (krow0..krow0+15) and n
// along chunks c0 (b[0..1]) and c0 + 1 (b[2..3]): the tile is B itself (V
// for P V)
template <int CH>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4], const bf16* tile, int krow0,
                                             int c0, int lane) {
  ldsm_x4_trans(b, tile + tile_off<CH>(krow0 + (lane & 15), c0 + (lane >> 4)));
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// C tiles j and j + 1 of a row block, packed as the A fragment of k-step
// j / 2
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the (query, key) pair at these absolute positions survives the mask
// (queries sit at the last Sq of Sk positions)
__device__ __forceinline__ bool keeps(int qpos, int kpos, int Sk, int causal, int window) {
  return kpos < Sk && (!causal || kpos <= qpos) && (window <= 0 || qpos - kpos < window);
}

// A warp's 16 rows x D fp32 accumulator (C tiles) rounded to bf16 and
// written to global rows [grow0, grow0 + 16) (those below rows_total), 16
// bytes a store, through the warp's own 16 rows of a swizzled shared tile
// (which no other warp reads).  div[0] divides rows g and div[1] rows
// g + 8 of each C tile.
template <int D>
__device__ __forceinline__ void store_acc_rows(bf16* __restrict__ dst, bf16* stage,
                                               const float (&acc)[D / 8][4], int wrow,
                                               int grow0, int rows_total, const float (&div)[2],
                                               int lane) {
  constexpr int CH = D / 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    *reinterpret_cast<uint32_t*>(stage + tile_off<CH>(wrow + g, j) + 2 * t) =
        pack_bf16(acc[j][0] / div[0], acc[j][1] / div[0]);
    *reinterpret_cast<uint32_t*>(stage + tile_off<CH>(wrow + g + 8, j) + 2 * t) =
        pack_bf16(acc[j][2] / div[1], acc[j][3] / div[1]);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH;
    if (grow0 + r < rows_total)
      *reinterpret_cast<uint4*>(dst + (size_t)(grow0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(stage + tile_off<CH>(wrow + r, c));
  }
}

}  // namespace egs
