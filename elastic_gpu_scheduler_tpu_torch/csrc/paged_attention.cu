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
// This first version is right and simple:
//   - one block per (kv-head, batch row); the block reads its own page ids
//     from `tables` (Hopper has no scalar prefetch) and loops over the live
//     pages, loading each page's (ps, Dh) K and V tile into shared memory;
//   - the block covers all n_rep * W query rows of its kv-head, so GQA never
//     expands K/V;
//   - all math in fp32 (the TPU kernel upcasts q, k and v), the scale
//     applied after the dot, an online softmax across pages, and
//     out = acc / max(l, 1e-30);
//   - live pages: page_start <= length + W - 1; with a window, pages wholly
//     below the earliest query's window are neither read nor computed.
// int8 pools (the reference's kv_int8 engine): K/V rows stored as int8
// with one fp32 scale per (token, kv-head).  Each element is dequantised
// as it is loaded into shared memory, through the compute dtype T exactly
// as the reference's `_dequant` does (int8 -> fp32, times the scale,
// rounded to T, back to fp32), so the kernel and the gather engine see the
// same K/V values and stay token-identical; the pool's bytes halve.
// Split-K over long contexts (more blocks per row) is later work.

#include "attn_common.cuh"

namespace {

using namespace egs;

constexpr int NTHREADS = 128;

// shared-memory floats for R query rows, page size ps, head dim Dh
__host__ __device__ inline size_t smem_floats(int R, int ps, int Dh) {
  return (size_t)R * Dh          // q rows
         + (size_t)ps * (Dh + 1)  // K page (padded: no bank conflicts in the dot)
         + (size_t)ps * Dh        // V page
         + (size_t)R * Dh         // output accumulator
         + (size_t)R * ps         // scores, then probabilities
         + 3 * (size_t)R;         // m, l, alpha
}

// T: q / out and compute dtype; P: pool element (T, or int8_t with scales)
template <typename T, typename P, int Dh>
__global__ void __launch_bounds__(NTHREADS)
paged_attn_kernel(const T* __restrict__ q, const P* __restrict__ pool_k,
                  const P* __restrict__ pool_v, const float* __restrict__ scales_k,
                  const float* __restrict__ scales_v, const int* __restrict__ tables,
                  const int* __restrict__ lengths, T* __restrict__ out, int W, int Hn, int Hkv,
                  int ps, int NB, int window, float scale) {
  constexpr bool kInt8 = std::is_same<P, int8_t>::value;
  extern __shared__ __align__(16) float sm[];
  const int n_rep = Hn / Hkv;
  const int R = n_rep * W;  // query rows of this kv-head: row r = (w, rep)
  float* sQ = sm;
  float* sK = sQ + R * Dh;
  float* sV = sK + ps * (Dh + 1);
  float* sAcc = sV + ps * Dh;
  float* sS = sAcc + R * Dh;
  float* sM = sS + R * ps;
  float* sL = sM + R;
  float* sA = sL + R;

  const int hk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int length = lengths[b];

  for (int i = tid; i < R * Dh; i += NTHREADS) {
    const int r = i / Dh, d = i % Dh;
    const int w = r / n_rep, head = hk * n_rep + r % n_rep;
    sQ[i] = to_float(q[(((size_t)b * W + w) * Hn + head) * Dh + d]);
    sAcc[i] = 0.f;
  }
  for (int r = tid; r < R; r += NTHREADS) {
    sM[r] = NEG_INF;
    sL[r] = 0.f;
  }

  const int last = length + W - 1;  // keys exist up to the last query's position
  const int j_end = min(NB, last / ps + 1);
  const size_t row_stride = (size_t)Hkv * Dh;  // one token's K (or V) row in the pool
  for (int j = 0; j < j_end; ++j) {
    const int page_start = j * ps;
    // wholly below the earliest query's (w = 0) window: dead for every query
    if (window > 0 && page_start + ps - 1 < length - window + 1) continue;
    const size_t page = (size_t)tables[(size_t)b * NB + j];
    const size_t base = page * ps * row_stride + (size_t)hk * Dh;
    __syncthreads();  // the previous page is no longer read
    for (int i = tid; i < ps * Dh; i += NTHREADS) {
      const int t = i / Dh, d = i % Dh;
      const size_t g = base + t * row_stride + d;
      float kx = to_float(pool_k[g]);
      float vx = to_float(pool_v[g]);
      if constexpr (kInt8) {
        // int8 * scale in fp32, rounded through the compute dtype
        const size_t si = (page * ps + t) * Hkv + hk;
        kx = to_float(from_float<T>(kx * scales_k[si]));
        vx = to_float(from_float<T>(vx * scales_v[si]));
      }
      sK[t * (Dh + 1) + d] = kx;
      sV[t * Dh + d] = vx;
    }
    __syncthreads();
    for (int i = tid; i < R * ps; i += NTHREADS) {
      const int r = i / ps, t = i % ps;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < Dh; ++d) acc += sQ[r * Dh + d] * sK[t * (Dh + 1) + d];
      sS[i] = acc * scale;
    }
    __syncthreads();
    for (int r = tid; r < R; r += NTHREADS) {
      const int qpos = length + r / n_rep;
      float mx = NEG_INF;
      for (int t = 0; t < ps; ++t) {
        const int kpos = page_start + t;
        const bool keep = kpos <= qpos && (window <= 0 || qpos - kpos < window);
        if (keep) mx = fmaxf(mx, sS[r * ps + t]);
      }
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const int kpos = page_start + t;
        const bool keep = kpos <= qpos && (window <= 0 || qpos - kpos < window);
        const float p = keep ? expf(sS[r * ps + t] - m_new) : 0.f;
        sS[r * ps + t] = p;
        sum += p;
      }
      const float alpha = expf(m_old - m_new);
      sA[r] = alpha;
      sL[r] = sL[r] * alpha + sum;
      sM[r] = m_new;
    }
    __syncthreads();
    for (int i = tid; i < R * Dh; i += NTHREADS) {
      const int r = i / Dh, d = i % Dh;
      float acc = 0.f;
      for (int t = 0; t < ps; ++t) acc += sS[r * ps + t] * sV[t * Dh + d];
      sAcc[i] = sAcc[i] * sA[r] + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < R * Dh; i += NTHREADS) {
    const int r = i / Dh, d = i % Dh;
    const int w = r / n_rep, head = hk * n_rep + r % n_rep;
    out[(((size_t)b * W + w) * Hn + head) * Dh + d] =
        from_float<T>(sAcc[i] / fmaxf(sL[r], 1e-30f));
  }
}

template <typename T, typename P, int Dh>
int launch(const void* q, const void* pk, const void* pv, const void* sk, const void* sv,
           const void* tables, const void* lengths, void* out, int B, int W, int Hn, int Hkv,
           int ps, int NB, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats((Hn / Hkv) * W, ps, Dh) * sizeof(float);
  auto kern = paged_attn_kernel<T, P, Dh>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(pk), static_cast<const P*>(pv),
      static_cast<const float*>(sk), static_cast<const float*>(sv),
      static_cast<const int*>(tables), static_cast<const int*>(lengths), static_cast<T*>(out),
      W, Hn, Hkv, ps, NB, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename P>
int dispatch_d(int Dh, const void* q, const void* pk, const void* pv, const void* sk,
               const void* sv, const void* tables, const void* lengths, void* out, int B, int W,
               int Hn, int Hkv, int ps, int NB, int window, float scale, cudaStream_t s) {
  switch (Dh) {
    case 32:
      return launch<T, P, 32>(q, pk, pv, sk, sv, tables, lengths, out, B, W, Hn, Hkv, ps, NB,
                              window, scale, s);
    case 64:
      return launch<T, P, 64>(q, pk, pv, sk, sv, tables, lengths, out, B, W, Hn, Hkv, ps, NB,
                              window, scale, s);
    case 128:
      return launch<T, P, 128>(q, pk, pv, sk, sv, tables, lengths, out, B, W, Hn, Hkv, ps, NB,
                               window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of dynamic shared memory one block needs (the wrapper checks it
// against the card's limit before launching).
extern "C" long long egs_paged_attention_smem(int R, int ps, int Dh) {
  return (long long)(smem_floats(R, ps, Dh) * sizeof(float));
}

// q (B,W,Hn,Dh); pools (n_pages,ps,Hkv,Dh) in q's dtype; tables (B,NB) and
// lengths (B,) int32; out like q.  dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError().
extern "C" int egs_paged_attention(const void* q, const void* pool_k, const void* pool_v,
                                   const void* tables, const void* lengths, void* out, int B,
                                   int W, int Hn, int Hkv, int Dh, int ps, int NB, int dtype,
                                   int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(Dh, q, pool_k, pool_v, nullptr, nullptr,
                                                    tables, lengths, out, B, W, Hn, Hkv, ps,
                                                    NB, window, scale, s);
  if (dtype == 0)
    return dispatch_d<float, float>(Dh, q, pool_k, pool_v, nullptr, nullptr, tables, lengths,
                                    out, B, W, Hn, Hkv, ps, NB, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// As egs_paged_attention over an int8 pool: pools (n_pages,ps,Hkv,Dh) int8,
// scales (n_pages,ps,Hkv) fp32; dtype is q's, and the compute dtype the
// K/V values are dequantised through.
extern "C" int egs_paged_attention_int8(const void* q, const void* pool_k, const void* pool_v,
                                        const void* scales_k, const void* scales_v,
                                        const void* tables, const void* lengths, void* out,
                                        int B, int W, int Hn, int Hkv, int Dh, int ps, int NB,
                                        int dtype, int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, int8_t>(Dh, q, pool_k, pool_v, scales_k, scales_v, tables,
                                             lengths, out, B, W, Hn, Hkv, ps, NB, window,
                                             scale, s);
  if (dtype == 0)
    return dispatch_d<float, int8_t>(Dh, q, pool_k, pool_v, scales_k, scales_v, tables, lengths,
                                     out, B, W, Hn, Hkv, ps, NB, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
