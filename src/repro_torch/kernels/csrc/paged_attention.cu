// Paged-attention decode: one query token per row attends over the row's
// KV pages, found through a page table.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention -> _paged_kernel), reached from
// models/attention._paged_update_attend when cfg.kv_kernel == "pallas"
// and the step carries one token per row (slot-level decode).
//
// Semantics kept from the Pallas kernel: q (B, H, D); k/v pages
// (NP, ps, KVH, D); page_table (B, MP) int32; pos (B,) int32.  Row b's
// query sees the keys at logical positions <= pos[b] (and, with a
// window, > pos[b] - window).  Scores, the running (m, l) and the P.V
// accumulator are fp32; the output has q's dtype.  Pages past pos or
// wholly behind the window are skipped, so the trash page that backs
// unallocated table entries never enters live arithmetic; inside a live
// page the slots past pos (or behind the window) are masked one by one.
// A row that sees no key (pos = -1) writes zeros (l == 0), not 0/0.
// Masked scores are -inf here (the Pallas kernel uses the float32
// minimum); every page the loop visits holds at least one live key, so
// the running max is finite after the first page and exp(-inf - m) is 0.
//
// Design.  The Pallas grid (B, H, max_pages) carries (m, l, acc) across
// its sequential page axis.  Here one block serves one (row b, KV head):
// it reads pos[b] and the row's table from device memory itself (no
// scalar prefetch), works out the first and last live page, and loops
// over those pages.  It serves every query head of its KV head (the
// H / KVH GQA group), so each K/V page is read from device memory once,
// never expanded.  Per page: K and V land in shared memory as fp32;
// one warp per (query head, slot) takes the dot product with a warp
// reduction; one warp per query head updates that head's online softmax;
// then every thread updates its (head, d) accumulators with P.V.
//
// Bound on the H100.  The function must read each live page's K and V
// once (live pages x ps x KVH x D x 2 x element size), plus q, the
// table and pos, and write out: at the served decode shapes (B <= 4,
// KVH = 12, D = 64, ps = 16, bf16, at most 5 live pages a row in
// chip_smoke.py's workload) that is under 1 MB, about a third of a
// microsecond at 3.35 TB/s, and the operations (4 x H x D x keys) take
// less.  So launch latency sets its time today.  Splitting a row's pages across blocks (flash-decoding),
// cp.async pipelining of the page loads and tensor-core products are
// later work.
//
// Decode is inference only: the Pallas kernel has no custom_vjp, so this
// kernel has no backward and its wrapper no autograd.Function.
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// shared memory, all fp32: q[G][D] acc[G][D] k[ps][D] v[ps][D] s[G][ps]
// m[G] l[G] alpha[G]
template <typename T>
__global__ void __launch_bounds__(THREADS)
    paged_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                 const T* __restrict__ vp, const int* __restrict__ pt,
                 const int* __restrict__ pos, T* __restrict__ out, int H,
                 int KVH, int D, int NP, int ps, int MP, int window,
                 float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KVH;
  float* qs = smem;
  float* acc = qs + G * D;
  float* ks = acc + G * D;
  float* vs = ks + ps * D;
  float* sc = vs + ps * D;
  float* m = sc + G * ps;
  float* l = m + G;
  float* alpha = l + G;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h0 = kvh * G;  // first query head of this KV head

  for (int e = tid; e < G * D; e += THREADS) {
    qs[e] = to_f32(q[((long long)b * H + h0) * D + e]);
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  const int p = pos[b];
  // live pages: those holding any key in [max(0, p - window + 1), p]
  int first = 0;
  if (window > 0) {
    const int lo = p - window + 1;
    first = lo > 0 ? lo / ps : 0;
  }
  int last = p >= 0 ? p / ps : -1;
  if (last > MP - 1) last = MP - 1;
  const long long row_stride = (long long)KVH * D;  // one slot of a page

  for (int j = first; j <= last; ++j) {
    int page = pt[(long long)b * MP + j];
    page = page < 0 ? 0 : (page >= NP ? NP - 1 : page);  // memory safety only
    const int k0 = j * ps;
    __syncthreads();  // the previous page's K/V, scores and probabilities are done
    const T* kpage = kp + (long long)page * ps * row_stride + (long long)kvh * D;
    const T* vpage = vp + (long long)page * ps * row_stride + (long long)kvh * D;
    for (int e = tid; e < ps * D; e += THREADS) {
      const int slot = e / D, d = e - slot * D;
      ks[e] = to_f32(kpage[slot * row_stride + d]);
      vs[e] = to_f32(vpage[slot * row_stride + d]);
    }
    __syncthreads();
    // scores: one warp per (query head, slot)
    for (int idx = warp; idx < G * ps; idx += WARPS) {
      const int g = idx / ps, slot = idx - g * ps;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += qs[g * D + d] * ks[slot * D + d];
      dot = warp_sum(dot);
      if (lane == 0) {
        const int col = k0 + slot;
        bool keep = col <= p;
        if (window > 0) keep = keep && col > p - window;
        sc[idx] = keep ? dot * scale : -INFINITY;
      }
    }
    __syncthreads();
    // online softmax: one warp per query head
    for (int g = warp; g < G; g += WARPS) {
      float mx = -INFINITY;
      for (int s = lane; s < ps; s += 32) mx = fmaxf(mx, sc[g * ps + s]);
      mx = warp_max(mx);
      const float m_new = fmaxf(m[g], mx);  // finite: a live page has a live key
      float sum = 0.f;
      for (int s = lane; s < ps; s += 32) {
        const float pr = expf(sc[g * ps + s] - m_new);
        sc[g * ps + s] = pr;
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m[g] - m_new);  // 0 on the first live page
        alpha[g] = a;
        l[g] = l[g] * a + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();
    // P.V into the fp32 accumulators
    for (int e = tid; e < G * D; e += THREADS) {
      const int g = e / D, d = e - g * D;
      float a = acc[e] * alpha[g];
      for (int s = 0; s < ps; ++s) a += sc[g * ps + s] * vs[s * D + d];
      acc[e] = a;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += THREADS) {
    const int g = e / D;
    const float lg = l[g];
    out[((long long)b * H + h0) * D + e] = from_f32<T>(lg == 0.f ? 0.f : acc[e] / lg);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pt,
           const void* pos, void* out, int B, int H, int KVH, int D, int NP,
           int ps, int MP, int window, float scale, cudaStream_t stream) {
  const int G = H / KVH;
  const size_t floats = (size_t)2 * G * D + (size_t)2 * ps * D + (size_t)G * ps + 3 * (size_t)G;
  const size_t bytes = floats * sizeof(float);
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(KVH, B);
  paged_kernel<T><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(pt), static_cast<const int*>(pos), static_cast<T*>(out),
      H, KVH, D, NP, ps, MP, window, scale);
  return 0;
}

}  // namespace

// q (B, H, D); k, v (NP, ps, KVH, D); page_table (B, MP) int32; pos (B,)
// int32; out (B, H, D).  All contiguous.  window <= 0 means no window.
extern "C" int forge_paged_attention(const void* q, const void* k, const void* v,
                                     const void* page_table, const void* pos,
                                     void* out, int B, int H, int KVH, int D,
                                     int NP, int ps, int MP, int window,
                                     float scale, int dtype, void* stream) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0 || D <= 0 || ps <= 0 || MP <= 0 || NP <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == FORGE_F32) {
    rc = launch<float>(q, k, v, page_table, pos, out, B, H, KVH, D, NP, ps, MP,
                       window, scale, s);
  } else if (dtype == FORGE_BF16) {
    rc = launch<__nv_bfloat16>(q, k, v, page_table, pos, out, B, H, KVH, D, NP,
                               ps, MP, window, scale, s);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
