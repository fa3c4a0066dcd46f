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
// minimum); every page a block visits holds at least one live key, so
// its running max is finite after its first chunk and exp(-inf - m) is 0.
//
// What bounds it on the H100.  The function must read each live page's
// K and V once (live pages x ps x KVH x D x 2 x element size), plus q,
// the table and pos, and write out; the operations (4 x H x D x keys)
// are far below the tensor cores' line.  At the served decode shape
// (B 4, KVH 12, D 64, ps 16, bf16, 3-5 live pages a row) that is under
// 1 MB, a quarter of a microsecond at 3.35 TB/s, so latency sets the
// time: the chain pos -> table -> page -> scores -> output, and a
// block that walks a row's pages in series.  At long context (128 live
// pages a row) the bytes bound it, and enough loads must be in flight.
//
// Design (flash-decoding).  Grid (KVH, B, splits): the row's live pages
// [first, last] are cut into `splits` near-equal runs, one per block,
// so a long row is read by many blocks at once and a short one by as
// many blocks as it has pages (a block past the live pages computes
// nothing).  `splits` comes from kernels/paged_attention.py `plan`: the
// grid aims at one wave of as many blocks as the SMs hold at once (by
// shared memory and registers), never more splits than a row can have
// live pages.  Each block
// serves the whole GQA group of its KV head, so each K/V page is read
// from device memory once, never expanded.  It walks its run in chunks
// of `chunk_pages` pages through a ring of STAGES chunks: the next
// chunk's K and V rows land in shared memory through 16-byte cp.async
// copies, in the pool's dtype, while the current chunk is scored (the
// chunk's table entries are read once a warp and broadcast by shuffle).
// Per chunk: LPD lanes take one key for a quad of heads, with their
// share of the heads' q rows in registers, one 16-byte shared-memory
// read of the key's K row per vector and a shuffle sum per head; one
// warp per head updates that head's online softmax; then the threads
// update the fp32 (head, d) accumulators with P.V, four columns a
// thread, the keys cut into contiguous slices over thread groups where
// the columns are fewer than the threads, summed in slice order.  There
// is no integer division by a runtime size inside the chunk loop: at
// these sizes the block's instruction stream, not the bytes, is what
// it waits on.  A block then writes its partial (acc, m, l) to scratch
// the wrapper allocates, fences, and takes a ticket (atomicAdd) for its
// (b, KV head); the block that draws the last ticket re-arms it to 0 and
// merges the partials in split order (max of m, then sums weighted by
// exp(m_s - m) from split 0 up, with no branch between the loads of
// successive splits), so the output does not depend on which block
// finished last and two calls agree bit for bit.  With one split the
// block writes the output itself.  One launch per call; the kernel
// allocates nothing.
//
// Decode is inference only: the Pallas kernel has no custom_vjp, so this
// kernel has no backward and its wrapper no autograd.Function.
#include "common.cuh"
#include "hopper.cuh"

#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 2;  // chunks in the ring (three measured no faster)

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the largest power of two <= n, at most 32
__host__ __device__ constexpr int pow2_floor32(int n) {
  return n >= 32 ? 32 : n >= 16 ? 16 : n >= 8 ? 8 : n >= 4 ? 4 : n >= 2 ? 2 : 1;
}

// fp32 words before the K / V ring: q and acc (G x D each), the chunk's
// scores (G x keys), m, l, alpha (G each, then padded to 16 bytes) and the
// P.V key-slice sums, rounded up to 16 bytes
__host__ __device__ inline int pa_float_words(int G, int D, int keys) {
  return 2 * G * D + ((G * keys + 3 * G + 3) & ~3) + 4 * THREADS;
}

__host__ __device__ inline size_t pa_smem_bytes(int G, int D, int keys, int esize) {
  return (size_t)pa_float_words(G, D, keys) * 4 + (size_t)STAGES * 2 * keys * D * esize;
}

// the 8 bf16 or 4 fp32 of a 16-byte vector as fp32
__device__ __forceinline__ void unpack16(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void unpack16(const uint4& raw, float (&f)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(&raw);
  f[0] = t.x;
  f[1] = t.y;
  f[2] = t.z;
  f[3] = t.w;
}

// four consecutive elements (8 or 16 bytes) as fp32
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// grid (KVH, B, splits); part: (B, KVH, splits) partials of G * (D + 2)
// floats (acc, then m, then l); tickets: (B, KVH) counters, 0 between calls
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    paged_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                 const T* __restrict__ vp, const int* __restrict__ pt,
                 const int* __restrict__ pos, T* __restrict__ out,
                 float* __restrict__ part, int* __restrict__ tickets, int H, int KVH,
                 int NP, int ps, int MP, int window, float scale, int splits,
                 int chunk_pages) {
  constexpr int VEC = 16 / sizeof(T);  // elements of a 16-byte vector
  constexpr int NV = D / VEC;          // vectors of a K / V row
  constexpr int LPD = pow2_floor32(NV);  // lanes that share one dot product
  constexpr int VPL = (NV + LPD - 1) / LPD;
  constexpr int NGROUPS = THREADS / LPD;
  extern __shared__ __align__(16) float pa_smem[];

  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int G = H / KVH;
  const int keys = chunk_pages * ps;  // keys of a full chunk
  float* qs = pa_smem;          // [G][D]
  float* acc = qs + G * D;      // [G][D]
  float* sc = acc + G * D;      // [G][keys]: scores, then probabilities
  float* m = sc + G * keys;
  float* l = m + G;
  float* alpha = l + G;
  float* red = sc + ((G * keys + 3 * G + 3) & ~3);  // [4 * THREADS]: P.V slice sums
  T* ring = reinterpret_cast<T*>(pa_smem + pa_float_words(G, D, keys));  // STAGES x (K, V)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h0 = kvh * G;  // first query head of this KV head

  // live pages: those holding any key in [max(0, p - window + 1), p];
  // this block takes its share [pb, pe) of them
  const int p = pos[b];
  int first = 0;
  if (window > 0) {
    const int lo = p - window + 1;
    first = lo > 0 ? lo / ps : 0;
  }
  int last = p >= 0 ? p / ps : -1;
  if (last > MP - 1) last = MP - 1;
  const int n = last >= first ? last - first + 1 : 0;
  const int pb = first + (int)((long long)split * n / splits);
  const int pe = first + (int)((long long)(split + 1) * n / splits);
  const int nchunks = (pe - pb + chunk_pages - 1) / chunk_pages;
  const long long row_stride = (long long)KVH * D;  // one slot of a page

  // K and V rows of pages [c0, min(c0 + chunk_pages, pe)) into ring stage
  // `st`: lane i of each warp reads the table entry of the chunk's page i
  // (chunk_pages <= 32), broadcast by shuffle; 16-byte cp.async copies
  auto issue = [&](int c0, int st) {
    T* kd = ring + (size_t)st * 2 * keys * D;
    T* vd = kd + (size_t)keys * D;
    const int npg = min(chunk_pages, pe - c0);
    int mine = lane < npg ? pt[(long long)b * MP + c0 + lane] : 0;
    mine = mine < 0 ? 0 : (mine >= NP ? NP - 1 : mine);  // memory safety only
    for (int pl = 0; pl < npg; ++pl) {
      const long long page = __shfl_sync(0xffffffffu, mine, pl);
      const long long src = page * ps * row_stride + (long long)kvh * D;
      for (int e = tid; e < ps * NV; e += THREADS) {
        const int slot = e / NV, vv = e % NV;
        const long long off = src + slot * row_stride + vv * VEC;
        const int dst = (pl * ps + slot) * D + vv * VEC;
        hopper::cp_async_16(kd + dst, kp + off, true);
        hopper::cp_async_16(vd + dst, vp + off, true);
      }
    }
    hopper::cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {  // the first chunks in flight
    if (c < nchunks) {
      issue(pb + c * chunk_pages, c);
    } else {
      hopper::cp_async_commit();  // an empty group keeps the group count
    }
  }

  for (int e = tid; e < G * D; e += THREADS) {
    qs[e] = to_f32(q[((long long)b * H + h0) * D + e]);
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  // P.V: thread (column quad, slice) sums a contiguous run of the chunk's
  // keys for four columns of one head; KS slices where the quads are
  // fewer than the threads, summed in slice order
  const int quads4 = G * D / 4;
  const int KS = quads4 >= THREADS ? 1 : pow2_floor32(THREADS / quads4);
  const int pv_e = tid % quads4, pv_slice = tid / quads4;
  const int grp = tid / LPD, lig = tid % LPD;

  for (int c = 0; c < nchunks; ++c) {
    hopper::cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c has landed; chunk c - 1's stage is free
    if (c + STAGES - 1 < nchunks) {
      issue(pb + (c + STAGES - 1) * chunk_pages, (c + STAGES - 1) % STAGES);
    } else {
      hopper::cp_async_commit();
    }
    const T* kc = ring + (size_t)(c % STAGES) * 2 * keys * D;
    const T* vc = kc + (size_t)keys * D;
    const int c0 = pb + c * chunk_pages;
    const int nk = min(chunk_pages, pe - c0) * ps;
    const int k0 = c0 * ps;  // logical position of the chunk's first key

    // scores: LPD lanes per key and quad of heads; the lanes hold their
    // share of the quad's q rows in registers, read the key's K row once
    // (16-byte loads) and shuffle-sum each head's dot product
    for (int g0 = 0; g0 < G; g0 += 4) {
      const int hq = min(4, G - g0);  // heads in this quad (uniform)
      float qr[4][VPL][VEC];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < VPL; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int vv = lig + LPD * i;
            qr[j][i][e] = j < hq && vv < NV ? qs[(g0 + j) * D + vv * VEC + e] : 0.f;
          }
      for (int kb = 0; kb < nk; kb += NGROUPS) {
        const int key = kb + grp;
        const bool ok = key < nk;
        float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          const int vv = lig + LPD * i;
          if (vv < NV) {
            float kf[VEC];
            unpack16(*reinterpret_cast<const uint4*>(kc + (ok ? key : 0) * D + vv * VEC), kf);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (j < hq)
#pragma unroll
                for (int e = 0; e < VEC; ++e) dot[j] = fmaf(qr[j][i][e], kf[e], dot[j]);
          }
        }
#pragma unroll
        for (int o = LPD / 2; o > 0; o >>= 1)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < hq) dot[j] += __shfl_xor_sync(0xffffffffu, dot[j], o);
        if (ok && lig == 0) {
          const int col = k0 + key;
          bool keep = col <= p;
          if (window > 0) keep = keep && col > p - window;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < hq) sc[(g0 + j) * keys + key] = keep ? dot[j] * scale : -INFINITY;
        }
      }
    }
    __syncthreads();
    // online softmax: one warp per query head
    for (int g = warp; g < G; g += WARPS) {
      float mx = -INFINITY;
      for (int s = lane; s < nk; s += 32) mx = fmaxf(mx, sc[g * keys + s]);
      mx = warp_max(mx);
      const float m_new = fmaxf(m[g], mx);  // finite: a live page has a live key
      float sum = 0.f;
      for (int s = lane; s < nk; s += 32) {
        const float pr = expf(sc[g * keys + s] - m_new);
        sc[g * keys + s] = pr;
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m[g] - m_new);  // 0 on the block's first chunk
        alpha[g] = a;
        l[g] = l[g] * a + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();
    // P.V into the fp32 accumulators, four columns a thread
    if (KS == 1) {
      for (int e = tid; e < quads4; e += THREADS) {
        const int g = e / (D / 4), d = 4 * (e % (D / 4));
        const float* pg = sc + g * keys;
        float4 a4 = *reinterpret_cast<const float4*>(acc + g * D + d);
        const float al = alpha[g];
        a4.x *= al; a4.y *= al; a4.z *= al; a4.w *= al;
        for (int s = 0; s < nk; ++s) {
          const float4 v4 = load4(vc + s * D + d);
          const float pr = pg[s];
          a4.x = fmaf(pr, v4.x, a4.x); a4.y = fmaf(pr, v4.y, a4.y);
          a4.z = fmaf(pr, v4.z, a4.z); a4.w = fmaf(pr, v4.w, a4.w);
        }
        *reinterpret_cast<float4*>(acc + g * D + d) = a4;
      }
    } else {
      const int g = pv_e / (D / 4), d = 4 * (pv_e % (D / 4));
      if (pv_slice < KS) {
        const float* pg = sc + g * keys;
        float4 a4 = make_float4(0.f, 0.f, 0.f, 0.f);
        const int s1 = (pv_slice + 1) * nk / KS;
        for (int s = pv_slice * nk / KS; s < s1; ++s) {
          const float4 v4 = load4(vc + s * D + d);
          const float pr = pg[s];
          a4.x = fmaf(pr, v4.x, a4.x); a4.y = fmaf(pr, v4.y, a4.y);
          a4.z = fmaf(pr, v4.z, a4.z); a4.w = fmaf(pr, v4.w, a4.w);
        }
        *reinterpret_cast<float4*>(red + 4 * tid) = a4;
      }
      __syncthreads();
      if (pv_slice == 0) {  // the slices' sums in slice order
        float4 a4 = *reinterpret_cast<const float4*>(acc + g * D + d);
        const float al = alpha[g];
        a4.x *= al; a4.y *= al; a4.z *= al; a4.w *= al;
        for (int k = 0; k < KS; ++k) {
          const float4 r = *reinterpret_cast<const float4*>(red + 4 * (k * quads4 + pv_e));
          a4.x += r.x; a4.y += r.y; a4.z += r.z; a4.w += r.w;
        }
        *reinterpret_cast<float4*>(acc + g * D + d) = a4;
      }
    }
  }
  __syncthreads();  // acc, m and l are final

  T* orow = out + ((long long)b * H + h0) * D;
  if (splits == 1) {
    for (int e = tid; e < G * D; e += THREADS) {
      const float lg = l[e / D];
      orow[e] = from_f32<T>(lg == 0.f ? 0.f : acc[e] / lg);
    }
    return;
  }

  const int P = G * (D + 2);  // floats of one partial
  float* mine = part + (((long long)b * KVH + kvh) * splits + split) * P;
  for (int e = tid; e < G * D; e += THREADS) mine[e] = acc[e];
  for (int g = tid; g < G; g += THREADS) {
    mine[G * D + g] = m[g];
    mine[G * D + G + g] = l[g];
  }
  __threadfence();  // the partial is visible device-wide before the ticket
  __syncthreads();
  __shared__ int is_last;
  if (tid == 0) {
    int* ticket = tickets + (long long)b * KVH + kvh;
    is_last = atomicAdd(ticket, 1) == splits - 1;
    if (is_last) atomicExch(ticket, 0);  // re-armed for the next call
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the last block merges the partials in split order: the weights
  // exp(m_s - m) are 0 for a split that saw no key (m_s = -inf, l_s = 0,
  // acc_s = 0), so every split is read without a branch and the loads of
  // successive splits overlap
  const float* all = part + ((long long)b * KVH + kvh) * splits * P;
  for (int e = tid; e < G * D; e += THREADS) {
    const int g = e / D;
    float mx = -INFINITY;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, __ldcg(all + s * P + G * D + g));
    float lsum = 0.f, a = 0.f;
    if (mx != -INFINITY) {
#pragma unroll 4
      for (int s = 0; s < splits; ++s) {
        const float* ps_ = all + s * P;
        const float w = expf(__ldcg(ps_ + G * D + g) - mx);
        lsum = fmaf(__ldcg(ps_ + G * D + G + g), w, lsum);
        a = fmaf(__ldcg(ps_ + e), w, a);
      }
    }
    orow[e] = from_f32<T>(lsum == 0.f ? 0.f : a / lsum);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* pt, const void* pos,
           void* out, void* part, void* tickets, int B, int H, int KVH, int NP, int ps,
           int MP, int window, float scale, int splits, int chunk_pages,
           cudaStream_t stream) {
  const int G = H / KVH;
  const size_t bytes = pa_smem_bytes(G, D, chunk_pages * ps, (int)sizeof(T));
  if (bytes > 227 * 1024 || chunk_pages > 32) return (int)cudaErrorInvalidValue;
  if (splits > 1 && (part == nullptr || tickets == nullptr)) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(KVH, B, splits);
  paged_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(pt), static_cast<const int*>(pos), static_cast<T*>(out),
      static_cast<float*>(part), static_cast<int*>(tickets), H, KVH, NP, ps, MP, window,
      scale, splits, chunk_pages);
  return 0;
}

// calls f(integral_constant<int, D>) for the head dims the kernel is built for
template <typename F>
int with_head_dim(int D, F&& f) {
  switch (D) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 112: return f(std::integral_constant<int, 112>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, D); k, v (NP, ps, KVH, D); page_table (B, MP) int32; pos (B,)
// int32; out (B, H, D).  All contiguous, K and V on 16 bytes.  window <= 0
// means no window.  The plan: splits blocks a row, chunks of chunk_pages
// (<= 32) pages.  part: B * KVH * splits *
// (H / KVH) * (D + 2) floats of scratch and tickets: B * KVH ints, zero
// (the kernel leaves them zero), both unused (may be null) with one split.
extern "C" int forge_paged_attention(const void* q, const void* k, const void* v,
                                     const void* page_table, const void* pos,
                                     void* out, void* part, void* tickets, int B, int H,
                                     int KVH, int D, int NP, int ps, int MP, int window,
                                     float scale, int splits, int chunk_pages, int dtype,
                                     void* stream) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0 || D <= 0 || ps <= 0 || MP <= 0 || NP <= 0 ||
      splits <= 0 || chunk_pages <= 0 || B > 65535 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = with_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    if (dtype == FORGE_F32)
      return launch<float, DD>(q, k, v, page_table, pos, out, part, tickets, B, H, KVH, NP,
                               ps, MP, window, scale, splits, chunk_pages, s);
    if (dtype == FORGE_BF16)
      return launch<__nv_bfloat16, DD>(q, k, v, page_table, pos, out, part, tickets, B, H,
                                       KVH, NP, ps, MP, window, scale, splits, chunk_pages, s);
    return (int)cudaErrorInvalidValue;
  });
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// the dynamic shared memory (bytes) one block takes
extern "C" long long forge_paged_attention_smem(int G, int D, int keys, int dtype) {
  return (long long)pa_smem_bytes(G, D, keys, dtype == FORGE_BF16 ? 2 : 4);
}
