// Blockwise online-softmax attention (flash attention, forward).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention -> _flash_forward -> _flash_kernel), the dispatch
// target of `forge.sdpa` nodes with no mask and Sq > 1: the causal
// full-sequence forward of the dense decoder.
//
// Semantics kept from the Pallas kernel: running (m, l, acc) in fp32;
// causal masking aligned at offset Sk - Sq (query row r sees keys
// <= r + Sk - Sq), with whole key tiles past the block's last visible
// key skipped; GQA by index (query head h reads KV head h / groups, the
// K/V heads are never expanded); the scale multiplies or divides the
// scores; a row that saw no key at all writes 0.  Masked scores are
// -inf here (the Pallas kernel uses the float32 minimum), and the update
// is skipped while a row's running max is still -inf, so a fully masked
// row keeps l == 0 and writes 0 exactly.
//
// What bounds it on the H100.  At the full-sequence shapes
// (B=4, H=12, S=1024, D=64, causal) it does 4*B*H*D*S*(S+1)/2 = 6.4e9
// operations on q, k, v read once and out written once, 25 MB in bf16:
// about 256 operations per byte, just under the ~295 where the tensor
// cores take over, so by that count the bytes bound it (7.5 us against
// 6.5 us for the operations) and both limits are near.  Either way the
// (Sq, Sk) score matrix must never reach device memory.
//
// What the design does about that.  The Pallas grid's sequential KV
// axis becomes a loop inside each block that streams K and V tiles
// through shared memory, so the scores stay on the SM.  Two kernels:
//
// * bf16 (the model's path): tensor cores through WMMA (mma.sync).  One
//   block of four warps per (b*h, 64-row query tile), each warp 16 query
//   rows, 64-key K/V tiles.  Q·Kᵀ lands in a per-warp shared-memory
//   score tile where lane pairs run the online softmax of their row and
//   round P to bf16 (as the reference casts P to V's dtype); the output
//   accumulator is staged through the same tile to be rescaled by each
//   row's correction before P·V accumulates into it.
// * f32: fp32 FMAs (tensor cores would round f32 to TF32).  One thread
//   per query row: its q row, its output accumulators and its running
//   max and sum stay in registers; the row's scores of the current
//   32-key tile sit in a shared-memory column of its own.  No
//   cross-thread reduction is needed, and every shared-memory read of a
//   K or V element is a warp broadcast.  The key loops stay rolled (two
//   keys per iteration), which keeps the build to seconds.
//
// Inputs may be strided views (the model hands over transposed
// projections) as long as the head dimension is contiguous.
#include "common.cuh"

#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;   // query rows per block (one per thread)
constexpr int BKV = 32;  // keys per shared-memory tile

struct Strides {  // element strides of a (B, heads, S, D) view, D contiguous
  long long b, h, s;
};

template <typename T, int D>
__global__ void __launch_bounds__(BQ)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides sq_,
                 Strides sk_, Strides sv_, Strides so_, int H, int KVH, int Sq,
                 int Sk, float scale, int scale_div, int causal) {
  __shared__ float ks[BKV][D];
  __shared__ float vs[BKV][D];
  __shared__ float ps[BKV][BQ];  // this tile's scores, then probabilities, per row

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const T* qp = q + b * sq_.b + h * sq_.h;
  const T* kp = k + b * sk_.b + kvh * sk_.h;
  const T* vp = v + b * sv_.b + kvh * sv_.h;
  T* op = o + b * so_.b + h * so_.h;

  const int t = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int row = q0 + t;
  const bool valid = row < Sq;
  const int off = Sk - Sq;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = valid ? to_f32(qp[row * sq_.s + d]) : 0.0f;
    acc[d] = 0.0f;
  }
  float m = -INFINITY, l = 0.0f;

  // causal block skip: the block's last row sees keys <= q0 + BQ - 1 + off
  int kv_end = Sk;
  if (causal) kv_end = max(0, min(Sk, q0 + BQ + off));

  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    for (int i = t; i < BKV * D; i += BQ) {
      const int j = i / D, d = i % D;
      const int gk = k0 + j;
      const bool in = gk < Sk;
      ks[j][d] = in ? to_f32(kp[gk * sk_.s + d]) : 0.0f;
      vs[j][d] = in ? to_f32(vp[gk * sv_.s + d]) : 0.0f;
    }
    __syncthreads();
    if (valid) {
      // scores of this row against the tile (K reads are warp broadcasts)
      float mt = -INFINITY;
#pragma unroll 2
      for (int j = 0; j < BKV; ++j) {
        float dot = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j][d], dot);
        dot = scale_div ? dot / scale : dot * scale;
        const int gk = k0 + j;
        const bool keep = gk < Sk && (!causal || gk <= row + off);
        const float sc = keep ? dot : -INFINITY;
        ps[j][t] = sc;
        mt = fmaxf(mt, sc);
      }
      const float m_new = fmaxf(m, mt);
      if (m_new != -INFINITY) {  // else nothing visible yet: keep l = 0
        const float alpha = expf(m - m_new);  // 0 while m is still -inf
        l *= alpha;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll 2
        for (int j = 0; j < BKV; ++j) {
          const float pj = expf(ps[j][t] - m_new);
          l += pj;
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] = fmaf(pj, vs[j][d], acc[d]);
        }
        m = m_new;
      }
    }
    __syncthreads();
  }

  if (valid) {
    const float inv = l > 0.0f ? 1.0f / l : 0.0f;  // fully masked row -> 0
#pragma unroll
    for (int d = 0; d < D; ++d) op[row * so_.s + d] = from_f32<T>(acc[d] * inv);
  }
}

// ---- bf16 on the tensor cores ----------------------------------------------

constexpr int TQ = 64, TKV = 64;  // query rows (4 warps x 16) and keys per tile

template <int D>
__global__ void __launch_bounds__(128)
    flash_wmma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, Strides sq_, Strides sk_,
                      Strides sv_, Strides so_, int H, int KVH, int Sq, int Sk,
                      float scale, int scale_div, int causal, int vec) {
  using namespace nvcuda;
  constexpr int LDK = D + 8, LDS = TKV + 4, LDP = TKV + 8, ND = D / 16;
  __shared__ __align__(32) __nv_bfloat16 Ks[TKV][LDK];  // stages Q first
  __shared__ __align__(32) __nv_bfloat16 Vs[TKV][LDK];
  __shared__ __align__(32) float Ss[4][16][LDS];  // scores; the O staging tile
  __shared__ __align__(32) __nv_bfloat16 Ps[4][16][LDP];
  __shared__ float rowv[4][16];  // per-row correction, then 1 / l

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const __nv_bfloat16* qp = q + b * sq_.b + h * sq_.h;
  const __nv_bfloat16* kp = k + b * sk_.b + kvh * sk_.h;
  const __nv_bfloat16* vp = v + b * sv_.b + kvh * sv_.h;
  __nv_bfloat16* op = o + b * so_.b + h * so_.h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * TQ;
  const int off = Sk - Sq;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  // load a (rows x D) tile of a strided view into shared memory, zero past `n`
  auto load_tile = [&](__nv_bfloat16 (*dst)[LDK], const __nv_bfloat16* src,
                       long long stride, int r0, int n) {
    if (vec) {
      for (int i = tid; i < TKV * D / 8; i += 128) {
        const int r = i / (D / 8), c = (i % (D / 8)) * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (r0 + r < n) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
        *reinterpret_cast<uint4*>(&dst[r][c]) = val;
      }
    } else {
      for (int i = tid; i < TKV * D; i += 128) {
        const int r = i / D, c = i % D;
        dst[r][c] = r0 + r < n ? src[(r0 + r) * stride + c] : zero;
      }
    }
  };

  load_tile(Ks, qp, sq_.s, q0, Sq);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa[ND];
#pragma unroll
  for (int kd = 0; kd < ND; ++kd) wmma::load_matrix_sync(qa[kd], &Ks[warp * 16][kd * 16], LDK);
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[ND];
#pragma unroll
  for (int kd = 0; kd < ND; ++kd) wmma::fill_fragment(oacc[kd], 0.0f);

  const int rl = lane >> 1, half = lane & 1;  // a lane pair per row, 32 columns each
  const int row = q0 + warp * 16 + rl;
  float m = -INFINITY, l = 0.0f;
  int kv_end = Sk;
  if (causal) kv_end = max(0, min(Sk, q0 + TQ + off));

  for (int k0 = 0; k0 < kv_end; k0 += TKV) {
    load_tile(Ks, kp, sk_.s, k0, Sk);
    load_tile(Vs, vp, sv_.s, k0, Sk);
    __syncthreads();

    // S = Q Kᵀ for this warp's 16 rows: Kᵀ is K read column-major
#pragma unroll
    for (int j = 0; j < TKV / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.0f);
#pragma unroll
      for (int kd = 0; kd < ND; ++kd) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, &Ks[j * 16][kd * 16], LDK);
        wmma::mma_sync(sf, qa[kd], kb, sf);
      }
      wmma::store_matrix_sync(&Ss[warp][0][j * 16], sf, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax of row `rl`: this lane's 32 columns, then its pair's
    float mt = -INFINITY;
    for (int c = half * 32; c < half * 32 + 32; ++c) {
      const int gk = k0 + c;
      float sc = Ss[warp][rl][c];
      sc = scale_div ? sc / scale : sc * scale;
      const bool keep = gk < Sk && (!causal || gk <= row + off);
      sc = keep ? sc : -INFINITY;
      Ss[warp][rl][c] = sc;
      mt = fmaxf(mt, sc);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    const float m_new = fmaxf(m, mt);
    const bool none = m_new == -INFINITY;  // nothing visible yet: l stays 0
    const float alpha = none ? 1.0f : expf(m - m_new);
    float ls = 0.0f;
    for (int c = half * 32; c < half * 32 + 32; ++c) {
      const float p = none ? 0.0f : expf(Ss[warp][rl][c] - m_new);
      ls += p;
      Ps[warp][rl][c] = __float2bfloat16(p);
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    l = l * alpha + ls;
    m = m_new;
    if (half == 0) rowv[warp][rl] = alpha;
    __syncwarp();

    // rescale the output rows by their correction, through the score tile
#pragma unroll
    for (int kd = 0; kd < ND; ++kd)
      wmma::store_matrix_sync(&Ss[warp][0][kd * 16], oacc[kd], LDS, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 16 * D; e += 32) Ss[warp][e / D][e % D] *= rowv[warp][e / D];
    __syncwarp();
#pragma unroll
    for (int kd = 0; kd < ND; ++kd)
      wmma::load_matrix_sync(oacc[kd], &Ss[warp][0][kd * 16], LDS, wmma::mem_row_major);

    // O += P V
#pragma unroll
    for (int j = 0; j < TKV / 16; ++j) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, &Ps[warp][0][j * 16], LDP);
#pragma unroll
      for (int kd = 0; kd < ND; ++kd) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, &Vs[j * 16][kd * 16], LDK);
        wmma::mma_sync(oacc[kd], pa, vb, oacc[kd]);
      }
    }
    __syncthreads();  // the next tile overwrites Ks and Vs
  }

#pragma unroll
  for (int kd = 0; kd < ND; ++kd)
    wmma::store_matrix_sync(&Ss[warp][0][kd * 16], oacc[kd], LDS, wmma::mem_row_major);
  if (half == 0) rowv[warp][rl] = l > 0.0f ? 1.0f / l : 0.0f;  // fully masked row -> 0
  __syncwarp();
  for (int e = lane; e < 16 * D; e += 32) {
    const int r = e / D, c = e % D;
    const int gr = q0 + warp * 16 + r;
    if (gr < Sq) op[gr * so_.s + c] = __float2bfloat16(Ss[warp][r][c] * rowv[warp][r]);
  }
}

template <int D>
void launch_wmma(const void* q, const void* k, const void* v, void* o, Strides sq,
                 Strides sk, Strides sv, Strides so, int B, int H, int KVH, int Sq,
                 int Sk, float scale, int scale_div, int causal, cudaStream_t stream) {
  auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = al(q) && al(k) && al(v) && sq.s % 8 == 0 && sk.s % 8 == 0 &&
                  sv.s % 8 == 0 && sq.h % 8 == 0 && sk.h % 8 == 0 && sv.h % 8 == 0 &&
                  sq.b % 8 == 0 && sk.b % 8 == 0 && sv.b % 8 == 0;
  dim3 grid((Sq + TQ - 1) / TQ, B * H);
  flash_wmma_kernel<D><<<grid, 128, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq, sk, sv,
      so, H, KVH, Sq, Sk, scale, scale_div, causal, vec);
}

// ---- dispatch -------------------------------------------------------------

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, Strides sq,
            Strides sk, Strides sv, Strides so, int B, int H, int KVH, int Sq,
            int Sk, float scale, int scale_div, int causal,
            cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    launch_wmma<D>(q, k, v, o, sq, sk, sv, so, B, H, KVH, Sq, Sk, scale, scale_div, causal,
                   stream);
  } else {
    dim3 grid((Sq + BQ - 1) / BQ, B * H);
    flash_kernel<T, D><<<grid, BQ, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), sq, sk, sv, so, H, KVH, Sq, Sk, scale, scale_div, causal);
  }
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, Strides sq,
             Strides sk, Strides sv, Strides so, int B, int H, int KVH, int Sq,
             int Sk, int D, float scale, int scale_div, int causal,
             cudaStream_t stream) {
  switch (D) {
    case 16:
      launch<T, 16>(q, k, v, o, sq, sk, sv, so, B, H, KVH, Sq, Sk, scale, scale_div, causal, stream);
      return 0;
    case 32:
      launch<T, 32>(q, k, v, o, sq, sk, sv, so, B, H, KVH, Sq, Sk, scale, scale_div, causal, stream);
      return 0;
    case 64:
      launch<T, 64>(q, k, v, o, sq, sk, sv, so, B, H, KVH, Sq, Sk, scale, scale_div, causal, stream);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 4 views x (b, h, s) element strides, in the order q, k, v, o
extern "C" int forge_flash_attention(const void* q, const void* k,
                                     const void* v, void* o,
                                     const long long* strides, int B, int H,
                                     int KVH, int Sq, int Sk, int D,
                                     float scale, int scale_div, int causal,
                                     int dtype, void* stream) {
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == FORGE_F32) {
    rc = launch_d<float>(q, k, v, o, sq, sk, sv, so, B, H, KVH, Sq, Sk, D, scale, scale_div, causal, s);
  } else if (dtype == FORGE_BF16) {
    rc = launch_d<__nv_bfloat16>(q, k, v, o, sq, sk, sv, so, B, H, KVH, Sq, Sk, D, scale, scale_div, causal, s);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
