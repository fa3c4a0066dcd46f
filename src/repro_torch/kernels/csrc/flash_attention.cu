// Blockwise online-softmax attention (flash attention, forward).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention -> _flash_forward -> _flash_kernel), the dispatch
// target of `forge.sdpa` nodes with no mask: the causal full-sequence
// forward of the decoders, the encoder's non-causal self-attention and
// the cross-attention of the encoder-decoder family, a single query row
// at decode included (one 128-row tile holding one live row).
//
// Semantics kept from the Pallas kernel: running (m, l, acc) in fp32;
// causal masking aligned at offset Sk - Sq (query row r sees keys
// <= r + Sk - Sq), with whole key tiles past the block's last visible
// key skipped; GQA by index (query head h reads KV head h / groups, the
// K/V heads are never expanded); the scale multiplies or divides the
// scores; a row that saw no key at all writes 0.  Masked scores are
// -inf here (the Pallas kernel uses the float32 minimum), and while a
// row's running max is still -inf its probabilities are 0, so a fully
// masked row keeps l == 0 and writes 0 exactly.
//
// What bounds it on the H100.  At the full-sequence shapes
// (B=4, H=12, S=1024, D=64, causal) it does 4*B*H*D*S*(S+1)/2 = 6.4e9
// operations on q, k, v read once and out written once, 25 MB in bf16:
// about 256 operations per byte, just under the ~295 where the tensor
// cores take over, so by that count the bytes bound it (7.5 us against
// 6.5 us for the operations) and both limits are near.  Either way the
// (Sq, Sk) score matrix must never reach device memory, and the two
// products must run on the tensor cores at their wgmma rate.
//
// What the design does about that.  The Pallas grid's sequential KV
// axis becomes a loop inside each block that streams K and V tiles
// through shared memory, so the scores stay on the SM.  The plan
// (kernels/flash_attention.py `variant`) picks one of three kernels:
//
// * wgmma (bf16 views TMA can take: 16-byte-aligned bases and strides,
//   the model's transposed projections included; head dims up to 128).
//   One CTA per (b*h, 128-row query tile), the causally longest tiles
//   first: a producer warp loads Q once and K and V tiles into a
//   three-stage ring with 4-D TMA over the strided view; two consumer
//   warpgroups of 64 rows each run S = Q K^T as wgmma from shared memory
//   (Q and K K-major), keep S in registers, run the online softmax there
//   (row max and sum in four independent partials, then over the quad of
//   lanes that shares a row; exp2 with scale*log2(e) folded in; masks on
//   edge tiles only), round P to bf16 in registers as the reference casts
//   P to V's dtype, and run O += P V as wgmma with P as the register A
//   operand and V read MN-major through the transpose bit.  The next
//   tile's Q K^T is issued before this tile's softmax, so the tensor cores
//   work while the softmax runs.  The O accumulator is rescaled in
//   registers: S, P and O never go through shared memory.  Head dims
//   (FwLayout): D <= 64 keeps a tile row as one swizzled block (the row
//   bytes, 2D, are the swizzle span) and 128-key tiles; D = 96, 112 and
//   128 run padded to 128 columns, as the JAX kernel pads 112 to 128
//   lanes: two 64-column TMA boxes of 128-byte rows a tile (TMA writes
//   zeros past D), Q K^T over both blocks, P V as one m64n64k16 per block,
//   and 64-key tiles, so that the 64-register O accumulator and two
//   tiles' scores fit a thread's 232 registers.  (A view TMA cannot take,
//   a base or stride off 16 bytes, could not take 16-byte cp.async copies
//   either, so no cp.async loader sits beside the TMA one.)
// * wmma (bf16 views TMA cannot take, and D = 256, whose 128-register O
//   accumulator leaves no room for wgmma's scores).  Four warps of 16
//   query rows per 64-row block on mma.sync (WMMA 16x16x16); Q·K^T, the
//   probabilities and the rescaled output accumulator are staged through
//   dynamic shared memory (76 KB at D = 128, 173 KB at D = 256, where Q
//   also stays in shared memory instead of registers), and K/V loads are
//   synchronous.  No served call reaches it.
// * fma (f32): fp32 FMAs (tensor cores would round f32 to TF32).  TPR =
//   1, 2, 4 or 8 neighbouring lanes share a query row (D <= 32, 64, 128,
//   256): each keeps D / TPR of the row's q and output accumulators in
//   registers (at most 32 + 32) and the row's running max and sum; a dot
//   product is the lanes' partial sums, shuffle-summed.  K and V tiles of
//   32 keys and the rows' scores sit in dynamic shared memory, where a
//   lane's read of a K or V element is TPR neighbouring words.  The key
//   loops stay rolled (two keys per iteration), which keeps the build to
//   seconds.
//
// Inputs may be strided views (the model hands over transposed
// projections) as long as the head dimension is contiguous.  Measured
// (chip_smoke.py phase 2: H100 80GB HBM3 at 700 W, device time with the L2
// flushed): at B=4, H=12, S=1024, D=64, causal, bf16 the wgmma kernel takes
// 0.0512 ms against 0.0288 ms for F.scaled_dot_product_attention (the
// WMMA kernel it replaced: 0.1906-0.1948); more in PERF.md §6.
#include "common.cuh"
#include "hopper.cuh"

#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BKV = 32;  // keys per shared-memory tile

struct Strides {  // element strides of a (B, heads, S, D) view, D contiguous
  long long b, h, s;
};

// threads that share one query row of the f32 kernel: each keeps D / TPR
// of the row's q and output accumulators in registers (at most 32 + 32)
__host__ __device__ constexpr int fma_tpr(int d) {
  return d <= 32 ? 1 : d <= 64 ? 2 : d <= 128 ? 4 : 8;
}

// the K and V tiles and the scores tile, all fp32 (dynamic shared memory)
__host__ __device__ constexpr int fma_smem_bytes(int d) { return (2 * BKV * d + BKV * BQ) * 4; }

template <typename T, int D>
__global__ void __launch_bounds__(BQ * fma_tpr(D))
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides sq_,
                 Strides sk_, Strides sv_, Strides so_, int H, int KVH, int Sq,
                 int Sk, float scale, int scale_div, int causal) {
  constexpr int TPR = fma_tpr(D), DPT = D / TPR, NT = BQ * TPR;
  extern __shared__ float fma_smem[];
  float* ks = fma_smem;      // [BKV][D]
  float* vs = ks + BKV * D;  // [BKV][D]
  float* ps = vs + BKV * D;  // [BKV][BQ]: this tile's scores, then probabilities, per row

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const T* qp = q + b * sq_.b + h * sq_.h;
  const T* kp = k + b * sk_.b + kvh * sk_.h;
  const T* vp = v + b * sv_.b + kvh * sv_.h;
  T* op = o + b * so_.b + h * so_.h;

  // TPR neighbouring lanes share a row; lane `sub` of them holds the
  // dims sub, sub + TPR, ... (a K or V read is then TPR neighbouring words)
  const int t = threadIdx.x;
  const int rl = t / TPR, sub = t % TPR;
  const int q0 = blockIdx.x * BQ;
  const int row = q0 + rl;
  const bool valid = row < Sq;  // rows past Sq compute on zeros, never store
  const int off = Sk - Sq;

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = valid ? to_f32(qp[row * sq_.s + sub + TPR * i]) : 0.0f;
    acc[i] = 0.0f;
  }
  float m = -INFINITY, l = 0.0f;

  // causal block skip: the block's last row sees keys <= q0 + BQ - 1 + off
  int kv_end = Sk;
  if (causal) kv_end = max(0, min(Sk, q0 + BQ + off));

  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    for (int i = t; i < BKV * D; i += NT) {
      const int j = i / D, d = i % D;
      const int gk = k0 + j;
      const bool in = gk < Sk;
      ks[i] = in ? to_f32(kp[gk * sk_.s + d]) : 0.0f;
      vs[i] = in ? to_f32(vp[gk * sv_.s + d]) : 0.0f;
    }
    __syncthreads();
    // scores of this row against the tile: a partial dot product per lane,
    // summed over the row's TPR lanes (every lane gets the same sum)
    float mt = -INFINITY;
#pragma unroll 2
    for (int j = 0; j < BKV; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) dot = fmaf(qr[i], ks[j * D + sub + TPR * i], dot);
#pragma unroll
      for (int w = TPR / 2; w > 0; w >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, w);
      dot = scale_div ? dot / scale : dot * scale;
      const int gk = k0 + j;
      const bool keep = gk < Sk && (!causal || gk <= row + off);
      const float sc = keep ? dot : -INFINITY;
      if (sub == 0) ps[j * BQ + rl] = sc;
      mt = fmaxf(mt, sc);
    }
    __syncwarp();
    const float m_new = fmaxf(m, mt);
    if (m_new != -INFINITY) {  // else nothing visible yet: keep l = 0
      const float alpha = expf(m - m_new);  // 0 while m is still -inf
      l *= alpha;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll 2
      for (int j = 0; j < BKV; ++j) {
        const float pj = expf(ps[j * BQ + rl] - m_new);
        l += pj;
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] = fmaf(pj, vs[j * D + sub + TPR * i], acc[i]);
      }
      m = m_new;
    }
    __syncthreads();
  }

  if (valid) {
    const float inv = l > 0.0f ? 1.0f / l : 0.0f;  // fully masked row -> 0
#pragma unroll
    for (int i = 0; i < DPT; ++i) op[row * so_.s + sub + TPR * i] = from_f32<T>(acc[i] * inv);
  }
}

// ---- bf16 views TMA cannot take: WMMA (mma.sync) -------------------------------

constexpr int TQ = 64, TKV = 64;  // query rows (4 warps x 16) and keys per tile

// row pitches (elements) of the WMMA kernel's tiles; the score tile also
// stages the output rows, so it is at least D wide
__host__ __device__ constexpr int wm_ldk(int d) { return d + 8; }
__host__ __device__ constexpr int wm_lds(int d) { return (d > TKV ? d : TKV) + 4; }
constexpr int WM_LDP = TKV + 8;
// Q stays in registers as WMMA fragments up to D = 128; at D = 256 (16
// fragments beside 16 output accumulators) it stays in shared memory
__host__ __device__ constexpr bool wm_qreg(int d) { return d <= 128; }

// 128 bytes of slack to align the tiles, then Q (when not in registers),
// K, V, the scores / output staging tile, P and the per-row factors
__host__ __device__ constexpr int wm_smem_bytes(int d) {
  return 128 + (wm_qreg(d) ? 0 : TQ * wm_ldk(d) * 2) + 2 * TKV * wm_ldk(d) * 2 +
         4 * 16 * wm_lds(d) * 4 + 4 * 16 * WM_LDP * 2 + 4 * 16 * 4;
}

template <int D>
__global__ void __launch_bounds__(128)
    flash_wmma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, Strides sq_, Strides sk_,
                      Strides sv_, Strides so_, int H, int KVH, int Sq, int Sk,
                      float scale, int scale_div, int causal, int vec) {
  using namespace nvcuda;
  constexpr int LDK = wm_ldk(D), LDS = wm_lds(D), LDP = WM_LDP, ND = D / 16;
  constexpr bool QREG = wm_qreg(D);
  extern __shared__ uint8_t wm_raw[];
  uint8_t* base = wm_raw + ((128 - (hopper::smem_u32(wm_raw) & 127)) & 127);
  using KTile = __nv_bfloat16 (*)[LDK];
  KTile Qs = reinterpret_cast<KTile>(base);  // stages Q (Ks does, with QREG)
  KTile Ks = reinterpret_cast<KTile>(base + (QREG ? 0 : TQ * LDK * 2));
  KTile Vs = Ks + TKV;
  float (*Ss)[16][LDS] = reinterpret_cast<float (*)[16][LDS]>(Vs + TKV);  // scores; O staging
  __nv_bfloat16 (*Ps)[16][LDP] = reinterpret_cast<__nv_bfloat16 (*)[16][LDP]>(Ss + 4);
  float (*rowv)[16] = reinterpret_cast<float (*)[16]>(Ps + 4);  // per-row correction, then 1 / l
  if (QREG) Qs = Ks;
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

  load_tile(Qs, qp, sq_.s, q0, Sq);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa[QREG ? ND : 1];
  if constexpr (QREG) {
#pragma unroll
    for (int kd = 0; kd < ND; ++kd) wmma::load_matrix_sync(qa[kd], &Qs[warp * 16][kd * 16], LDK);
    __syncthreads();  // Ks, which staged Q, is overwritten next
  }

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
        if constexpr (QREG) {
          wmma::mma_sync(sf, qa[kd], kb, sf);
        } else {
          wmma::load_matrix_sync(qa[0], &Qs[warp * 16][kd * 16], LDK);
          wmma::mma_sync(sf, qa[0], kb, sf);
        }
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
  static const bool once = (cudaFuncSetAttribute(flash_wmma_kernel<D>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 wm_smem_bytes(D)),
                            true);
  (void)once;
  dim3 grid((Sq + TQ - 1) / TQ, B * H);
  flash_wmma_kernel<D><<<grid, 128, wm_smem_bytes(D), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq, sk, sv,
      so, H, KVH, Sq, Sk, scale, scale_div, causal, vec);
}

// ---- bf16 on the tensor cores through wgmma ------------------------------------

constexpr int FW_Q = 128;        // query rows per CTA: two consumer warpgroups of 64
constexpr int FW_STAGES = 3;     // K / V ring depth: tile t + 1 is read while t is in use
constexpr int FW_THREADS = 384;  // two consumer warpgroups and the producer's
constexpr int RED = 4;           // independent partial maxima / sums a row

// The tile layout of a head dim.  A tile row of D bf16 is split into NB
// column blocks of BW columns; each block is its own TMA box and its own
// swizzled tile of row pitch SW = 2 BW bytes (the swizzle span).  D <= 64
// is one block (SW = 32, 64 or 128).  D = 96, 112 and 128 are padded to
// DP = 128, two 64-column blocks of 128 bytes a row: TMA fills the columns
// past D with zeros, which add nothing to Q K^T and give output columns
// that are never stored.  The wider O accumulator (64 fp32 a thread)
// takes K / V tiles of 64 keys, not 128, so the S registers of this tile
// and the next still fit beside it.
template <int D>
struct FwLayout {
  static constexpr int DP = D <= 64 ? D : 128;
  static constexpr int BW = DP <= 64 ? DP : 64;
  static constexpr int NB = DP / BW;
  static constexpr int SW = 2 * BW;
  static constexpr int BKV = DP <= 64 ? 128 : 64;
  static constexpr int Q_BLOCK = FW_Q * SW, KV_BLOCK = BKV * SW;
  static constexpr int Q_BYTES = NB * Q_BLOCK, KV_BYTES = NB * KV_BLOCK;
};

// 1024 bytes of slack to align the tiles for their swizzle, Q, the ring
// of K and V tiles, and the barriers (Q, then full K, full V and empty
// per stage)
template <int D>
__host__ __device__ constexpr int fw_smem_bytes() {
  using L = FwLayout<D>;
  return 1024 + L::Q_BYTES + 2 * FW_STAGES * L::KV_BYTES + (1 + 3 * FW_STAGES) * 8;
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T of one K tile into sacc (64 x BKV per warpgroup), committed
// and left running: the caller waits (the first k-step overwrites sacc).
// k-step kk is 16 columns of D: block kk / (BW / 16), 32 bytes a step
template <int D>
__device__ __forceinline__ void issue_qk(float (&sacc)[FwLayout<D>::BKV / 2], uint64_t dq,
                                         uint64_t dk) {
  using namespace hopper;
  using L = FwLayout<D>;
  constexpr int STEPS = L::BW / 16;
  fence_regs(sacc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::DP / 16; ++kk) {
    const uint64_t a = desc_add(dq, (kk / STEPS) * L::Q_BLOCK + 32 * (kk % STEPS));
    const uint64_t b = desc_add(dk, (kk / STEPS) * L::KV_BLOCK + 32 * (kk % STEPS));
    if constexpr (L::BKV == 128) {
      wgmma_ss_n128<0>(sacc, a, b, kk > 0);
    } else {
      wgmma_ss_n64<0>(sacc, a, b, kk > 0);
    }
  }
  wgmma_commit();
}

// O[:, block] += P V[:, block]: one m64nBWk16 wgmma, V read MN-major
template <int BW>
__device__ __forceinline__ void issue_pv(float (&oacc)[BW / 2], const uint32_t (&pa)[4],
                                         uint64_t dv) {
  using namespace hopper;
  if constexpr (BW == 64) {
    wgmma_rs_n64<1>(oacc, pa, dv, 1);
  } else if constexpr (BW == 32) {
    wgmma_rs_n32<1>(oacc, pa, dv, 1);
  } else {
    wgmma_rs_n16<1>(oacc, pa, dv, 1);
  }
}

// grid (B * H, ceil(Sq / 128))
template <int D>
__global__ void __launch_bounds__(FW_THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                       Strides so, int H, int KVH, int Sq, int Sk, float scale_log2,
                       int causal) {
  using namespace hopper;
  using L = FwLayout<D>;
  constexpr int SW = L::SW, BW = L::BW, NB = L::NB, BKV = L::BKV;
  constexpr int Q_BYTES = L::Q_BYTES, KV_BYTES = L::KV_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + Q_BYTES;
  uint8_t* vs = ks + FW_STAGES * KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + FW_STAGES * KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + FW_STAGES;
  uint64_t* empty = v_full + FW_STAGES;

  // blocks start in launch order: every head's causally longest query
  // tile first, the shortest last, so the long ones do not trail
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KVH);
  const int q0 = qt * FW_Q, off = Sk - Sq;
  // causal tile skip: the CTA's last row sees keys <= q0 + 127 + off
  const int kv_end = causal ? max(0, min(Sk, q0 + FW_Q + off)) : Sk;
  const int n_tiles = (kv_end + BKV - 1) / BKV;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: Q once, then K and V tiles through the ring
    setmaxnreg_dec<40>();
    if (warp == 0 && lane == 0) {
      mbar_expect_tx(q_full, Q_BYTES);
      for (int nb = 0; nb < NB; ++nb)
        tma_load_4d(qs + nb * L::Q_BLOCK, &tq, q_full, nb * BW, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % FW_STAGES;
        mbar_wait(&empty[s], ((t / FW_STAGES) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], KV_BYTES);
        for (int nb = 0; nb < NB; ++nb)
          tma_load_4d(ks + s * KV_BYTES + nb * L::KV_BLOCK, &tk, &k_full[s], nb * BW, t * BKV,
                      kvh, b);
        mbar_expect_tx(&v_full[s], KV_BYTES);
        for (int nb = 0; nb < NB; ++nb)
          tma_load_4d(vs + s * KV_BYTES + nb * L::KV_BLOCK, &tv, &v_full[s], nb * BW, t * BKV,
                      kvh, b);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int wrow = q0 + 64 * wg;                    // this warpgroup's first row
    const int row0 = wrow + 16 * warp + lane / 4;     // this thread's rows: row0, row0 + 8
    float oacc[NB][BW / 2];  // output columns nb * BW + (accumulator layout)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < BW / 2; ++i) oacc[nb][i] = 0.0f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
    // Q and K tiles: K-major operands (D contiguous); V: MN-major (D is N)
    const uint64_t dq = make_desc(qs + 64 * wg * SW, 16, 8 * SW, SW);
    auto k_desc = [&](int t) { return make_desc(ks + (t % FW_STAGES) * KV_BYTES, 16, 8 * SW, SW); };

    float sacc[BKV / 2], snext[BKV / 2];
    if (n_tiles > 0) {
      mbar_wait(q_full, 0);
      mbar_wait(&k_full[0], 0);
      issue_qk<D>(sacc, dq, k_desc(0));
      wgmma_wait<0>();
      fence_regs(sacc);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % FW_STAGES;
      const uint32_t ph = (t / FW_STAGES) & 1;
      const int k0 = t * BKV;
      // the next tile's scores run on the tensor cores during this softmax
      const bool more = t + 1 < n_tiles;
      if (more) {
        mbar_wait(&k_full[(t + 1) % FW_STAGES], ((t + 1) / FW_STAGES) & 1);
        issue_qk<D>(snext, dq, k_desc(t + 1));
      }

      // online softmax on the registers, in the log2 domain; keys past Sk
      // and, on the diagonal, past a row's last visible key are -inf
      // (row maxima and sums in RED independent partials: a single running
      // value would chain BKV / 4 dependent operations a row)
      const bool edge = k0 + BKV > Sk || (causal && k0 + BKV - 1 > wrow + off);
      float mxp[2][RED];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r = 0; r < RED; ++r) mxp[i][r] = -INFINITY;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = sacc[4 * j + 2 * i + e] * scale_log2;
            if (edge) {
              const int key = k0 + 8 * j + 2 * (lane % 4) + e;
              if (key >= Sk || (causal && key > row0 + 8 * i + off)) v = -INFINITY;
            }
            sacc[4 * j + 2 * i + e] = v;
            mxp[i][j % RED] = fmaxf(mxp[i][j % RED], v);
          }
        }
      }
      float mx[2], alpha[2], base[2], ls[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // the four lanes of a quad share a row
        mx[i] = mxp[i][0];
#pragma unroll
        for (int r = 1; r < RED; ++r) mx[i] = fmaxf(mx[i], mxp[i][r]);
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_run[i], mx[i]);
        base[i] = m_new == -INFINITY ? 0.0f : m_new;  // nothing visible yet: p = 0
        alpha[i] = ex2(m_run[i] - base[i]);             // 0 while m_run is -inf
        m_run[i] = m_new;
      }
      float lsp[2][RED];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r = 0; r < RED; ++r) lsp[i][r] = 0.0f;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(sacc[4 * j + 2 * i + e] - base[i]);
            sacc[4 * j + 2 * i + e] = p;
            lsp[i][j % RED] += p;
          }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ls[i] = lsp[i][0];
#pragma unroll
        for (int r = 1; r < RED; ++r) ls[i] += lsp[i][r];
        ls[i] += __shfl_xor_sync(0xffffffffu, ls[i], 1);
        ls[i] += __shfl_xor_sync(0xffffffffu, ls[i], 2);
        l_run[i] = l_run[i] * alpha[i] + ls[i];
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < BW / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            oacc[nb][4 * j + 2 * i] *= alpha[i];
            oacc[nb][4 * j + 2 * i + 1] *= alpha[i];
          }
      // P in bf16 (the reference casts P to V's dtype) as wgmma's register
      // A operand: the accumulator layout taken 16 columns at a time
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);

      // O += P V, one wgmma per 16 keys and column block
      mbar_wait(&v_full[s], ph);
      const uint64_t dv = make_desc(vs + s * KV_BYTES, L::KV_BLOCK, 8 * SW, SW);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_regs(oacc[nb]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          issue_pv<BW>(oacc[nb], pa[kk], desc_add(dv, nb * L::KV_BLOCK + 16 * SW * kk));
      wgmma_commit();
      wgmma_wait<0>();  // P V and the next tile's scores are done
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_regs(oacc[nb]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
      if (more) {
        fence_regs(snext);
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) sacc[i] = snext[i];
      }
    }

    __nv_bfloat16* op = o + b * so.b + h * so.h;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
      if (r >= Sq) continue;
      const float inv = l_run[i] > 0.0f ? 1.0f / l_run[i] : 0.0f;  // fully masked row -> 0
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < BW / 8; ++j)
          if (nb * BW + 8 * j < D)  // the padded columns of D = 96 and 112 are not stored
            *reinterpret_cast<__nv_bfloat162*>(op + r * so.s + nb * BW + 8 * j + 2 * (lane % 4)) =
                __floats2bfloat162_rn(oacc[nb][4 * j + 2 * i] * inv,
                                      oacc[nb][4 * j + 2 * i + 1] * inv);
    }
  }
}

// TMA over the (B, heads, S, D) view, innermost first: dims (D, S, heads,
// B), boxes of one column block (BW x rows); a dimension of size 1 is
// never stepped, so its stride is free
template <int D>
bool encode_view(CUtensorMap* map, const void* base, Strides st, int B, int heads, int S,
                 int rows) {
  using L = FwLayout<D>;
  auto bytes = [](long long stride, int size) -> uint64_t {
    return size == 1 ? 16 : (uint64_t)stride * 2;
  };
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)S, (uint64_t)heads, (uint64_t)B};
  const uint64_t strides[3] = {bytes(st.s, S), bytes(st.h, heads), bytes(st.b, B)};
  const uint32_t box[4] = {(uint32_t)L::BW, (uint32_t)rows, 1, 1};
  return hopper::encode_bf16(map, base, 4, dims, strides, box, L::SW);
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, Strides sq, Strides sk,
                 Strides sv, Strides so, int B, int H, int KVH, int Sq, int Sk, float scale,
                 int scale_div, int causal, cudaStream_t stream) {
  using L = FwLayout<D>;
  CUtensorMap tq, tk, tv;
  if (Sk <= 0 || !encode_view<D>(&tq, q, sq, B, H, Sq, FW_Q) ||
      !encode_view<D>(&tk, k, sk, B, KVH, Sk, L::BKV) ||
      !encode_view<D>(&tv, v, sv, B, KVH, Sk, L::BKV))
    return (int)cudaErrorInvalidValue;
  static const bool once = (cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 fw_smem_bytes<D>()),
                            true);
  (void)once;
  const float eff = scale_div ? 1.0f / scale : scale;
  const dim3 grid(B * H, (Sq + FW_Q - 1) / FW_Q);
  flash_wgmma_kernel<D><<<grid, FW_THREADS, fw_smem_bytes<D>(), stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), so, H, KVH, Sq, Sk,
      eff * 1.4426950408889634f, causal);
  return 0;
}

// ---- dispatch -------------------------------------------------------------

enum Variant { V_FMA = 0, V_WGMMA = 2, V_WMMA = 3 };  // kernels/flash_attention.py

// D = 256 has no wgmma instantiation: its O accumulator (128 fp32 a
// thread) and the S registers of two tiles do not fit one thread's 232
template <int D>
constexpr bool has_wgmma() { return D <= 128; }

template <int D>
int smem_d(int dtype, int variant) {
  if (dtype == FORGE_F32 && variant == V_FMA) return fma_smem_bytes(D);
  if (dtype == FORGE_BF16 && variant == V_WMMA) return wm_smem_bytes(D);
  if constexpr (has_wgmma<D>())
    if (dtype == FORGE_BF16 && variant == V_WGMMA) return fw_smem_bytes<D>();
  return -1;
}

template <int D>
int launch_d(int dtype, int variant, const void* q, const void* k, const void* v, void* o,
             Strides sq, Strides sk, Strides sv, Strides so, int B, int H, int KVH, int Sq,
             int Sk, float scale, int scale_div, int causal, cudaStream_t stream) {
  if (dtype == FORGE_F32 && variant == V_FMA) {
    static const bool once = (cudaFuncSetAttribute(flash_kernel<float, D>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   fma_smem_bytes(D)),
                              true);
    (void)once;
    dim3 grid((Sq + BQ - 1) / BQ, B * H);
    flash_kernel<float, D><<<grid, BQ * fma_tpr(D), fma_smem_bytes(D), stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), sq, sk, sv, so, H, KVH, Sq, Sk,
        scale, scale_div, causal);
    return 0;
  }
  if constexpr (has_wgmma<D>())
    if (dtype == FORGE_BF16 && variant == V_WGMMA)
      return launch_wgmma<D>(q, k, v, o, sq, sk, sv, so, B, H, KVH, Sq, Sk, scale, scale_div,
                             causal, stream);
  if (dtype == FORGE_BF16 && variant == V_WMMA) {
    launch_wmma<D>(q, k, v, o, sq, sk, sv, so, B, H, KVH, Sq, Sk, scale, scale_div, causal,
                   stream);
    return 0;
  }
  return (int)cudaErrorInvalidValue;
}

// calls f.template operator()<D>() for the head dims the kernels are built for
template <typename F>
int with_head_dim(int D, F&& f) {
  switch (D) {
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

// strides: 4 views x (b, h, s) element strides, in the order q, k, v, o;
// variant: the kernel kernels/flash_attention.py chose (refused with a
// non-zero return where it cannot run)
extern "C" int forge_flash_attention(const void* q, const void* k,
                                     const void* v, void* o,
                                     const long long* strides, int B, int H,
                                     int KVH, int Sq, int Sk, int D,
                                     float scale, int scale_div, int causal,
                                     int dtype, int variant, void* stream) {
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = with_head_dim(D, [&](auto d) {
    return launch_d<decltype(d)::value>(dtype, variant, q, k, v, o, sq, sk, sv, so, B, H, KVH,
                                        Sq, Sk, scale, scale_div, causal, s);
  });
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// the dynamic shared memory (bytes) one CTA of the variant uses at head
// dim D, or -1 where the library has no such kernel
extern "C" int forge_flash_attention_smem(int dtype, int variant, int D) {
  const int rc = with_head_dim(D, [&](auto d) { return smem_d<decltype(d)::value>(dtype, variant); });
  return rc == (int)cudaErrorInvalidValue ? -1 : rc;
}
