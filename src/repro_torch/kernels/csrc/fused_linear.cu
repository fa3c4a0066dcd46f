// Fused linear + bias + activation: y = act(x @ w + b).
//
// Replaces the TPU kernel src/repro/kernels/fused_linear.py
// (fused_linear_pallas -> _forward -> _linear_kernel), the dispatch
// target of every `forge.linear_act` graph node.  x is (M, K), w is
// (K, N), both row-major; the sum runs in fp32, and the bias and the
// activation (the Pallas kernel's _apply_act_f32) are applied in fp32 to
// the accumulator before one rounding store.  Ragged M, N and K edges are
// masked inside the kernels.
//
// What bounds it on the H100.  The product does 2*M*K*N operations on
// K*N weight bytes, M/2 operations a weight byte against the ~295 the
// card needs before its tensor cores are the limit.  So at decode
// (M <= 16) and at the served prefill cells (M = 32..256) the weight read
// bounds it (recurrentgemma-2b's four rec-layer weights, 105 MB: 31 us at
// 3.35 TB/s), and only the full-sequence forward (M = 2048..4096) is
// bound by the tensor cores.  To stream weights at the card's rate a
// call needs loads in flight on every SM; to feed the tensor cores it
// needs wgmma fed from a pipelined shared-memory ring.
//
// The plan (kernels/fused_linear.py `plan`, a pure function of M, N, K,
// the dtype and the operands' alignment) picks one of four variants and
// its tiles; the entry point refuses a plan it cannot run:
//
// * gemv (M <= 16, 16-byte-aligned rows; bf16 and f32).  One launch that
//   streams w once.  Each lane loads 16 bytes (8 bf16 columns) of a weight
//   row, six rows' loads in flight per thread, L1 bypassed; the block's
//   x rows (at most 16) are copied into shared memory with cp.async and
//   read as broadcasts.  K is split across the CTAs of a thread-block
//   cluster of up to 8 so that every served decode shape has at least
//   132 CTAs (three fit on an SM).  Each CTA reduces its warps' sums in
//   shared memory and stores each sum into the shared memory of the rank
//   that owns that output (distributed shared memory, one cluster
//   barrier); the owner adds the ranks' sums in rank order, applies bias
//   and activation and stores once: no fp32 workspace in device memory,
//   no second launch, no atomics, so results are bitwise repeatable.
// * wgmma (M > 16, bf16, TMA-legal operands: 16-byte-aligned bases,
//   K % 8 == 0 and N % 8 == 0, which every served shape is).  One CTA per
//   BM x 128 output tile (BM = 64 for M <= 64, else 128): a producer
//   warp keeps TMA loads of x (K-major, 128-byte swizzle) and of w (read
//   as an MN-major B operand through the descriptor's transpose bit: no
//   transposed copy of the weights) in flight in a ring of `stages`
//   64-deep K stages with mbarriers; two consumer warpgroups run
//   m64n128k16 (or m64n64k16) wgmma with fp32 accumulators in registers
//   and the epilogue works on those registers (the activation a template
//   argument, so that the unrolled epilogue holds one activation's code).
//   TMA zero-fills out-of-bounds rows and columns.  Where the output tiles
//   alone give fewer CTAs than the card has SMs (the served M = 32..256
//   cells), K is split across a cluster: each rank parks its partial tile
//   in its ring, and each rank sums its share of the tile's rows over the
//   ranks in rank order with 16-byte distributed-shared-memory loads.
// * wmma (bf16 operands TMA cannot take: an unaligned base, K or N not a
//   multiple of 8).  128 x 128 tiles on mma.sync (WMMA 16x16x16), K in
//   synchronous steps of 32; the epilogue stages each fragment through
//   shared memory.  No served shape reaches it.
// * fma (f32 with M > 16 or unaligned rows): fp32 FMA tiles (64 x 64, or
//   128 x 128 with an 8 x 8 register block per thread from M = 257 on),
//   since the tensor cores would round f32 inputs to TF32.
//
// Measured (chip_smoke.py phase 2: H100 80GB HBM3 at 700 W, device time
// with the L2 flushed, beside one PyTorch call for the same function; more
// in PERF.md §6): a forge-125m layer's three launches take 0.0211 ms at
// M = 4 (library 0.0190) and 0.1481 ms at M = 4096 (0.0863); a
// recurrentgemma-2b rec layer's four 0.0659 ms at M = 4 (0.0627), 0.1132
// ms at M = 128 (0.0689) and 0.4005 ms at M = 2048 (0.2792); an xlstm-350m
// mLSTM layer's two 0.0153 ms at M = 4 (0.0139) and 0.0263 ms at M = 128
// (0.0140).  The split-K and WMMA kernels these variants replaced took
// 0.0366 ms (forge-125m, M = 4), 0.5496 ms (M = 4096), 1.3176 ms
// (recurrentgemma-2b, M = 128) and 0.2803 ms (xlstm-350m, M = 128).
#include "common.cuh"
#include "hopper.cuh"

#include <mma.h>
#include <stdint.h>

namespace {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3, ACT_GELU_EXACT = 4, ACT_TANH = 5 };

// the epilogue in fp32: the Pallas kernel's _apply_act_f32
__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(v, 0.0f);
    case ACT_SILU:
      return v / (1.0f + expf(-v));
    case ACT_GELU: {  // tanh approximation (jax.nn.gelu default)
      const float c1 = 0.7978845608028654f, c0 = 0.044715f;
      return 0.5f * v * (1.0f + tanhf(c1 * (v + c0 * v * v * v)));
    }
    case ACT_GELU_EXACT:
      return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
    case ACT_TANH:
      return tanhf(v);
    default:
      return v;
  }
}

// One block computes a BM x BN output tile; each of its
// (BM/TM)*(BN/TN) threads owns TM x TN outputs, strided by the thread
// grid so that neighbouring threads read neighbouring shared-memory
// words and store neighbouring output columns.
template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    fused_linear_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const T* __restrict__ b, T* __restrict__ y, int M,
                        int N, int K, int act) {
  constexpr int TX = BN / TN;  // threads along N
  constexpr int TY = BM / TM;  // threads along M
  constexpr int NT = TX * TY;
  __shared__ float xs[BK][BM + 1];  // x tile, transposed: xs[k][m]
  __shared__ float ws[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x is (M, K) row-major: consecutive threads take consecutive k
    for (int i = tid; i < BM * BK; i += NT) {
      const int mm = i / BK, kk = i % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      xs[kk][mm] = (gm < M && gk < K) ? to_f32(x[(size_t)gm * K + gk]) : 0.0f;
    }
    // w is (K, N) row-major: consecutive threads take consecutive n
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, nn = i % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      ws[kk][nn] = (gk < K && gn < N) ? to_f32(w[(size_t)gk * N + gn]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], c[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) c[j] = ws[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (b != nullptr) v += to_f32(b[gn]);
      y[(size_t)gm * N + gn] = from_f32<T>(apply_act(v, act));
    }
  }
}


// ---- gemv: M <= 16, weights streamed once, K split across a cluster ------------

constexpr int MAX_CLUSTER = 8;  // the portable cluster size: K splits at most 8 ways
constexpr int GV_THREADS = 256, GV_WARPS = GV_THREADS / 32;
constexpr int GV_UNROLL = 6;       // weight rows in flight per thread
constexpr int GV_X_BYTES = 32768;  // shared memory for one sub-chunk of x

// rows of x held in shared memory at once
__host__ __device__ constexpr int gv_ksub(int mt, int esize) {
  return GV_X_BYTES / (mt * esize) < 4096 ? GV_X_BYTES / (mt * esize) : 4096;
}

__host__ __device__ constexpr int gv_smem_bytes(int mt, int bn, int esize) {
  return mt * gv_ksub(mt, esize) * esize + (GV_WARPS + 1) * mt * bn * 4;
}

template <typename T>
__device__ __forceinline__ void unpack16(uint4 v, float (&f)[16 / sizeof(T)]);
template <>
__device__ __forceinline__ void unpack16<float>(uint4 v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x), f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z), f[3] = __uint_as_float(v.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(uint4 v, float (&f)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// grid (cluster, ceil(N / BN)); a cluster spans the grid's x extent
// (three CTAs an SM for M <= 4: the served decode shapes launch up to 256
// CTAs in clusters of 8, which then fit on the card at once)
template <typename T, int MT, int CG>
__global__ void __launch_bounds__(GV_THREADS, MT <= 4 ? 3 : 1)
    fused_linear_gemv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                             const T* __restrict__ b, T* __restrict__ y, int M, int N, int K,
                             int act) {
  using namespace hopper;
  constexpr int VEC = 16 / sizeof(T);   // columns per 16-byte load
  constexpr int BN = CG * VEC;          // columns per CTA
  constexpr int RS = GV_THREADS / CG;   // weight rows walked side by side
  constexpr int KSUB = gv_ksub(MT, sizeof(T));
  extern __shared__ __align__(16) uint8_t smem[];
  T* xs = reinterpret_cast<T*>(smem);                                     // [MT][KSUB]
  float* red = reinterpret_cast<float*>(smem + MT * KSUB * sizeof(T));   // [warp][MT][BN]
  float* part = red + GV_WARPS * MT * BN;  // [rank][MT * BN / cluster]: the owned sums

  const int rank = cluster_rank(), csize = gridDim.x;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int slot = tid / CG, col = n0 + (tid % CG) * VEC;
  const int units = (K + 7) / 8;  // the K split is in units of 8 rows
  const int kb = rank * units / csize * 8, ke = min(K, (rank + 1) * units / csize * 8);

  float acc[MT][VEC];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[m][v] = 0.0f;

  // the weight rows of one batch: r0, r0 + RS, ... r0 + (GV_UNROLL - 1) * RS
  auto load = [&](uint4 (&wv)[GV_UNROLL], int ks, int rows, int r0) {
#pragma unroll
    for (int u = 0; u < GV_UNROLL; ++u) {
      const int r = r0 + u * RS;
      wv[u] = r < rows && col < N ? ld_stream_16(w + (size_t)(ks + r) * N + col)
                                  : make_uint4(0, 0, 0, 0);
    }
  };
  for (int ks = kb; ks < ke; ks += KSUB) {
    const int rows = min(KSUB, ke - ks);  // a multiple of VEC: K % VEC == 0
    const int chunks = rows / VEC;
    __syncthreads();  // the previous sub-chunk's reads of xs are done
    for (int i = tid; i < MT * chunks; i += GV_THREADS) {
      const int m = i / chunks, q = i % chunks;
      cp_async_16(xs + m * KSUB + q * VEC, x + (size_t)min(m, M - 1) * K + ks + q * VEC, m < M);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int r0 = slot; r0 < rows; r0 += RS * GV_UNROLL) {
      uint4 wv[GV_UNROLL];
      load(wv, ks, rows, r0);
#pragma unroll
      for (int u = 0; u < GV_UNROLL; ++u) {
        const int r = r0 + u * RS;
        if (r < rows) {
          float wf[VEC];
          unpack16<T>(wv[u], wf);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float xv = to_f32(xs[m * KSUB + r]);
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[m][v] = fmaf(xv, wf[v], acc[m][v]);
          }
        }
      }
    }
  }

  // the warp's row slots (lanes of equal lane % CG), then the CTA's warps
  // in order, then the cluster's ranks in order: a fixed summation order
#pragma unroll
  for (int off = CG; off < 32; off *= 2)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[m][v] += __shfl_xor_sync(0xffffffffu, acc[m][v], off);
  if (lane < CG) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int v = 0; v < VEC; ++v) red[(warp * MT + m) * BN + lane * VEC + v] = acc[m][v];
  }
  __syncthreads();
  // rank r owns outputs [r, r + 1) * E / csize of the tile; every rank
  // stores its sums of the owner's outputs into the owner's shared memory
  // (slot `rank`), then the owner adds the slots in rank order
  constexpr int E = MT * BN;
  const int slice = E / csize;
  for (int e = tid; e < E; e += GV_THREADS) {
    float s = 0.0f;
#pragma unroll
    for (int wp = 0; wp < GV_WARPS; ++wp) s += red[wp * E + e];
    const int owner = e / slice;
    st_dsmem(dsmem_addr(&part[rank * slice + e - owner * slice], owner), s);
  }
  cluster_sync();  // every rank's sums are in their owners' shared memory
  for (int i = tid; i < slice; i += GV_THREADS) {
    const int e = rank * slice + i;
    const int m = e / BN, gc = n0 + e % BN;
    if (m >= M || gc >= N) continue;
    float s = 0.0f;
    for (int q = 0; q < csize; ++q) s += part[q * slice + i];
    if (b != nullptr) s += to_f32(b[gc]);
    y[(size_t)m * N + gc] = from_f32<T>(apply_act(s, act));
  }
}

// ---- wgmma: M > 16, bf16, TMA loads in a ring, K split across a cluster -------

constexpr int WG_BK = 64;          // K per stage: one 128-byte row of x
constexpr int WG_BN = 128;         // output columns per CTA
constexpr int WG_THREADS = 384;    // two consumer warpgroups, one producer
constexpr int WG_COL_BYTES = WG_BK * 64 * 2;  // a 64-column block of the w tile: 8 KB

__host__ __device__ constexpr int wg_stage_bytes(int bm, int bn) {
  return (bm + bn) * WG_BK * 2;
}

// 1024 bytes of slack to align the ring for the 128-byte swizzle, the
// ring, and a full and an empty barrier per stage
__host__ __device__ constexpr int wg_smem_bytes(int bm, int bn, int stages) {
  return 1024 + stages * wg_stage_bytes(bm, bn) + 16 * stages;
}

// the fp32 row stride of the partial tile a split K reduces (padded)
__host__ __device__ constexpr int wg_pstride(int bn) { return bn + 4; }

// one consumer warpgroup's 64 x WN tile without a K split: bias and
// activation on the accumulator registers, one bf16x2 store per pair.
// ACT is a template argument so that the unrolled epilogue holds one
// activation's code, not a switch over all of them per element.
template <int ACT, int WN>
__device__ __forceinline__ void store_tile(const float (&acc)[WN / 2],
                                           const __nv_bfloat16* __restrict__ b,
                                           __nv_bfloat16* __restrict__ y, int M, int N, int row,
                                           int col) {
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row + 8 * i, c = col + 8 * j;
      if (r < M && c < N) {  // N % 8 == 0: c < N implies c + 1 < N
        float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
        if (b != nullptr) {
          v0 += __bfloat162float(b[c]);
          v1 += __bfloat162float(b[c + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)r * N + c) =
            __floats2bfloat162_rn(apply_act(v0, ACT), apply_act(v1, ACT));
      }
    }
  }
}

// grid (cluster, ceil(N / 128), ceil(M / BM)); a cluster spans the x extent.
// BM = 128: warpgroup g computes rows 64g..64g+63 and all 128 columns;
// BM = 64: all 64 rows and columns 64g..64g+63.
template <int BM>
__global__ void __launch_bounds__(WG_THREADS, 1)
    fused_linear_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                              const __grid_constant__ CUtensorMap tw,
                              const __nv_bfloat16* __restrict__ b,
                              __nv_bfloat16* __restrict__ y, int M, int N, int K, int act,
                              int stages) {
  using namespace hopper;
  constexpr int BN = WG_BN;
  constexpr int WN = BM == 128 ? BN : BN / 2;  // columns per consumer warpgroup
  constexpr int A_BYTES = BM * WG_BK * 2;
  constexpr int STAGE = wg_stage_bytes(BM, BN);
  constexpr int PSTRIDE = wg_pstride(BN);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * STAGE);
  uint64_t* empty = full + stages;

  const int rank = cluster_rank(), csize = gridDim.x;
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * BM;
  const int nkb = (K + WG_BK - 1) / WG_BK;
  const int kb0 = rank * nkb / csize, kb1 = (rank + 1) * nkb / csize;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread issues every load
    setmaxnreg_dec<40>();
    if (warp == 0 && lane == 0) {
      for (int kb = kb0, it = 0; kb < kb1; ++kb, ++it) {
        const int s = it % stages;
        mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
        uint8_t* a = smem + s * STAGE;
        mbar_expect_tx(&full[s], STAGE);
        tma_load_2d(a, &tx, &full[s], kb * WG_BK, m0);
#pragma unroll
        for (int cb = 0; cb < BN / 64; ++cb)  // w in 64-column blocks (the swizzle span)
          tma_load_2d(a + A_BYTES + cb * WG_COL_BYTES, &tw, &full[s], n0 + 64 * cb, kb * WG_BK);
      }
    }
    if (csize > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
  } else {
    setmaxnreg_inc<232>();
    float acc[WN / 2];
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[i] = 0.0f;
    const int lrow = (BM == 128 ? 64 * wg : 0) + 16 * warp + lane / 4;
    const int lcol = (BM == 128 ? 0 : WN * wg) + 2 * (lane % 4);
    const int a_off = BM == 128 ? wg * 64 * 128 : 0;
    const int b_off = BM == 128 ? 0 : wg * (WN / 64) * WG_COL_BYTES;
    for (int kb = kb0, it = 0; kb < kb1; ++kb, ++it) {
      const int s = it % stages;
      mbar_wait(&full[s], (it / stages) & 1);
      const uint8_t* a = smem + s * STAGE;
      // x: K-major, 1024-byte groups of 8 rows; w: MN-major, groups of 8
      // K-rows 1024 bytes apart and 64-column blocks 8 KB apart
      const uint64_t da = make_desc(a + a_off, 16, 1024, 128);
      const uint64_t db = make_desc(a + A_BYTES + b_off, WG_COL_BYTES, 1024, 128);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        if constexpr (WN == 128) {
          wgmma_ss_n128<1>(acc, desc_add(da, 32 * kk), desc_add(db, 2048 * kk), 1);
        } else {
          wgmma_ss_n64<1>(acc, desc_add(da, 32 * kk), desc_add(db, 2048 * kk), 1);
        }
      }
      wgmma_commit();
      fence_regs(acc);
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % stages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    if (csize == 1) {
      const int r = m0 + lrow, c = n0 + lcol;
      switch (act) {
        case ACT_RELU: store_tile<ACT_RELU, WN>(acc, b, y, M, N, r, c); break;
        case ACT_SILU: store_tile<ACT_SILU, WN>(acc, b, y, M, N, r, c); break;
        case ACT_GELU: store_tile<ACT_GELU, WN>(acc, b, y, M, N, r, c); break;
        case ACT_GELU_EXACT: store_tile<ACT_GELU_EXACT, WN>(acc, b, y, M, N, r, c); break;
        case ACT_TANH: store_tile<ACT_TANH, WN>(acc, b, y, M, N, r, c); break;
        default: store_tile<ACT_NONE, WN>(acc, b, y, M, N, r, c);
      }
    } else {
      // both consumer warpgroups are done with the ring: it holds the
      // partial tile now
      asm volatile("bar.sync 1, 256;" ::: "memory");
      float* part = reinterpret_cast<float*>(smem);
#pragma unroll
      for (int j = 0; j < WN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(&part[(lrow + 8 * i) * PSTRIDE + lcol + 8 * j]) =
              make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      cluster_sync();  // every rank's partial tile is written
      // this rank sums rows [rank, rank + 1) * BM / csize of the tile over
      // ranks 0, 1, ... in that order, all ranks' 16-byte loads in flight
      // at once
      const int rows = BM / csize, r0 = rank * rows;
      for (int e = tid; e < rows * (BN / 4); e += 256) {
        const int lr = r0 + e / (BN / 4), lc = (e % (BN / 4)) * 4;
        const int r = m0 + lr, c = n0 + lc;
        float4 v[MAX_CLUSTER];
#pragma unroll
        for (int q = 0; q < MAX_CLUSTER; ++q)
          if (q < csize) v[q] = ld_dsmem4(dsmem_addr(&part[lr * PSTRIDE + lc], q));
        float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int q = 0; q < MAX_CLUSTER; ++q)
          if (q < csize) o[0] += v[q].x, o[1] += v[q].y, o[2] += v[q].z, o[3] += v[q].w;
        if (r < M && c < N) {  // N % 8 == 0: c < N implies c + 3 < N
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            if (b != nullptr) o[t] += __bfloat162float(b[c + t]);
            o[t] = apply_act(o[t], act);
          }
          __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
          __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
          *reinterpret_cast<uint2*>(y + (size_t)r * N + c) =
              make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
        }
      }
      cluster_sync();  // no CTA leaves while another still reads its partial tile
    }
  }
}

// ---- wmma: bf16 operands TMA cannot take (mma.sync through WMMA) -------------

constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 32;
constexpr int TC_LDA = TC_BK + 8, TC_LDB = TC_BN + 8, TC_LDC = 16 + 4;  // padded rows

__global__ void __launch_bounds__(256)
    fused_linear_wmma_kernel(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ w,
                             const __nv_bfloat16* __restrict__ b,
                             __nv_bfloat16* __restrict__ y, int M, int N, int K,
                             int act, int vec) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[TC_BM][TC_LDA];
  __shared__ __align__(32) __nv_bfloat16 Bs[TC_BK][TC_LDB];
  __shared__ __align__(32) float Cs[8][16][TC_LDC];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += TC_BK) {
    if (vec) {  // 8 bf16 (16 bytes) per load; K, N multiples of 8
      for (int i = tid; i < TC_BM * TC_BK / 8; i += 256) {
        const int r = i / (TC_BK / 8), c = (i % (TC_BK / 8)) * 8;
        const int gm = m0 + r, gk = k0 + c;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (gm < M && gk < K) v = *reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk);
        *reinterpret_cast<uint4*>(&As[r][c]) = v;
      }
      for (int i = tid; i < TC_BK * TC_BN / 8; i += 256) {
        const int r = i / (TC_BN / 8), c = (i % (TC_BN / 8)) * 8;
        const int gk = k0 + r, gn = n0 + c;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (gk < K && gn < N) v = *reinterpret_cast<const uint4*>(w + (size_t)gk * N + gn);
        *reinterpret_cast<uint4*>(&Bs[r][c]) = v;
      }
    } else {
      for (int i = tid; i < TC_BM * TC_BK; i += 256) {
        const int r = i / TC_BK, c = i % TC_BK;
        const int gm = m0 + r, gk = k0 + c;
        As[r][c] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : zero;
      }
      for (int i = tid; i < TC_BK * TC_BN; i += 256) {
        const int r = i / TC_BN, c = i % TC_BN;
        const int gk = k0 + r, gn = n0 + c;
        Bs[r][c] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(a[i], &As[wm * 64 + i * 16][kk], TC_LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(bf[j], &Bs[kk][wn * 32 + j * 16], TC_LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each 16x16 accumulator through this warp's staging tile
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(&Cs[warp][0][0], acc[i][j], TC_LDC, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, c = e % 16;
        const int gm = m0 + wm * 64 + i * 16 + r, gn = n0 + wn * 32 + j * 16 + c;
        if (gm < M && gn < N) {
          float v = Cs[warp][r][c];
          if (b != nullptr) v += __bfloat162float(b[gn]);
          y[(size_t)gm * N + gn] = __float2bfloat16(apply_act(v, act));
        }
      }
      __syncwarp();
    }
  }
}

void launch_wmma(const void* x, const void* w, const void* b, void* y, int M, int N,
                 int K, int act, cudaStream_t stream) {
  const int vec = K % 8 == 0 && N % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(w) % 16 == 0;
  dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM);
  fused_linear_wmma_kernel<<<grid, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(y), M, N, K, act, vec);
}

// ---- fma: f32 tiles on fp32 FMAs --------------------------------------------

template <typename T, int BM, int BN, int BK, int TM, int TN>
void launch_tile(const void* x, const void* w, const void* b, void* y, int M,
                 int N, int K, int act, cudaStream_t stream) {
  constexpr int threads = (BM / TM) * (BN / TN);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fused_linear_kernel<T, BM, BN, BK, TM, TN><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), M, N, K, act);
}


// ---- dispatch -------------------------------------------------------------------

enum Variant { V_FMA = 0, V_GEMV = 1, V_WGMMA = 2, V_WMMA = 3 };
constexpr int MAX_SMEM = 232448;  // the most dynamic shared memory a block may use

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }
bool pow2_le8(int c) { return c == 1 || c == 2 || c == 4 || c == MAX_CLUSTER; }

// let every instantiation use all of the shared memory a block may have
template <typename Kernel>
void allow_smem(Kernel kernel) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
}

template <typename T, int MT, int CG>
cudaError_t launch_gemv(const void* x, const void* w, const void* b, void* y, int M, int N,
                        int K, int act, int cluster, cudaStream_t stream) {
  constexpr int BN = CG * (16 / sizeof(T));
  static const bool once = (allow_smem(fused_linear_gemv_kernel<T, MT, CG>), true);
  (void)once;
  const dim3 grid(cluster, (N + BN - 1) / BN);
  return hopper::launch_cluster(fused_linear_gemv_kernel<T, MT, CG>, grid, GV_THREADS,
                                gv_smem_bytes(MT, BN, sizeof(T)), cluster, stream,
                                static_cast<const T*>(x), static_cast<const T*>(w),
                                static_cast<const T*>(b), static_cast<T*>(y), M, N, K, act);
}

template <typename T, int MT>
cudaError_t gemv_cg(const void* x, const void* w, const void* b, void* y, int M, int N, int K,
                    int act, int cg, int cluster, cudaStream_t stream) {
  if (cg == 8) return launch_gemv<T, MT, 8>(x, w, b, y, M, N, K, act, cluster, stream);
  return launch_gemv<T, MT, 4>(x, w, b, y, M, N, K, act, cluster, stream);
}

template <typename T>
cudaError_t run_gemv(const void* x, const void* w, const void* b, void* y, int M, int N, int K,
                     int act, int bm, int bn, int cluster, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int cg = bn / VEC;
  if ((cg != 8 && cg != 4) || bn % VEC != 0 || M > bm || !pow2_le8(cluster) ||
      !aligned16(x) || !aligned16(w) || K % VEC != 0 || N % VEC != 0)
    return cudaErrorInvalidValue;
  switch (bm) {
    case 1: return gemv_cg<T, 1>(x, w, b, y, M, N, K, act, cg, cluster, stream);
    case 2: return gemv_cg<T, 2>(x, w, b, y, M, N, K, act, cg, cluster, stream);
    case 4: return gemv_cg<T, 4>(x, w, b, y, M, N, K, act, cg, cluster, stream);
    case 8: return gemv_cg<T, 8>(x, w, b, y, M, N, K, act, cg, cluster, stream);
    case 16: return gemv_cg<T, 16>(x, w, b, y, M, N, K, act, cg, cluster, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int BM>
cudaError_t launch_wgmma(const CUtensorMap& tx, const CUtensorMap& tw, const void* b, void* y,
                         int M, int N, int K, int act, int stages, int cluster,
                         cudaStream_t stream) {
  static const bool once = (allow_smem(fused_linear_wgmma_kernel<BM>), true);
  (void)once;
  const dim3 grid(cluster, (N + WG_BN - 1) / WG_BN, (M + BM - 1) / BM);
  return hopper::launch_cluster(fused_linear_wgmma_kernel<BM>, grid, WG_THREADS,
                                wg_smem_bytes(BM, WG_BN, stages), cluster, stream, tx, tw,
                                static_cast<const __nv_bfloat16*>(b),
                                static_cast<__nv_bfloat16*>(y), M, N, K, act, stages);
}

// the (bm, bn) tiles the wgmma kernel is built for
bool wg_tile_ok(int bm, int bn) { return (bm == 64 || bm == 128) && bn == WG_BN; }

cudaError_t run_wgmma(const void* x, const void* w, const void* b, void* y, int M, int N, int K,
                      int act, int bm, int bn, int stages, int cluster, cudaStream_t stream) {
  const int nkb = (K + WG_BK - 1) / WG_BK;
  if (!wg_tile_ok(bm, bn) || stages < 2 || stages > 8 || !pow2_le8(cluster) ||
      cluster > nkb || bm % cluster != 0 || wg_smem_bytes(bm, bn, stages) > MAX_SMEM ||
      !aligned16(x) || !aligned16(w) || K % 8 != 0 || N % 8 != 0)
    return cudaErrorInvalidValue;
  // x: (M, K) row-major, boxes of 64 K x bm rows; w: (K, N) row-major,
  // boxes of 64 N x 64 K; both with the 128-byte swizzle
  CUtensorMap tx, tw;
  const uint64_t xdims[2] = {(uint64_t)K, (uint64_t)M}, xstr[1] = {(uint64_t)K * 2};
  const uint64_t wdims[2] = {(uint64_t)N, (uint64_t)K}, wstr[1] = {(uint64_t)N * 2};
  const uint32_t xbox[2] = {WG_BK, (uint32_t)bm}, wbox[2] = {64, WG_BK};
  if (!hopper::encode_bf16(&tx, x, 2, xdims, xstr, xbox, 128) ||
      !hopper::encode_bf16(&tw, w, 2, wdims, wstr, wbox, 128))
    return cudaErrorInvalidValue;
  if (bm == 64) return launch_wgmma<64>(tx, tw, b, y, M, N, K, act, stages, cluster, stream);
  return launch_wgmma<128>(tx, tw, b, y, M, N, K, act, stages, cluster, stream);
}

}  // namespace

// Shared memory (bytes) one CTA of the plan uses, or -1 for a plan the
// entry point refuses on its tiles alone; kernels/fused_linear.py
// computes the same from the plan (chip_smoke.py holds the two equal).
extern "C" int forge_fused_linear_smem(int dtype, int variant, int bm, int bn, int stages) {
  const int esize = dtype == FORGE_BF16 ? 2 : 4;
  if (variant == V_GEMV) {
    const int cg = bn * esize / 16;
    if ((cg != 8 && cg != 4) || (bm != 1 && bm != 2 && bm != 4 && bm != 8 && bm != 16)) return -1;
    return gv_smem_bytes(bm, bn, esize);
  }
  if (variant == V_WGMMA) {
    if (dtype != FORGE_BF16 || !wg_tile_ok(bm, bn)) return -1;
    return wg_smem_bytes(bm, bn, stages);
  }
  return 0;  // the fma and wmma kernels use static shared memory only
}

// y = act(x @ w + b) with the plan (variant, bm, bn, stages, cluster)
// chosen by kernels/fused_linear.py; returns a CUDA error code, non-zero
// for a plan the entry point cannot run or a refused launch.
extern "C" int forge_fused_linear(const void* x, const void* w, const void* b, void* y, int M,
                                  int N, int K, int dtype, int act, int variant, int bm, int bn,
                                  int stages, int cluster, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaErrorInvalidValue;
  if (dtype == FORGE_F32) {
    if (variant == V_GEMV) {
      rc = run_gemv<float>(x, w, b, y, M, N, K, act, bm, bn, cluster, s);
    } else if (variant == V_FMA && bm == 64) {
      launch_tile<float, 64, 64, 16, 4, 4>(x, w, b, y, M, N, K, act, s);
      rc = cudaSuccess;
    } else if (variant == V_FMA && bm == 128) {
      launch_tile<float, 128, 128, 8, 8, 8>(x, w, b, y, M, N, K, act, s);
      rc = cudaSuccess;
    }
  } else if (dtype == FORGE_BF16) {
    if (variant == V_GEMV) {
      rc = run_gemv<__nv_bfloat16>(x, w, b, y, M, N, K, act, bm, bn, cluster, s);
    } else if (variant == V_WGMMA) {
      rc = run_wgmma(x, w, b, y, M, N, K, act, bm, bn, stages, cluster, s);
    } else if (variant == V_WMMA) {
      launch_wmma(x, w, b, y, M, N, K, act, s);
      rc = cudaSuccess;
    }
  }
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}
