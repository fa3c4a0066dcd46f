// Fused linear + bias + activation: y = act(x @ w + b).
//
// Replaces the TPU kernel src/repro/kernels/fused_linear.py
// (fused_linear_pallas -> _forward -> _linear_kernel), the dispatch
// target of every `forge.linear_act` graph node.
//
// What bounds it on the H100.  At decode (M = batch, a handful of rows)
// the product does 2*M*K*N operations on K*N weight bytes: about M/2
// operations per weight byte, far below the ~295 the card needs before
// its tensor cores are the limit, so the weight read bounds it
// (forge-125m's FFN up: 768x3072 bf16 = 4.7 MB, 1.4 us at 3.35 TB/s).
// In the full-sequence forward (M = B*S = 4096) the same weights are
// reused M times and the operations bound it.
//
// What the design does about that.  The (M, N) product never round-trips
// through device memory between the matmul, the bias and the activation
// in the tiled path: each block keeps its output tile in fp32 registers
// across the whole K loop and applies bias and activation in the epilogue
// before one store, as the Pallas kernel does on its final K step.
// Unlike the TPU grid, Hopper blocks run in parallel and in no order, so
// the K axis is a loop inside the block, never a sequential grid axis.
// Ragged M, N and K edges are masked inside the kernels (zero-filled
// loads, guarded stores), because the Pallas kernel's divisor tiling
// breaks at M = 4.  The path follows M:
//
// * M <= 16 (decode): split-K.  A 2-D grid of 64-column x 128-row weight
//   tiles gives the card hundreds of blocks streaming weights even for
//   768 output columns; the x rows sit in shared memory and every read
//   of them is a warp broadcast.  Each block writes an fp32 partial sum;
//   a second, elementwise kernel adds the partials in a fixed order
//   (deterministic), then the bias and the activation, and stores once.
//   Only those fp32 partials (splits x M x N) touch device memory.
// * M > 16, bf16: tensor cores through WMMA (mma.sync, 16x16x16 bf16
//   fragments, fp32 accumulators).  A 128x128 output tile per block,
//   8 warps of 64x32 each, K in steps of 32 staged through shared memory
//   with 16-byte loads when the rows are 16-byte aligned.  The epilogue
//   stages each 16x16 accumulator through a per-warp shared-memory tile,
//   where bias and activation are applied in fp32 before one store.
// * M > 16, f32: one block per output tile on fp32 FMAs (64x64, or
//   128x128 with an 8x8 register block per thread from M = 257 on) —
//   the tensor cores would round f32 inputs to TF32.
//
// wgmma, TMA and a pipelined (multi-stage) load are later work.
#include "common.cuh"

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

// ---- decode path: split-K over 64-column x 128-row weight tiles ----------

constexpr int SK_BN = 64;      // output columns per block (two per lane)
constexpr int SK_KCH = 128;    // weight rows per block (its K split)
constexpr int SK_WARPS = 8;

template <typename T, int MT>
__global__ void __launch_bounds__(SK_WARPS * 32)
    splitk_partial_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          float* __restrict__ ws, int M, int N, int K) {
  __shared__ float xs[MT][SK_KCH];
  __shared__ float red[SK_WARPS][MT][SK_BN];
  const int n0 = blockIdx.x * SK_BN, k0 = blockIdx.y * SK_KCH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < MT * SK_KCH; i += SK_WARPS * 32) {
    const int m = i / SK_KCH, kk = i % SK_KCH;
    const int gk = k0 + kk;
    xs[m][kk] = (m < M && gk < K) ? to_f32(x[(size_t)m * K + gk]) : 0.0f;
  }
  __syncthreads();

  // each warp takes every 8th weight row of the block's split; each lane
  // two neighbouring columns, so a warp reads 64 contiguous values a row
  float acc[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m][0] = acc[m][1] = 0.0f;
  const int c = n0 + 2 * lane;
  for (int kk = warp; kk < SK_KCH && k0 + kk < K; kk += SK_WARPS) {
    const size_t row = (size_t)(k0 + kk) * N;
    const float w0 = c < N ? to_f32(w[row + c]) : 0.0f;
    const float w1 = c + 1 < N ? to_f32(w[row + c + 1]) : 0.0f;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float xv = xs[m][kk];
      acc[m][0] = fmaf(xv, w0, acc[m][0]);
      acc[m][1] = fmaf(xv, w1, acc[m][1]);
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    red[warp][m][2 * lane] = acc[m][0];
    red[warp][m][2 * lane + 1] = acc[m][1];
  }
  __syncthreads();
  for (int i = tid; i < MT * SK_BN; i += SK_WARPS * 32) {
    const int m = i / SK_BN, cc = i % SK_BN;
    if (m >= M || n0 + cc >= N) continue;
    float sum = 0.0f;
#pragma unroll
    for (int wp = 0; wp < SK_WARPS; ++wp) sum += red[wp][m][cc];
    ws[((size_t)blockIdx.y * M + m) * N + n0 + cc] = sum;
  }
}

template <typename T>
__global__ void splitk_epilogue_kernel(const float* __restrict__ ws,
                                       const T* __restrict__ b, T* __restrict__ y,
                                       int M, int N, int splits, int act) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  float v = 0.0f;
  for (int p = 0; p < splits; ++p) v += ws[(size_t)p * M * N + i];
  if (b != nullptr) v += to_f32(b[i % N]);
  y[i] = from_f32<T>(apply_act(v, act));
}

int splitk_splits(int M, int K) { return M <= 16 ? (K + SK_KCH - 1) / SK_KCH : 0; }

template <typename T, int MT>
void launch_splitk(const void* x, const void* w, const void* b, void* y, void* ws,
                   int M, int N, int K, int act, cudaStream_t stream) {
  const int splits = splitk_splits(M, K);
  dim3 grid((N + SK_BN - 1) / SK_BN, splits);
  splitk_partial_kernel<T, MT><<<grid, SK_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<float*>(ws), M, N, K);
  const int total = M * N;
  splitk_epilogue_kernel<T><<<(total + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const T*>(b), static_cast<T*>(y), M, N,
      splits, act);
}

// ---- bf16 tensor-core path (M > 16) -----------------------------------------

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

// ---- f32 tiled path ----------------------------------------------------------

template <typename T, int BM, int BN, int BK, int TM, int TN>
void launch_tile(const void* x, const void* w, const void* b, void* y, int M,
                 int N, int K, int act, cudaStream_t stream) {
  constexpr int threads = (BM / TM) * (BN / TN);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fused_linear_kernel<T, BM, BN, BK, TM, TN><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), M, N, K, act);
}

template <typename T>
void launch(const void* x, const void* w, const void* b, void* y, void* ws, int M,
            int N, int K, int act, cudaStream_t stream) {
  if (M <= 4) {
    launch_splitk<T, 4>(x, w, b, y, ws, M, N, K, act, stream);
  } else if (M <= 16) {
    launch_splitk<T, 16>(x, w, b, y, ws, M, N, K, act, stream);
  } else if (M <= 256) {
    launch_tile<T, 64, 64, 16, 4, 4>(x, w, b, y, M, N, K, act, stream);
  } else {
    launch_tile<T, 128, 128, 8, 8, 8>(x, w, b, y, M, N, K, act, stream);
  }
}

}  // namespace

// fp32 workspace (in floats) the call needs: the split-K partial sums at
// decode, none for the tiled path
extern "C" long long forge_fused_linear_workspace(int M, int N, int K) {
  return (long long)splitk_splits(M, K) * M * N;
}

extern "C" int forge_fused_linear(const void* x, const void* w, const void* b,
                                  void* y, void* workspace, int M, int N, int K,
                                  int dtype, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splitk_splits(M, K) > 0 && workspace == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == FORGE_F32) {
    launch<float>(x, w, b, y, workspace, M, N, K, act, s);
  } else if (dtype == FORGE_BF16) {
    if (M > 16) {
      launch_wmma(x, w, b, y, M, N, K, act, s);
    } else {
      launch<__nv_bfloat16>(x, w, b, y, workspace, M, N, K, act, s);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
