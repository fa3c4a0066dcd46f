// RMSNorm y = x * rsqrt(mean(x^2, -1) + eps) * w over the last axis.
//
// Replaces the TPU kernel src/repro/kernels/rms_norm.py: rms_norm_pallas
// (pl.pallas_call of _rms_kernel), reached only through kernels/ops.rms_norm,
// as in the JAX package, whose models normalise through the plain
// models/layers.rms_norm.
//
// Semantics kept from the Pallas kernel: x (rows, d) in f32 or bf16, w (d,)
// read as f32 (the wrapper converts it); the mean of squares, the rsqrt and
// both products in fp32; the output in x's dtype, rounded once.
//
// Design.  The TPU kernel tiles rows into (block_rows, d) VMEM blocks with
// the whole feature axis resident (its _shrink picks a block_rows that
// divides the row count, a TPU layout choice not carried over).  Here one
// block normalises one row: its threads read the row once with 16-byte
// vector loads where d and the pointers allow (8 bf16 or 4 f32 elements a
// load; otherwise one element a load, for any ragged d), keep up to 16
// elements a thread in registers, sum their squares in fp32 (warp shuffle,
// then one value a warp through shared memory), and scale and store the
// kept values without reading x again.  A row longer than the registers
// hold (more than 16 elements for each of 1024 threads) reads its tail a
// second time.  Threads: one vector each up to 256, more per thread above.
//
// Bound on the H100.  The function must read x and w once and write y once:
// (2 x rows x d) elements plus d weights; the arithmetic is 3 operations an
// element.  At xLSTM's shapes (4 to 2048 rows of 512 or 1024, bf16) that is
// 16 KB to 8 MB, 5 ns to 2.5 us at 3.35 TB/s, so the small cases are bound
// by the launch itself and the large ones by memory.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int KEPT = 16;  // elements a thread keeps in registers
constexpr int MAX_THREADS = 1024;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
    rms_norm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    T* __restrict__ out, int d, float eps) {
  constexpr int KEEP = KEPT / VEC;  // vectors a thread keeps
  using XV = Vec<T, VEC>;
  using WV = Vec<float, VEC>;
  const long long row = blockIdx.x;
  const XV* xr = reinterpret_cast<const XV*>(x + row * d);
  XV* yr = reinterpret_cast<XV*>(out + row * d);
  const WV* wr = reinterpret_cast<const WV*>(w);
  const int nvec = d / VEC;
  const int tid = threadIdx.x, nt = blockDim.x;

  float kept[KEEP][VEC];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < KEEP; ++j) {
    const int i = j * nt + tid;
    if (i < nvec) {
      const XV p = xr[i];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        kept[j][e] = to_f32<T>(p.v[e]);
        ss = fmaf(kept[j][e], kept[j][e], ss);
      }
    }
  }
  for (int i = KEEP * nt + tid; i < nvec; i += nt) {
    const XV p = xr[i];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float f = to_f32<T>(p.v[e]);
      ss = fmaf(f, f, ss);
    }
  }

  __shared__ float part[MAX_THREADS / 32];
  __shared__ float scale;
  const int lane = tid & 31, warp = tid >> 5;
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < (nt + 31) / 32 ? part[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) scale = rsqrtf(v / (float)d + eps);
  }
  __syncthreads();
  const float r = scale;

#pragma unroll
  for (int j = 0; j < KEEP; ++j) {
    const int i = j * nt + tid;
    if (i < nvec) {
      const WV wv = wr[i];
      XV o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) o.v[e] = from_f32<T>(kept[j][e] * r * wv.v[e]);
      yr[i] = o;
    }
  }
  for (int i = KEEP * nt + tid; i < nvec; i += nt) {
    const XV p = xr[i];
    const WV wv = wr[i];
    XV o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) o.v[e] = from_f32<T>(to_f32<T>(p.v[e]) * r * wv.v[e]);
    yr[i] = o;
  }
}

int threads_for(int nvec, int keep) {
  auto up32 = [](long long n) { return (int)((n + 31) / 32 * 32); };
  int t = up32(nvec);
  if (t > 256) t = 256;
  if (t < 32) t = 32;
  if ((long long)nvec > 256LL * keep) {
    const long long need = up32(((long long)nvec + keep - 1) / keep);
    t = (int)(need > MAX_THREADS ? MAX_THREADS : need);
  }
  return t;
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int d, float eps,
                   cudaStream_t stream) {
  const int threads = threads_for(d / VEC, KEPT / VEC);
  rms_norm_kernel<T, VEC><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<T*>(out), d, eps);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t dispatch(const void* x, const void* w, void* out, int rows, int d, float eps,
                     cudaStream_t stream) {
  // 16-byte loads need d to split into whole vectors and every row start
  // (x, out) and the weight vector to sit on a vector boundary
  if (d % VEC == 0 && aligned(x, 16) && aligned(out, 16) && aligned(w, 4 * VEC))
    return launch<T, VEC>(x, w, out, rows, d, eps, stream);
  return launch<T, 1>(x, w, out, rows, d, eps, stream);
}

}  // namespace

// x, out: (rows, d) contiguous, dtype code 0 = f32, 1 = bf16; w (d,) f32
// contiguous.  Returns the launch error (0 on success).
extern "C" int forge_rms_norm(const void* x, const void* w, void* out, int rows, int d,
                              float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == FORGE_F32) return (int)dispatch<float, 4>(x, w, out, rows, d, eps, s);
  if (dtype == FORGE_BF16) return (int)dispatch<__nv_bfloat16, 8>(x, w, out, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}
