// RG-LRU linear recurrence h_t = a_t * h_{t-1} + x_t over the time axis.
//
// Replaces the TPU kernels src/repro/kernels/rg_lru.py: rg_lru_pallas
// (_forward -> _rg_lru_kernel) and rg_lru_chunked (_forward_chunk ->
// _rg_lru_chunk_kernel), reached from models/rglru._rg_lru_fused
// (kernels/ops.rg_lru) in the recurrent block's full-sequence forward and
// its chunked state-scan prefill, and from kernels/ops.rg_lru_scan.  One
// source serves both: the chunked entry point also writes last = h[:, T-1].
//
// Semantics kept from the Pallas kernels: x, a (B, T, D) in one dtype
// (f32 or bf16), h0 (B, D) f32 (the wrapper converts it); the carry is
// fp32; out (B, T, D) and last (B, D) have x's dtype, and last is the
// same rounded value as out[:, T-1], bitwise.
//
// Design.  The TPU kernel tiles (B, T, D) into VMEM blocks with T the
// innermost sequential grid axis, runs a Hillis-Steele scan inside each
// block and carries the state in scratch between T-blocks.  Its own
// docstring names the GPU form instead, which this is: one thread per
// (b, d) channel walks T sequentially with the carry in a register.
// Threads of a block take neighbouring d, so every load of x and a and
// every store of out is coalesced along d; a block covers THREADS
// channels of one row b (grid: ceil(D / THREADS) x B), and the ragged
// edge d >= D is masked.  Any T and D work: there is no block-size
// divisibility, unlike the TPU kernel's _shrink.  The loads of UNROLL
// consecutive time steps are issued before their FMAs, so each thread
// keeps UNROLL independent loads of x and a in flight instead of one
// dependent round trip to memory per step.
//
// Bound on the H100.  The function must read x and a and write out once
// (3 x B x T x D elements), plus h0 and last: at the served shapes
// (B 4, T 32 or 64, D 2560 in prefill; B 2, T 1024 in the full-sequence
// forward; f32) 4 to 63 MB, 1.2 to 19 us at 3.35 TB/s.  The arithmetic
// (one FMA per element) is negligible.  B x D threads (5,120 to 10,240)
// fill fewer than the 132 SMs' worth of resident warps and each walks T
// steps in order, so at T = 1024 memory latency along the chain, not
// bandwidth, sets the time.  A T-parallel form (per-chunk (A, X)
// summaries folded in closed form, the TPU kernel's
// out = scan(x) + cumprod(a) * h_in) is later work.
//
// The backward is not a kernel: as the Pallas kernel's custom_vjp does,
// the wrapper's registered autograd recomputes through the plain version.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 8;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rg_lru_kernel(const T* __restrict__ x, const T* __restrict__ a,
                  const float* __restrict__ h0, T* __restrict__ out,
                  T* __restrict__ last, int Tn, int D) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const long long stride = D;
  const long long base = (long long)b * Tn * stride + d;
  float h = h0[(long long)b * D + d];
  int t = 0;
  for (; t + UNROLL <= Tn; t += UNROLL) {
    float xv[UNROLL], av[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + (long long)(t + u) * stride;
      xv[u] = to_f32<T>(x[i]);
      av[u] = to_f32<T>(a[i]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = fmaf(av[u], h, xv[u]);
      out[base + (long long)(t + u) * stride] = from_f32<T>(h);
    }
  }
  for (; t < Tn; ++t) {
    const long long i = base + (long long)t * stride;
    h = fmaf(to_f32<T>(a[i]), h, to_f32<T>(x[i]));
    out[i] = from_f32<T>(h);
  }
  if (last != nullptr) last[(long long)b * D + d] = from_f32<T>(h);
}

template <typename T>
cudaError_t launch(const void* x, const void* a, const void* h0, void* out,
                   void* last, int B, int Tn, int D, cudaStream_t stream) {
  dim3 grid((D + THREADS - 1) / THREADS, B);
  rg_lru_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const float*>(h0), static_cast<T*>(out),
      static_cast<T*>(last), Tn, D);
  return cudaGetLastError();
}

}  // namespace

// x, a, out: (B, T, D) contiguous, dtype code 0 = f32, 1 = bf16; h0 (B, D)
// f32 contiguous; last (B, D) in x's dtype, or null.  Returns the launch
// error (0 on success).
extern "C" int forge_rg_lru(const void* x, const void* a, const void* h0,
                            void* out, void* last, int B, int Tn, int D,
                            int dtype, void* stream) {
  if (B <= 0 || Tn <= 0 || D <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == FORGE_F32) return (int)launch<float>(x, a, h0, out, last, B, Tn, D, s);
  if (dtype == FORGE_BF16)
    return (int)launch<__nv_bfloat16>(x, a, h0, out, last, B, Tn, D, s);
  return (int)cudaErrorInvalidValue;
}
