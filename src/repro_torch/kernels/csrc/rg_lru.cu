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
// What bounds it on the H100.  The function must read x and a and write
// out once (3 x B x T x D elements), plus h0 and last: at the served
// shapes (B 4, T 32 or 64, D 2560 in prefill; B 2, T 1024 in the
// full-sequence forward; f32) 4 to 63 MB, 1.2 to 19 us at 3.35 TB/s.  The
// arithmetic (two FMAs per element) is negligible, so the bytes bound it
// once enough of them are in flight; with one thread walking each (b, d)
// channel through all T steps (B x D = 5,120 threads at T = 1024, 40
// blocks of 128 on 132 SMs) the dependent chain and the idle SMs set the
// time.
//
// Design.  T is cut into C chunks of L <= 64 steps (kernels/rg_lru.py
// `plan`: as few chunks as the registers allow, since every chunk past the
// first pays a look-back; more, down to 32 steps, only where the grid
// would leave SMs idle).  A block is 64 channels of one row b and one
// chunk, so a short scan still spreads over more than 132 blocks at the
// served widths; each thread loads its channel's L steps of x and a at
// once (2L loads in flight, coalesced along d) and keeps them in
// registers:
// * chunk 0 knows its carry (h0) and runs the sequential FMA chain
//   h = a_t h + x_t, the same chain as a single-chunk plan, which is
//   therefore bitwise equal to the one-thread-per-channel scan;
// * chunk c > 0 scans with a zero carry, s_t = a_t s + x_t, beside the
//   running product P_t = a_t P, publishes its summary (A = P, X = s at
//   its last step), then finds its carry h_in by a chained look-back over
//   its predecessors: one thread walks back from chunk c - 1 to the
//   nearest chunk that has published its inclusive state H, and the
//   threads fold the summaries of the chunks between forward from it,
//   h = fma(A_i, h, X_i).  Every H is that same sequential fold of the
//   summaries from H_0, so the carry does not depend on how far a block
//   had to look back: results are bitwise repeatable.  The block then
//   publishes H_c = fma(A, h_in, X) and writes out_t = fma(P_t, h_in, s_t)
//   from its registers, with no second read of x or a.
// Blocks take their chunk from an atomic ticket, not blockIdx, so a block
// waits only on chunks whose blocks have already started; chunk 0 waits on
// nothing.  The flags carry the call's epoch, so no flag has to be cleared
// between calls; the block that draws the last ticket re-arms the ticket
// to 0.  The epoch lives in device memory beside the ticket: every block
// reads it when it draws its ticket, and the last block to finish with the
// flags advances it (and re-arms the count of blocks done).  So no host
// value enters the launch, and a launch captured in a CUDA graph runs in a
// fresh epoch at every replay.  A multi-chunk result reassociates the
// recurrence, so it differs from the sequential chain by roundings, as the
// TPU kernel's block scan does.
//
// The backward is not a kernel: as the Pallas kernel's custom_vjp does,
// the wrapper's registered autograd recomputes through the plain version.
#include "common.cuh"

namespace {

constexpr int THREADS = 64;  // channels of a block
constexpr int LMAX = 64;      // steps of a chunk, at most: held in registers

__device__ __forceinline__ int ld_flag(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

// grid: tiles x B x C blocks (tiles = ceil(D / 64)).  vals: per (b, tile,
// chunk) the chunk's A, X and H (3 x 64 floats); flags: per (b, tile,
// chunk) epoch * 4 + state (1: A and X published, 2: H published too);
// ctrl: the ticket and the count of blocks done (0 between calls), then
// the epoch
template <typename T>
__global__ void __launch_bounds__(THREADS, 6)
    rg_lru_kernel(const T* __restrict__ x, const T* __restrict__ a,
                  const float* __restrict__ h0, T* __restrict__ out,
                  T* __restrict__ last, int B, int Tn, int D, int L, int C,
                  float* __restrict__ vals, int* __restrict__ flags, int* __restrict__ ctrl) {
  __shared__ int s_idx, s_from, s_epoch;
  const int tid = threadIdx.x;
  int idx = blockIdx.x;
  if (C > 1) {
    if (tid == 0) {
      const int t = atomicAdd(ctrl, 1);
      if (t == (int)gridDim.x - 1) atomicExch(ctrl, 0);  // re-armed for the next call
      s_idx = t;
      // the last call's last block advanced it before this launch began
      s_epoch = ld_flag(ctrl + 2);
    }
    __syncthreads();
    idx = s_idx;
  }
  const int epoch = C > 1 ? s_epoch : 0;
  const int tiles = (D + THREADS - 1) / THREADS;
  const int c = idx / (tiles * B), rest = idx - c * (tiles * B);
  const int b = rest / tiles, tile = rest - b * tiles;
  const int d = tile * THREADS + tid;
  const bool live = d < D;  // the ragged edge: computes, stores nothing
  const int t0 = c * L, n = min(Tn, t0 + L) - t0;
  const long long base = ((long long)b * Tn + t0) * D + d;

  float xv[LMAX], av[LMAX];
#pragma unroll
  for (int i = 0; i < LMAX; ++i) {
    const bool in = live && i < n;
    xv[i] = in ? to_f32<T>(x[base + (long long)i * D]) : 0.0f;
    av[i] = in ? to_f32<T>(a[base + (long long)i * D]) : 1.0f;
  }

  const int series = b * tiles + tile;  // this (b, tile)'s chunks
  float* mine = vals + ((long long)series * C + c) * 3 * THREADS;
  int* flag = flags + (long long)series * C;
  float h;  // the state after this chunk's last step
  if (c == 0) {  // the carry is h0: the sequential chain
    h = live ? h0[(long long)b * D + d] : 0.0f;
#pragma unroll
    for (int i = 0; i < LMAX; ++i)
      if (i < n) {
        h = fmaf(av[i], h, xv[i]);
        xv[i] = h;
      }
    if (C > 1) {
      mine[2 * THREADS + tid] = h;
      __threadfence();
      __syncthreads();
      if (tid == 0) atomicExch(flag, epoch * 4 + 2);
    }
  } else {
    float s = 0.0f, P = 1.0f;  // the zero-carry scan and the running product
#pragma unroll
    for (int i = 0; i < LMAX; ++i)
      if (i < n) {
        s = fmaf(av[i], s, xv[i]);
        P = av[i] * P;
        xv[i] = s;
        av[i] = P;
      }
    const bool publish = c < C - 1;  // the last chunk has no successor
    if (publish) {
      mine[tid] = P;
      mine[THREADS + tid] = s;
      __threadfence();
      __syncthreads();
      if (tid == 0) atomicExch(flag + c, epoch * 4 + 1);
    }
    if (tid == 0) {  // back to the nearest chunk with its H published
      int j = c - 1;
      for (;;) {
        int f;
        while (((f = ld_flag(flag + j)) >> 2) != epoch) __nanosleep(32);
        if ((f & 3) == 2) break;
        --j;  // chunk 0 always publishes H, so this stops
      }
      s_from = j;
    }
    __syncthreads();
    __threadfence();
    const int j = s_from;
    const float* vj = vals + ((long long)series * C + j) * 3 * THREADS;
    float hin = __ldcg(vj + 2 * THREADS + tid);
    for (int i = j + 1; i < c; ++i) {  // fold forward, in chunk order
      const float* vi = vals + ((long long)series * C + i) * 3 * THREADS;
      hin = fmaf(__ldcg(vi + tid), hin, __ldcg(vi + THREADS + tid));
    }
    h = fmaf(P, hin, s);
    if (publish) {
      mine[2 * THREADS + tid] = h;
      __threadfence();
      __syncthreads();
      if (tid == 0) atomicExch(flag + c, epoch * 4 + 2);
    }
#pragma unroll
    for (int i = 0; i < LMAX; ++i)
      if (i < n) xv[i] = fmaf(av[i], hin, xv[i]);  // the last one is h, bitwise
  }
  if (C > 1) {  // this block is done with the flags
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      if (atomicAdd(ctrl + 1, 1) == (int)gridDim.x - 1) {  // every block has read the epoch
        atomicExch(ctrl + 1, 0);
        atomicExch(ctrl + 2, epoch + 1 < (1 << 29) ? epoch + 1 : 1);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < LMAX; ++i)
    if (i < n) out[base + (long long)i * D] = from_f32<T>(xv[i]);
  if (last != nullptr && t0 + n == Tn) last[(long long)b * D + d] = from_f32<T>(h);
}

template <typename T>
cudaError_t launch(const void* x, const void* a, const void* h0, void* out, void* last, int B,
                   int Tn, int D, int L, int C, void* vals, void* flags, void* ctrl,
                   cudaStream_t stream) {
  const long long blocks = (long long)((D + THREADS - 1) / THREADS) * B * C;
  rg_lru_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), static_cast<const float*>(h0),
      static_cast<T*>(out), static_cast<T*>(last), B, Tn, D, L, C,
      static_cast<float*>(vals), static_cast<int*>(flags), static_cast<int*>(ctrl));
  return cudaGetLastError();
}

}  // namespace

// x, a, out: (B, T, D) contiguous, dtype code 0 = f32, 1 = bf16; h0 (B, D)
// f32 contiguous; last (B, D) in x's dtype, or null.  The plan: C chunks
// of L steps (C = ceil(T / L), 1 <= L <= 64).  With C > 1: vals holds
// B * ceil(D / 64) * C * 192 floats of scratch, flags B * ceil(D / 64) * C
// ints (0 or an earlier call's epoch), ctrl three ints: the ticket and the
// count of blocks done, both 0, and the epoch, in [1, 2^29) and above every
// flag's (a fresh buffer: 1; after that the kernel keeps it).  Returns the
// launch error (0 on success).
extern "C" int forge_rg_lru(const void* x, const void* a, const void* h0, void* out,
                            void* last, int B, int Tn, int D, int L, int C, void* vals,
                            void* flags, void* ctrl, int dtype, void* stream) {
  if (B <= 0 || Tn <= 0 || D <= 0) return 0;
  if (L < 1 || L > LMAX || C != (Tn + L - 1) / L) return (int)cudaErrorInvalidValue;
  if (C > 1 && (vals == nullptr || flags == nullptr || ctrl == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((long long)((D + THREADS - 1) / THREADS) * B * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == FORGE_F32)
    return (int)launch<float>(x, a, h0, out, last, B, Tn, D, L, C, vals, flags, ctrl, s);
  if (dtype == FORGE_BF16)
    return (int)launch<__nv_bfloat16>(x, a, h0, out, last, B, Tn, D, L, C, vals, flags, ctrl, s);
  return (int)cudaErrorInvalidValue;
}
