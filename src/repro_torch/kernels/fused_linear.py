"""Fused linear + bias + activation: the ``forge.linear_act`` dispatch target.

Port of the Pallas TPU kernel ``repro/kernels/fused_linear.py``
(``fused_linear_pallas``) to hand-written CUDA kernels for Hopper,
``csrc/fused_linear.cu``; the source says what bounds each variant on the
H100 and what its design does about that.

* :func:`plan` — the launch plan, a pure function of (M, N, K, dtype,
  alignment): which of the four variants runs (``gemv`` for M <= 16,
  ``wgmma`` for larger bf16 products, ``wmma`` for bf16 operands TMA
  cannot take, ``fma`` for the rest of f32), its tiles, its pipeline
  depth and its cluster (the K split).  :func:`smem_bytes` and
  :func:`k_ranges` mirror what the entry point derives from a plan.
* :func:`fused_linear_cuda` — the kernel's wrapper: checks device, dtype,
  shape and contiguity, allocates the output, launches the planned
  variant on PyTorch's current stream and counts the launch in
  :data:`LAUNCHES` (``n`` and ``variants[<variant>]``).  No workspace:
  split-K sums stay in shared memory.
* :func:`fused_linear_plain` — the plain PyTorch version of the same
  function (:func:`~repro_torch.kernels.ref.fused_linear_ref`).
* :func:`fused_linear` — the front, the custom op
  ``repro_torch::fused_linear``: a CUDA tensor launches the kernel (or
  raises), a CPU tensor takes the plain version; its registered backward
  recomputes through the plain version, as the Pallas ``custom_vjp``
  does.  Being a custom op with a fake implementation, it stays one
  opaque node when ``torch.export`` traces a caller (a fake tensor never
  reaches the ``ctypes`` launch).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from . import ref as _ref

#: launches of the CUDA kernels since the last ``LAUNCHES.reset()``, in all
#: (``n``) and by variant (``variants``)
LAUNCHES = _build.LaunchCount()

ACT_CODES = {None: 0, "none": 0, "relu": 1, "silu": 2, "gelu": 3,
             "gelu_exact": 4, "tanh": 5}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: variant codes of the C entry point (csrc/fused_linear.cu ``Variant``)
VARIANT_CODES = {"fma": 0, "gemv": 1, "wgmma": 2, "wmma": 3}
#: streaming multiprocessors of an H100 SXM: the CTAs a split K aims for
SMS = 132
GEMV_MAX_M = 16
GEMV_WARPS, GEMV_UNROLL = 8, 6  # csrc GV_WARPS, GV_UNROLL
GEMV_X_BYTES = 32768  # shared memory for one sub-chunk of x
WG_BK, WG_BN, WG_STAGES = 64, 128, 4
MAX_CLUSTER = 8  # the portable thread-block cluster size


@functools.lru_cache(maxsize=None)
def plan(M: int, N: int, K: int, dtype: torch.dtype, aligned: bool):
    """The launch plan ``(variant, bm, bn, stages, cluster)`` of an
    (M, K) x (K, N) product: ``bm`` x ``bn`` is the CTA's output tile (for
    ``gemv``, ``bm`` is M rounded up to a power of two and ``stages`` the
    weight rows in flight per thread), ``cluster`` the CTAs that split K.
    ``aligned``: both operands start on 16 bytes and their rows are
    multiples of 16 bytes, as TMA and 16-byte loads need."""
    esize = 2 if dtype == torch.bfloat16 else 4
    if aligned and M <= GEMV_MAX_M:
        return _gemv_plan(M, N, K, esize)
    if dtype == torch.bfloat16:
        return _wgmma_plan(M, N, K) if aligned else ("wmma", 128, 128, 1, 1)
    return ("fma", 64, 64, 1, 1) if M <= 256 else ("fma", 128, 128, 1, 1)


def _split(tiles: int, units: int) -> int:
    """The smallest power-of-two cluster (at most 8, at most one K unit a
    rank) that brings ``tiles`` output tiles to a CTA per SM."""
    c = 1
    while tiles * c < SMS and 2 * c <= min(MAX_CLUSTER, units):
        c *= 2
    return c


def _gemv_plan(M, N, K, esize):
    vec = 16 // esize  # columns per 16-byte load
    mt = 1 << (M - 1).bit_length()
    units = K // 64  # each rank walks at least 64 weight rows
    for cg in (8, 4):  # 16-byte column groups per CTA
        tiles = -(-N // (cg * vec))
        c = _split(tiles, units)
        if tiles * c >= SMS:
            break
    return ("gemv", mt, cg * vec, GEMV_UNROLL, c)


def _wgmma_plan(M, N, K):
    bm = 64 if M <= 64 else 128
    tiles = -(-M // bm) * -(-N // WG_BN)
    return ("wgmma", bm, WG_BN, WG_STAGES, _split(tiles, -(-K // WG_BK)))


def smem_bytes(p, dtype: torch.dtype) -> int:
    """Shared memory one CTA of plan ``p`` uses (csrc ``gv_smem_bytes`` /
    ``wg_smem_bytes``; the fma and wmma kernels' static arrays: 0)."""
    variant, bm, bn, stages, _ = p
    esize = 2 if dtype == torch.bfloat16 else 4
    if variant == "gemv":
        ksub = min(4096, GEMV_X_BYTES // (bm * esize))
        return bm * ksub * esize + (GEMV_WARPS + 1) * bm * bn * 4
    if variant == "wgmma":
        return 1024 + stages * (bm + bn) * WG_BK * 2 + 16 * stages
    return 0


def k_ranges(p, K: int):
    """The K rows each rank of the plan's cluster sums, in rank order."""
    variant, _, _, _, c = p
    unit = 8 if variant == "gemv" else WG_BK
    units = -(-K // unit)
    return [(r * units // c * unit, min(K, (r + 1) * units // c * unit)) for r in range(c)]


def ctas(p, M: int, N: int) -> int:
    """CTAs the plan launches."""
    variant, bm, bn, _, c = p
    return (1 if variant == "gemv" else -(-M // bm)) * -(-N // bn) * c


def is_aligned(x: torch.Tensor, w: torch.Tensor) -> bool:
    """TMA's and the 16-byte loads' condition on the operands."""
    rows = (x.shape[1] * x.element_size(), w.shape[1] * w.element_size())
    return (x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
            and rows[0] % 16 == 0 and rows[1] % 16 == 0)


@functools.cache
def _lib():
    lib = _build.load("fused_linear")
    lib.forge_fused_linear.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                                       + [ctypes.c_void_p])
    lib.forge_fused_linear.restype = ctypes.c_int
    lib.forge_fused_linear_smem.argtypes = [ctypes.c_int] * 5
    lib.forge_fused_linear_smem.restype = ctypes.c_int
    return lib


def fused_linear_plain(x, w, b=None, *, act=None):
    return _ref.fused_linear_ref(x, w, b, act=act)


def fused_linear_cuda(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    act: Optional[str] = None,
) -> torch.Tensor:
    """y = act(x·w + b) on the card.  x: (M, K); w: (K, N); b: (N,) or None."""
    if act not in ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fused_linear: bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    M, K = x.shape
    N = w.shape[1]
    tensors = [x, w] + ([b] if b is not None else [])
    for t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError("fused_linear: every operand must be on x's CUDA device")
        if t.dtype != x.dtype:
            raise ValueError(f"fused_linear: dtype mismatch {t.dtype} vs {x.dtype}")
        if not t.is_contiguous():
            raise ValueError("fused_linear: operands must be contiguous")
    if x.device.index != torch.cuda.current_device():
        raise ValueError("fused_linear: operands must be on the current CUDA device")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"fused_linear: unsupported dtype {x.dtype}")
    if b is not None and tuple(b.shape) != (N,):
        raise ValueError(f"fused_linear: bias shape {tuple(b.shape)} != ({N},)")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    p = plan(M, N, K, x.dtype, is_aligned(x, w))
    variant, bm, bn, stages, cluster = p
    rc = _lib().forge_fused_linear(
        x.data_ptr(), w.data_ptr(), b.data_ptr() if b is not None else None, y.data_ptr(),
        M, N, K, DTYPE_CODES[x.dtype], ACT_CODES[act], VARIANT_CODES[variant], bm, bn,
        stages, cluster, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, f"fused_linear ({variant})")
    LAUNCHES.count(variant)
    return y


def _forward(x, w, b, act):
    if x.is_cuda:
        return fused_linear_cuda(x, w, b, act=act)
    if x.device.type == "cpu":
        return fused_linear_plain(x, w, b, act=act)
    raise ValueError(f"fused_linear: no implementation for device {x.device}")


@torch.library.custom_op("repro_torch::fused_linear", mutates_args=())
def _fused_linear_op(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                     act: Optional[str]) -> torch.Tensor:
    return _forward(x, w, b, act)


@_fused_linear_op.register_fake
def _(x, w, b, act):
    return x.new_empty((x.shape[0], w.shape[1]))


def _setup_context(ctx, inputs, output):
    x, w, b, act = inputs
    ctx.act = act
    ctx.save_for_backward(x, w, b)


@torch.library.custom_op("repro_torch::fused_linear_backward", mutates_args=())
def _fused_linear_backward_op(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                              g: torch.Tensor, act: Optional[str]
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dw, db): the vector-Jacobian product of the plain version (db
    zeros where there is no bias).  An op of its own, so that a planned
    call's backward runs on the forward's shards under a sharding
    strategy of its own (``distrib/sharding.py``); the gradients are
    contiguous, as the fake implementation says."""
    fn = functools.partial(_ref.fused_linear_ref, act=act)
    if b is None:
        dx, dw = _ref.vjp(lambda x, w: fn(x, w, None), (x, w), g)
        return dx, dw, g.new_zeros(w.shape[1])
    return _ref.vjp(fn, (x, w, b), g)


@_fused_linear_backward_op.register_fake
def _(x, w, b, g, act):
    return x.new_empty(x.shape), w.new_empty(w.shape), g.new_empty((w.shape[1],))


def _backward(ctx, g):
    x, w, b = ctx.saved_tensors
    dx, dw, db = _fused_linear_backward_op(x, w, b, g, ctx.act)
    return dx, dw, db if b is not None else None, None


_fused_linear_op.register_autograd(_backward, setup_context=_setup_context)


def fused_linear(x, w, b=None, *, act: Optional[str] = None) -> torch.Tensor:
    """y = act(x·w + b).  x: (M, K); w: (K, N); b: (N,) or None."""
    return _fused_linear_op(x, w, b, act)
