"""Fused linear + bias + activation: the ``forge.linear_act`` dispatch target.

Port of the Pallas TPU kernel ``repro/kernels/fused_linear.py``
(``fused_linear_pallas``) to a hand-written CUDA kernel for Hopper,
``csrc/fused_linear.cu``; the source says what bounds it on the H100 and
what its design does about that.

* :func:`fused_linear_cuda` — the kernel's wrapper: checks device, dtype,
  shape and contiguity, allocates the output (and, at decode, the fp32
  split-K workspace the library asks for), launches on PyTorch's current
  stream and counts the launch in :data:`LAUNCHES`.
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
from typing import Optional

import torch

from . import _build
from . import ref as _ref

#: launches of the CUDA kernel since the last ``LAUNCHES.reset()``
LAUNCHES = _build.LaunchCount()

ACT_CODES = {None: 0, "none": 0, "relu": 1, "silu": 2, "gelu": 3,
             "gelu_exact": 4, "tanh": 5}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    lib = _build.load("fused_linear")
    lib.forge_fused_linear.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                                       + [ctypes.c_void_p])
    lib.forge_fused_linear.restype = ctypes.c_int
    lib.forge_fused_linear_workspace.argtypes = [ctypes.c_int] * 3
    lib.forge_fused_linear_workspace.restype = ctypes.c_longlong
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
    lib = _lib()
    n_ws = lib.forge_fused_linear_workspace(M, N, K)
    ws = torch.empty((n_ws,), dtype=torch.float32, device=x.device) if n_ws else None
    rc = lib.forge_fused_linear(
        x.data_ptr(), w.data_ptr(), b.data_ptr() if b is not None else None,
        y.data_ptr(), ws.data_ptr() if ws is not None else None, M, N, K,
        DTYPE_CODES[x.dtype], ACT_CODES[act], torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "fused_linear")
    LAUNCHES.n += 1
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


def _backward(ctx, g):
    x, w, b = ctx.saved_tensors
    inputs = [t.detach().requires_grad_(True) if t is not None else None
              for t in (x, w, b)]
    with torch.enable_grad():
        y = _ref.fused_linear_ref(*inputs, act=ctx.act)
    live = [t for t in inputs if t is not None]
    grads = iter(torch.autograd.grad(y, live, g))
    return tuple(next(grads) if t is not None else None for t in inputs) + (None,)


_fused_linear_op.register_autograd(_backward, setup_context=_setup_context)


def fused_linear(x, w, b=None, *, act: Optional[str] = None) -> torch.Tensor:
    """y = act(x·w + b).  x: (M, K); w: (K, N); b: (N,) or None."""
    return _fused_linear_op(x, w, b, act)
