"""RMSNorm ``y = x · rsqrt(mean(x², -1) + eps) · w``: the ``ops.rms_norm``
dispatch target.

Port of the Pallas TPU kernel ``repro/kernels/rms_norm.py``
(``rms_norm_pallas``) to a hand-written CUDA kernel for Hopper,
``csrc/rms_norm.cu``; the source says what bounds it on the H100 and what
its design does about that.  As in the JAX package, no model reaches it:
the models normalise through the plain ``models/layers.rms_norm``.

* :func:`rms_norm_cuda` — the kernel's wrapper: checks device, dtype,
  shape and contiguity, allocates the output, launches on PyTorch's
  current stream and counts the launch in :data:`LAUNCHES`.
* :func:`rms_norm_plain` — the plain PyTorch version
  (:func:`~repro_torch.kernels.ref.rms_norm_ref`).
* :func:`rms_norm` — the front, the custom op ``repro_torch::rms_norm``:
  a CUDA tensor launches the kernel (or raises), a CPU tensor takes the
  plain version.  Its fake implementation keeps a call one opaque node
  when ``torch.export`` captures a caller.  It registers no backward: the
  Pallas kernel has no ``custom_vjp``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import ref as _ref

#: launches of the CUDA kernel since the last ``LAUNCHES.reset()``
LAUNCHES = _build.LaunchCount()

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    fn = _build.load("rms_norm").forge_rms_norm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int,
                                                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rms_norm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return _ref.rms_norm_ref(x, w, eps)


def rms_norm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The norm on the card.  x: (..., d) contiguous, f32 or bf16; w: (d,),
    any float dtype (read as fp32).  Returns y in x's shape and dtype."""
    d = x.shape[-1] if x.dim() else 0
    if x.dim() == 0 or tuple(w.shape) != (d,):
        raise ValueError(f"rms_norm: bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    if not (x.is_cuda and w.is_cuda and w.device == x.device):
        raise ValueError("rms_norm: x and w must be on one CUDA device")
    if x.device.index != torch.cuda.current_device():
        raise ValueError("rms_norm: operands must be on the current CUDA device")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"rms_norm: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("rms_norm: x must be contiguous")
    w = w.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    rc = _lib()(x.data_ptr(), w.data_ptr(), out.data_ptr(), x.numel() // d, d, float(eps),
                DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "rms_norm")
    LAUNCHES.count()
    return out


@torch.library.custom_op("repro_torch::rms_norm", mutates_args=())
def _rms_norm_op(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    if x.is_cuda:
        return rms_norm_cuda(x, w, eps)
    if x.device.type == "cpu":
        return rms_norm_plain(x, w, eps)
    raise ValueError(f"rms_norm: no implementation for device {x.device}")


@_rms_norm_op.register_fake
def _(x, w, eps):
    return torch.empty_like(x)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """y = x · rsqrt(mean(x², -1) + eps) · w.  x: (..., d); w: (d,)."""
    return _rms_norm_op(x.contiguous(), w, float(eps))
