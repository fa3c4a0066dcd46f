"""Paged-attention decode: one query token per row over a paged KV pool.

Port of the Pallas TPU kernel ``repro/kernels/paged_attention.py``
(``paged_attention``, body ``_paged_kernel``) to a hand-written CUDA
kernel for Hopper, ``csrc/paged_attention.cu``; the source says what
bounds it on the H100 and what its design does about that.

* :func:`paged_attention_cuda` — the kernel's wrapper: checks device,
  dtype, shape and contiguity, allocates the output, launches on
  PyTorch's current stream and counts the launch in :data:`LAUNCHES`.
* :func:`paged_attention_plain` — the plain PyTorch version: gather the
  row's pages and take masked-softmax attention
  (:func:`~repro_torch.kernels.ref.paged_sdpa_ref`); a row that sees no
  key gives zeros, as the kernel's ``l == 0`` guard does.
* :func:`paged_attention` — the front, the custom op
  ``repro_torch::paged_attention``: a CUDA tensor launches the kernel
  (or raises), a CPU tensor takes the plain version, ``impl="ref"`` runs
  the plain version anywhere.  Its fake implementation keeps it one
  opaque node when ``torch.export`` captures a whole paged step.

Decode is inference only: the Pallas kernel has no ``custom_vjp``, so
this one registers no backward.
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

#: head dims of the JAX package's kernel tests and configs
HEAD_DIMS = (8, 16, 32, 64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    fn = _build.load("paged_attention").forge_paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / (q.shape[-1] ** 0.5) if scale is None else float(scale)


def paged_attention_plain(q, k_pages, v_pages, page_table, pos, *,
                          window: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Gather + masked softmax; rows that see no key give zeros."""
    out = _ref.paged_sdpa_ref(q, k_pages, v_pages, page_table, pos,
                              window=window, scale=_scale(q, scale))
    L = page_table.shape[1] * k_pages.shape[1]
    p = pos.long()
    lo = p - window + 1 if window is not None else torch.zeros_like(p)
    sees_a_key = torch.clamp(p, max=L - 1) >= torch.clamp(lo, min=0)
    return torch.where(sees_a_key[:, None, None], out, 0.0).to(q.dtype)


def paged_attention_cuda(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    pos: torch.Tensor,
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Paged decode attention on the card.

    q: (B, H, D); k_pages, v_pages: (NP, ps, KVH, D); page_table: (B, MP)
    int32; pos: (B,) int32.  All contiguous.  Returns (B, H, D) in q's
    dtype."""
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k_pages.shape)} v{tuple(v_pages.shape)}")
    B, H, D = q.shape
    NP, ps, KVH, Dk = k_pages.shape
    if Dk != D or KVH == 0 or H % KVH:
        raise ValueError(f"paged_attention: q{tuple(q.shape)} does not match "
                         f"pages{tuple(k_pages.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head dim {D} not in {HEAD_DIMS}")
    if page_table.dim() != 2 or page_table.shape[0] != B or tuple(pos.shape) != (B,):
        raise ValueError(f"paged_attention: page_table{tuple(page_table.shape)} / "
                         f"pos{tuple(pos.shape)} do not match B={B}")
    MP = page_table.shape[1]
    for t in (q, k_pages, v_pages, page_table, pos):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("paged_attention: every operand must be on q's CUDA device")
        if not t.is_contiguous():
            raise ValueError("paged_attention: operands must be contiguous")
    for t in (k_pages, v_pages):
        if t.dtype != q.dtype:
            raise ValueError(f"paged_attention: dtype mismatch {t.dtype} vs {q.dtype}")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("paged_attention: page_table and pos must be int32")
    if q.device.index != torch.cuda.current_device():
        raise ValueError("paged_attention: operands must be on the current CUDA device")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"paged_attention: unsupported dtype {q.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"paged_attention: window must be >= 1, got {window}")
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    rc = _lib()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                B, H, KVH, D, NP, ps, MP, int(window or 0), _scale(q, scale),
                DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "paged_attention")
    LAUNCHES.n += 1
    return out


@torch.library.custom_op("repro_torch::paged_attention", mutates_args=())
def _paged_op(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
              page_table: torch.Tensor, pos: torch.Tensor, window: Optional[int],
              scale: float) -> torch.Tensor:
    if q.is_cuda:
        return paged_attention_cuda(q, k_pages, v_pages, page_table, pos,
                                    window=window, scale=scale)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_table, pos,
                                     window=window, scale=scale)
    raise ValueError(f"paged_attention: no implementation for device {q.device}")


@_paged_op.register_fake
def _(q, k_pages, v_pages, page_table, pos, window, scale):
    return q.new_empty(q.shape).contiguous()


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    pos: torch.Tensor,
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """One-token decode attention through a page table; (B, H, D) in q's
    dtype.  ``impl="ref"`` runs the plain version on any device."""
    if impl not in (None, "ref"):
        raise ValueError(f"impl must be None or 'ref', got {impl!r}")
    if impl == "ref":
        return paged_attention_plain(q, k_pages, v_pages, page_table, pos,
                                     window=window, scale=scale)
    return _paged_op(q.contiguous(), k_pages.contiguous(), v_pages.contiguous(),
                     page_table.to(torch.int32).contiguous(),
                     pos.to(torch.int32).contiguous(), window, _scale(q, scale))
