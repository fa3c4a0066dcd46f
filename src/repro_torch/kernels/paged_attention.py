"""Paged-attention decode: one query token per row over a paged KV pool.

Port of the Pallas TPU kernel ``repro/kernels/paged_attention.py``
(``paged_attention``, body ``_paged_kernel``) to a hand-written CUDA
kernel for Hopper, ``csrc/paged_attention.cu``; the source says what
bounds it on the H100 and what its design does about that.

* :func:`plan` — the launch plan, a pure function of the shapes, the
  window and the dtype: how many blocks split a row's live pages
  (``splits``) and how many pages a block loads at a time
  (``chunk_pages``); :func:`smem_bytes` is the shared memory a block of
  the plan takes.
* :func:`paged_attention_cuda` — the kernel's wrapper: checks device,
  dtype, shape, contiguity and alignment, allocates the output and the
  split partials, launches on PyTorch's current stream and counts the
  launch in :data:`LAUNCHES` (one launch a call, whatever the split).
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
from typing import Optional, Tuple

import torch

from . import _build
from . import ref as _ref

#: launches of the CUDA kernel since the last ``LAUNCHES.reset()``
LAUNCHES = _build.LaunchCount()

#: head dims of the JAX package's kernel tests and configs (64, 96 phi3,
#: 112 kimi-k2, 128, 256 recurrentgemma) and the smoke configs' 8-32
HEAD_DIMS = (8, 16, 32, 64, 96, 112, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: streaming multiprocessors of an H100 SXM; the grid aims at one wave of
#: as many blocks as they hold (a decode block is small: 128 threads, tens
#: of KB of shared memory)
SMS = 132
CHUNK_KEYS = 64  # keys a block loads at a time, at most
STAGE_BYTES = 8192  # bytes of K (or V) rows in one stage of the ring, at most
STAGES = 2  # csrc STAGES: chunks in the ring, the next loads while one is scored
THREADS = 128  # csrc THREADS
MAX_SMEM = 232448  # bytes of shared memory a block may use (227 KB)
SMEM_PER_SM = 233472  # bytes of shared memory an SM holds (228 KB; 1 KB more a block)
REG_BLOCKS = 6  # blocks an SM holds by registers (about 80 a thread)


def max_live_pages(MP: int, ps: int, window: Optional[int]) -> int:
    """The most pages of a row that can hold a visible key: the whole
    table, or the pages a window of ``window`` keys can touch."""
    if window is None:
        return MP
    return min(MP, (window + ps - 2) // ps + 1)


@functools.lru_cache(maxsize=None)
def plan(B: int, H: int, KVH: int, D: int, ps: int, MP: int, window: Optional[int],
         dtype: torch.dtype):
    """``(splits, chunk_pages)``: the blocks that share a row's live pages
    (grid ``KVH x B x splits``) and the pages a block loads at a time.
    A chunk holds at most 64 keys and 8 KB of K rows; the split brings
    the grid to one wave of as many blocks as the SMs hold at once (by
    shared memory and registers), and at least one block an SM where the
    rows alone leave SMs idle; never more splits than a row can have
    live pages, never a chunk past a split's share of them."""
    esize = 2 if dtype == torch.bfloat16 else 4
    live = max_live_pages(MP, ps, window)
    chunk = max(1, min(32, CHUNK_KEYS // ps, STAGE_BYTES // (ps * D * esize)))
    resident = min(REG_BLOCKS, SMEM_PER_SM // (smem_bytes(H, KVH, D, ps, chunk, dtype) + 1024))
    rows = B * KVH
    want = max(1, resident) * SMS
    splits = max(1, min(live, max(-(-SMS // rows), want // rows)))
    return splits, max(1, min(chunk, -(-live // splits)))


def smem_bytes(H: int, KVH: int, D: int, ps: int, chunk_pages: int, dtype: torch.dtype) -> int:
    """Shared memory one block takes (csrc ``pa_smem_bytes``): fp32 q and
    accumulators, the chunk's scores, m / l / alpha and the P.V slice
    sums, then a ring of two chunks of K and V rows in the pool's dtype."""
    G, keys = H // KVH, chunk_pages * ps
    esize = 2 if dtype == torch.bfloat16 else 4
    words = 2 * G * D + ((G * keys + 3 * G + 3) & ~3) + 4 * THREADS
    return words * 4 + STAGES * 2 * keys * D * esize


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """Zeroed ticket counters, one per (row, KV head), kept per device and
    stream (:func:`~repro_torch.kernels._build.stream_scratch`, sized
    before any CUDA graph captures them and never freed under one): the
    kernel's last block of each (row, KV head) sets its counter back to
    0, so they are zero between calls on one stream and between replays
    of a graph."""
    return _build.stream_scratch("paged_attention", device, n)


@functools.cache
def _lib():
    lib = _build.load("paged_attention")
    lib.forge_paged_attention.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                                          + [ctypes.c_float] + [ctypes.c_int] * 3
                                          + [ctypes.c_void_p])
    lib.forge_paged_attention.restype = ctypes.c_int
    lib.forge_paged_attention_smem.argtypes = [ctypes.c_int] * 4
    lib.forge_paged_attention_smem.restype = ctypes.c_longlong
    return lib


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
    plan_override: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Paged decode attention on the card.

    q: (B, H, D); k_pages, v_pages: (NP, ps, KVH, D); page_table: (B, MP)
    int32; pos: (B,) int32.  All contiguous; the pages start on 16 bytes.
    Returns (B, H, D) in q's dtype.  ``plan_override`` runs a given
    ``(splits, chunk_pages)`` instead of :func:`plan`'s."""
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
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention: the K and V pages must start on 16 bytes")
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    splits, chunk = plan_override or plan(B, H, KVH, D, ps, MP, window, q.dtype)
    if chunk > 32 or smem_bytes(H, KVH, D, ps, chunk, q.dtype) > MAX_SMEM:
        raise ValueError(f"paged_attention: a chunk of {chunk} pages of {ps} slots at "
                         f"D={D} is over 32 pages or does not fit a block's shared memory")
    part = tickets = None
    if splits > 1:
        part = torch.empty(B * KVH * splits * (H // KVH) * (D + 2), dtype=torch.float32,
                           device=q.device)
        tickets = _tickets(q.device, B * KVH)
    rc = _lib().forge_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        pos.data_ptr(), out.data_ptr(), part.data_ptr() if part is not None else None,
        tickets.data_ptr() if tickets is not None else None, B, H, KVH, D, NP, ps, MP,
        int(window or 0), _scale(q, scale), splits, chunk, DTYPE_CODES[q.dtype],
        torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "paged_attention")
    LAUNCHES.count()
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
