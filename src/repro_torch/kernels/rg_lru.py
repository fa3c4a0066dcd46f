"""RG-LRU linear recurrence ``h_t = a_t ⊙ h_{t-1} + x_t``: the
``_rg_lru_fused`` dispatch target of the recurrent block.

Port of the Pallas TPU kernels ``repro/kernels/rg_lru.py``
(``rg_lru_pallas`` and ``rg_lru_chunked``) to one hand-written CUDA
kernel for Hopper, ``csrc/rg_lru.cu``; the source says what bounds it on
the H100 and what its design does about that.

* :func:`plan` — the launch plan, a pure function of (B, T, D): how many
  chunks of T run side by side and their length (``(chunks, steps)``).
* :func:`rg_lru_cuda` — the kernel's wrapper: checks device, dtype,
  shape and contiguity, allocates the outputs and the chunks' scratch,
  launches on PyTorch's current stream and counts the launch in
  :data:`LAUNCHES`.  With ``last=True`` the same launch also writes
  ``h[:, -1]`` (the chunked entry point).  The launch is safe to capture
  in a CUDA graph: its epoch lives on the device (:func:`_chunk_state`).
* :func:`rg_lru_plain` / :func:`rg_lru_chunked_plain` — the plain
  PyTorch versions (:func:`~repro_torch.kernels.ref.rg_lru_ref`, a
  log-step doubling scan in fp32).
* :func:`rg_lru` / :func:`rg_lru_chunked` — the fronts, the custom ops
  ``repro_torch::rg_lru`` and ``repro_torch::rg_lru_chunked``: a CUDA
  tensor launches the kernel (or raises), a CPU tensor takes the plain
  version.  ``h0=None`` becomes zeros here.  Their registered backward
  recomputes through the plain version, as the Pallas ``custom_vjp``
  does; their fake implementations keep each call one opaque node when
  ``torch.export`` captures a caller.
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

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: streaming multiprocessors of an H100 SXM; the grid aims at a block an SM
SMS = 132
CHANNELS = 64  # csrc THREADS: the channels of one block
MAX_STEPS = 64  # csrc LMAX: the steps a thread holds in registers
MIN_STEPS = 32  # the shortest chunk worth a look-back


@functools.lru_cache(maxsize=None)
def plan(B: int, T: int, D: int) -> Tuple[int, int]:
    """``(chunks, steps)``: T cut into ``chunks`` chunks of ``steps``
    steps (the last one ragged), each chunk of each 64-channel tile of
    each row one block.  Chunks of at most 64 steps (a thread keeps its
    steps in registers): as few as that allows, since a chunk past the
    first pays a look-back; more, down to 32 steps, only where the grid
    would leave SMs idle."""
    base = B * -(-D // CHANNELS)
    fill = -(-SMS // base)
    chunks = max(-(-T // MAX_STEPS), min(-(-T // MIN_STEPS), fill))
    steps = -(-T // max(1, chunks))
    return -(-T // steps), steps


#: the chunk state's control words ahead of the flags: the ticket, the
#: count of blocks done and the epoch
CTRL = 3


def _set_epoch(buf: torch.Tensor) -> None:
    buf[2] = 1  # epochs run 1 .. 2^29 - 1; a zeroed flag belongs to none


def _chunk_state(device: torch.device, n: int) -> torch.Tensor:
    """The control words (ticket, blocks done, epoch) and the chunks'
    flags, kept per device and stream
    (:func:`~repro_torch.kernels._build.stream_scratch`: made before any
    CUDA graph captures it, never freed under one).  The epoch lives on
    the device and the kernel's last block to finish advances it, so
    every call and every replay of a captured launch runs in a fresh
    epoch; flags carry the epoch of the call that wrote them, so they are
    never cleared; the ticket and the count are back at 0 after every
    call."""
    return _build.stream_scratch("rg_lru", device, CTRL + n, init=_set_epoch)


@functools.cache
def _lib():
    fn = _build.load("rg_lru").forge_rg_lru
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def rg_lru_plain(x, a, h0=None):
    return _ref.rg_lru_ref(x, a, h0)


def rg_lru_chunked_plain(x, a, h0=None):
    return _ref.rg_lru_chunk_ref(x, a, h0)


def rg_lru_cuda(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor, *,
                last: bool = False, steps: Optional[int] = None):
    """The scan on the card.  x, a: (B, T, D) contiguous, one dtype (f32
    or bf16); h0: (B, D), any float dtype (read as fp32).  Returns h
    (B, T, D) in x's dtype, and with ``last`` also ``h[:, -1]`` (B, D)
    written by the same launch.  ``steps`` forces the chunk length
    (1 to 64) instead of :func:`plan`'s."""
    if x.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"rg_lru: bad shapes x{tuple(x.shape)} a{tuple(a.shape)}")
    B, T, D = x.shape
    if tuple(h0.shape) != (B, D):
        raise ValueError(f"rg_lru: h0 shape {tuple(h0.shape)} != ({B}, {D})")
    for t in (x, a, h0):
        if not t.is_cuda or t.device != x.device:
            raise ValueError("rg_lru: every operand must be on x's CUDA device")
    if x.device.index != torch.cuda.current_device():
        raise ValueError("rg_lru: operands must be on the current CUDA device")
    if x.dtype not in DTYPE_CODES or a.dtype != x.dtype:
        raise ValueError(f"rg_lru: unsupported dtypes x {x.dtype}, a {a.dtype}")
    if not (x.is_contiguous() and a.is_contiguous()):
        raise ValueError("rg_lru: x and a must be contiguous")
    h0 = h0.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    h_last = torch.empty((B, D), dtype=x.dtype, device=x.device) if last else None
    if out.numel() == 0:
        return (out, h_last) if last else out
    if steps is None:
        chunks, steps = plan(B, T, D)
    else:
        chunks = -(-T // steps)
    vals = state = None
    if chunks > 1:
        n = B * -(-D // CHANNELS) * chunks
        vals = torch.empty(n * 3 * CHANNELS, dtype=torch.float32, device=x.device)
        state = _chunk_state(x.device, n)
    rc = _lib()(x.data_ptr(), a.data_ptr(), h0.data_ptr(), out.data_ptr(),
                h_last.data_ptr() if last else None, B, T, D, steps, chunks,
                vals.data_ptr() if vals is not None else None,
                state[CTRL:].data_ptr() if state is not None else None,
                state.data_ptr() if state is not None else None,
                DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "rg_lru")
    LAUNCHES.count()
    return (out, h_last) if last else out


def _forward(x, a, h0, last):
    if x.is_cuda:
        return rg_lru_cuda(x, a, h0, last=last)
    if x.device.type == "cpu":
        return rg_lru_chunked_plain(x, a, h0) if last else rg_lru_plain(x, a, h0)
    raise ValueError(f"rg_lru: no implementation for device {x.device}")


@torch.library.custom_op("repro_torch::rg_lru", mutates_args=())
def _rg_lru_op(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    return _forward(x, a, h0, last=False)


@_rg_lru_op.register_fake
def _(x, a, h0):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::rg_lru_chunked", mutates_args=())
def _rg_lru_chunked_op(x: torch.Tensor, a: torch.Tensor,
                       h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return _forward(x, a, h0, last=True)


@_rg_lru_chunked_op.register_fake
def _(x, a, h0):
    return torch.empty_like(x), x.new_empty((x.shape[0], x.shape[2]))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _grads_through_plain(ctx, outs, grads):
    inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
    with torch.enable_grad():
        y = outs(*inputs)
    y = y if isinstance(y, tuple) else (y,)
    live = [(o, g) for o, g in zip(y, grads) if g is not None]
    return torch.autograd.grad([o for o, _ in live], inputs, [g for _, g in live])


def _backward(ctx, g):
    return _grads_through_plain(ctx, rg_lru_plain, (g,))


def _backward_chunked(ctx, g, g_last):
    return _grads_through_plain(ctx, rg_lru_chunked_plain, (g, g_last))


_rg_lru_op.register_autograd(_backward, setup_context=_setup_context)
_rg_lru_chunked_op.register_autograd(_backward_chunked, setup_context=_setup_context)


def _h0(x: torch.Tensor, h0: Optional[torch.Tensor]) -> torch.Tensor:
    if h0 is None:
        return torch.zeros((x.shape[0], x.shape[2]), dtype=x.dtype, device=x.device)
    return h0


def rg_lru(x: torch.Tensor, a: torch.Tensor,
           h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t-1} + x_t over axis 1.  x, a: (B, T, D); h0: (B, D)
    or None (zeros).  Returns h (B, T, D) in x's dtype."""
    return _rg_lru_op(x.contiguous(), a.contiguous(), _h0(x, h0))


def rg_lru_chunked(x: torch.Tensor, a: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked-prefill scan: ``(h, h[:, -1])`` for one prompt chunk."""
    return _rg_lru_chunked_op(x.contiguous(), a.contiguous(), _h0(x, h0))
