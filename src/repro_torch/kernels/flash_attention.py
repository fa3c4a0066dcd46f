"""Flash attention (forward): the ``forge.sdpa`` dispatch target for
unmasked attention (the full-sequence forward, cross-attention, and a
single query row against cached cross-attention keys at decode).

Port of the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``) to hand-written CUDA kernels for Hopper,
``csrc/flash_attention.cu``; the source says what bounds each on the
H100 and what its design does about that.

* :func:`variant` — which kernel a call takes, a pure function of the
  dtype, the head dim, the key length and the views' alignment: ``wgmma``
  (the warpgroup kernel, for bf16 views TMA can take at head dims up to
  128), ``wmma`` (other bf16 calls: views TMA cannot take, and D = 256),
  ``fma`` (f32).  :func:`smem_bytes` is the shared memory the entry
  point launches the variant with.
* :func:`flash_attention_cuda` — the wrapper: checks, allocates the
  output, launches the chosen kernel, counts the launch in
  :data:`LAUNCHES` (``n`` and ``variants[<variant>]``).
* :func:`flash_attention_plain` — the plain PyTorch version
  (:func:`~repro_torch.kernels.ref.sdpa_ref` with the same scale).
* :func:`flash_attention` — the front, the custom op
  ``repro_torch::flash_attention``, selected by device; its registered
  backward goes through the plain version, as the Pallas ``custom_vjp``
  does.  ``torch.export`` keeps the custom op as one node (its fake
  implementation gives the output's shape).
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

#: head dims the kernels are instantiated for: the JAX kernel's (64, 96,
#: 112, 128, 256) and the smoke configs' 16 and 32; a smaller head dim
#: runs zero-padded to the next of them (:func:`flash_attention_cuda`)
HEAD_DIMS = (16, 32, 64, 96, 112, 128, 256)
#: head dims of the warpgroup kernel: 96 and 112 run padded to 128 (TMA
#: fills the padding with zeros); at 256 the O accumulator and two tiles'
#: scores do not fit a thread's registers, so bf16 D = 256 takes ``wmma``
WGMMA_HEAD_DIMS = (16, 32, 64, 96, 112, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: variant codes of the C entry point (csrc/flash_attention.cu ``Variant``)
VARIANT_CODES = {"fma": 0, "wgmma": 2, "wmma": 3}


def tma_legal(t: torch.Tensor) -> bool:
    """TMA can load (B, heads, S, D) tiles of the view: its base is on 16
    bytes and each stepped dimension's stride is a multiple of 16 bytes
    (a dimension of size 1 is never stepped)."""
    esize = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        (t.stride(i) * esize) % 16 == 0 for i in range(3) if t.shape[i] > 1)


def variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a call takes (``Sk`` = 0 leaves TMA no key to describe)."""
    if q.dtype != torch.bfloat16:
        return "fma"
    if (q.shape[-1] in WGMMA_HEAD_DIMS and k.shape[2] > 0
            and all(tma_legal(t) for t in (q, k, v))):
        return "wgmma"
    return "wmma"


def smem_bytes(kind: str, D: int) -> int:
    """Dynamic shared memory one CTA of ``kind`` takes at head dim ``D``
    (csrc ``fma_smem_bytes``, ``wm_smem_bytes``, ``fw_smem_bytes``)."""
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: no kernel at head dim {D}")
    if kind == "fma":  # K and V tiles of 32 keys and the 32 x 64 scores, fp32
        return (2 * 32 * D + 32 * 64) * 4
    if kind == "wmma":  # 64-row tiles padded by 8; Q in registers up to D = 128
        ldk, lds = D + 8, max(D, 64) + 4
        return (128 + (0 if D <= 128 else 64 * ldk * 2) + 2 * 64 * ldk * 2
                + 4 * 16 * lds * 4 + 4 * 16 * 72 * 2 + 4 * 16 * 4)
    if kind == "wgmma" and D in WGMMA_HEAD_DIMS:  # Q and a 3-stage K / V ring
        dp = D if D <= 64 else 128
        keys = 128 if dp <= 64 else 64
        return 1024 + 128 * dp * 2 + 2 * 3 * keys * dp * 2 + (1 + 3 * 3) * 8
    raise ValueError(f"flash_attention: no {kind!r} kernel at head dim {D}")


@functools.cache
def _lib():
    lib = _build.load("flash_attention")
    lib.forge_flash_attention.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                                          + [ctypes.c_float] + [ctypes.c_int] * 4
                                          + [ctypes.c_void_p])
    lib.forge_flash_attention.restype = ctypes.c_int
    lib.forge_flash_attention_smem.argtypes = [ctypes.c_int] * 3
    lib.forge_flash_attention_smem.restype = ctypes.c_int
    return lib


def _eff_scale(scale: float, scale_mode: str) -> float:
    if scale_mode == "mul":
        return scale
    if scale_mode == "div":
        return 1.0 / scale
    raise ValueError(f"bad scale_mode {scale_mode!r}")


def flash_attention_plain(q, k, v, *, scale, scale_mode="mul", causal=False):
    return _ref.sdpa_ref(q, k, v, None, scale=_eff_scale(scale, scale_mode),
                         causal=causal)


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    scale_mode: str = "mul",
    causal: bool = False,
) -> torch.Tensor:
    """Attention on the card.  q: (B, H, Sq, D); k, v: (B, KVH, Sk, D).

    The views may be strided; only the head dimension must be contiguous.
    The output is a fresh contiguous (B, H, Sq, D) tensor in q's dtype.
    A head dim below 256 that no kernel is built for (the quickstart
    example's 8) runs on q, k and v zero-padded to the next built one:
    the padded columns add exactly 0 to every score and give output
    columns that are dropped, so the result is the unpadded attention's.
    """
    _eff_scale(scale, scale_mode)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KVH == 0 or H % KVH:
        raise ValueError(f"flash_attention: q{tuple(q.shape)} does not match "
                         f"k{tuple(k.shape)}")
    if D not in HEAD_DIMS:
        Dp = next((d for d in HEAD_DIMS if d > D), None)
        if Dp is None:
            raise ValueError(f"flash_attention: head dim {D} above {HEAD_DIMS[-1]}")
        q, k, v = (torch.nn.functional.pad(t, (0, Dp - D)) for t in (q, k, v))
        o = flash_attention_cuda(q, k, v, scale=scale, scale_mode=scale_mode, causal=causal)
        return o[..., :D].contiguous()
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash_attention: q, k, v must be on one CUDA device")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: dtype mismatch {t.dtype} vs {q.dtype}")
        if t.stride(3) != 1:
            raise ValueError("flash_attention: the head dim must be contiguous")
    if q.device.index != torch.cuda.current_device():
        raise ValueError("flash_attention: operands must be on the current CUDA device")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention: unsupported dtype {q.dtype}")
    o = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, o) for s in (t.stride(0), t.stride(1), t.stride(2))
    ))
    kind = variant(q, k, v)
    rc = _lib().forge_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        ctypes.cast(strides, ctypes.c_void_p), B, H, KVH, Sq, Sk, D, float(scale),
        int(scale_mode == "div"), int(bool(causal)), DTYPE_CODES[q.dtype],
        VARIANT_CODES[kind], torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, f"flash_attention ({kind})")
    LAUNCHES.count(kind)
    return o


def _forward(q, k, v, scale, scale_mode, causal):
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, scale=scale, scale_mode=scale_mode,
                                    causal=causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, scale_mode=scale_mode,
                                     causal=causal)
    raise ValueError(f"flash_attention: no implementation for device {q.device}")


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              scale_mode: str, causal: bool) -> torch.Tensor:
    return _forward(q, k, v, scale, scale_mode, causal)


@_flash_op.register_fake
def _(q, k, v, scale, scale_mode, causal):
    return q.new_empty(q.shape).contiguous()


def _setup_context(ctx, inputs, output):
    q, k, v, scale, scale_mode, causal = inputs
    ctx.cfg = (scale, scale_mode, causal)
    ctx.save_for_backward(q, k, v)


@torch.library.custom_op("repro_torch::flash_attention_backward", mutates_args=())
def _flash_backward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                       scale: float, scale_mode: str, causal: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): the vector-Jacobian product of the plain version.
    An op of its own, so that a planned call's backward runs on each
    device's local heads under the forward's sharding strategy
    (``distrib/sharding.py``) instead of DTensor's products over
    flattened (rows, heads).  The gradients are contiguous, as the fake
    implementation says: DTensor reads a view's legality off the global
    (fake) strides and applies it to the local shards."""
    return _ref.vjp(functools.partial(flash_attention_plain, scale=scale,
                                      scale_mode=scale_mode, causal=causal), (q, k, v), g)


@_flash_backward_op.register_fake
def _(q, k, v, g, scale, scale_mode, causal):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _backward(ctx, g):
    q, k, v = ctx.saved_tensors
    return _flash_backward_op(q, k, v, g, *ctx.cfg) + (None, None, None)


_flash_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    scale_mode: str = "mul",
    causal: bool = False,
) -> torch.Tensor:
    """Blockwise online-softmax attention; GQA when H is a multiple of KVH."""
    if scale is None:
        scale, scale_mode = 1.0 / (q.shape[-1] ** 0.5), "mul"
    return _flash_op(q, k, v, float(scale), scale_mode, bool(causal))
