"""Dispatch for the fused graph nodes (``forge.sdpa``, ``forge.linear_act``,
``forge.swiglu``),
the recurrent block's RG-LRU scan (``rg_lru``, ``rg_lru_scan``) and the
fused RMSNorm (``rms_norm``), plus the decorators that make a plain torch
function one opaque graph node (:func:`forge_op`, :func:`scan_op`).

Every fused node the Phase-2 passes create bottoms out here.  The
implementation follows the tensors' device:

* a CUDA tensor launches the hand-written kernel, or raises — there is
  no fallback to the plain version on the card;
* a CPU tensor takes the kernel's plain PyTorch version;
* ``impl="ref"`` runs the plain version on any device (the oracle that
  ``chip_smoke.py`` and the tests hold the kernels against).

Routing follows the JAX package's ``kernels/ops.py`` with one change:
flash attention takes every unmasked attention, a single query row
included (the encoder-decoder family's cross-attention at decode, Sq = 1
against the encoder frames); the JAX package sends Sq = 1 to XLA.
Masked attention is plain masked-softmax attention in torch (XLA in the
JAX package, never a Pallas kernel there either).
"""
from __future__ import annotations

import inspect
from typing import Callable, Optional, Tuple

import torch

from . import ref as _ref
from . import rg_lru as _rg_lru_kernel
from . import rms_norm as _rms_norm_kernel
from .flash_attention import flash_attention
from .fused_linear import fused_linear as _fused_linear_kernel

_VALID_IMPLS = (None, "ref")

# sequences with Sq*Sk beyond this use the q-chunked softmax path
_CHUNK_THRESHOLD = 4096 * 4096
_DEFAULT_Q_CHUNK = 1024


def _check_impl(impl: Optional[str]) -> None:
    if impl not in _VALID_IMPLS:
        raise ValueError(f"impl must be one of {_VALID_IMPLS}, got {impl!r}")


def forge_op(name: str) -> Callable[[Callable], Callable]:
    """Mark a function as an opaque fused dispatch unit.

    The JAX package's ``forge_op`` names a ``jax.jit`` wrapper
    ``forge_<name>``, which Phase-1 capture keeps as one ``forge.<name>``
    node routed to the accelerator (the paper's custom-operator
    registration hook, §9.5).  Here the function (of floating tensors,
    one tensor out) becomes the custom op ``repro_torch::forge_<name>``:
    one ``repro_torch.forge_<name>.default`` node, which Phase 3 routes to
    the accelerator like the kernel ops (``lowering.KERNEL_OP_PREFIX``);
    the executor calls the op, which runs the plain torch function on the
    tensors' device.

    Its gradient is the op ``repro_torch::forge_<name>_backward(*inputs,
    grad)``: the vector-Jacobian product of the function on the saved
    inputs (as ``jax.grad`` differentiates the JAX package's
    ``forge_op``), an op of its own so that its sharding strategy
    (``distrib/sharding.py``) keeps a planned call's backward on each
    device's local shards.
    """
    qualname = f"repro_torch::forge_{name}"

    def deco(fn: Callable) -> Callable:
        n = len(inspect.signature(fn).parameters)
        schema = (f"({', '.join(f'Tensor a{i}' for i in range(n))}, Tensor grad) -> "
                  f"({', '.join(['Tensor'] * n)})")
        bwd = torch.library.custom_op(f"{qualname}_backward",
                                      lambda *args: _ref.vjp(fn, args[:n], args[n]),
                                      mutates_args=(), schema=schema)
        bwd.register_fake(lambda *args: tuple(a.new_empty(a.shape) for a in args[:n]))
        op = torch.library.custom_op(qualname, mutates_args=())(fn)
        op.register_fake(fn)

        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(*inputs)

        op.register_autograd(lambda ctx, g: bwd(*ctx.saved_tensors, g),
                             setup_context=setup_context)
        return op

    return deco


def scan_op(name: str, fake: Callable) -> Callable[[Callable], Callable]:
    """Mark a function holding a sequential loop as one opaque node.

    The JAX package's capture keeps control flow (``lax.scan``) as one
    ``scan`` node routed to the host; ``torch.export`` would unroll a
    Python loop instead (T steps of its body).  The function becomes the
    custom op ``forge_scan::<name>``: one ``forge_scan.<name>.default``
    node, outside the accelerator prefixes, so Phase 3 routes it to the
    host as the reference routes ``scan``.  ``fake`` builds the outputs
    directly: running the loop on fake tensors would cost a capture as
    much host time as the loop's own ops.  ``fn`` must be annotated (the
    op's schema is read from its signature), return a tuple of tensors
    and return no view of an input.

    Its gradient is the op ``forge_scan::<name>_backward(*inputs, *grads)``
    (a gradient of each output, or None): the vector-Jacobian product of
    the loop on the saved inputs (as ``jax.grad`` differentiates the JAX
    package's ``lax.scan``), one gradient for each tensor argument; an
    optional tensor argument is a mask and gets none.  It is an op of its
    own so that its sharding strategy (``distrib/sharding.py``) runs a
    planned call's backward on each device's rows, and its fake builds
    the gradients without the loop."""
    qualname = f"forge_scan::{name}"

    def deco(fn: Callable) -> Callable:
        from torch._library.infer_schema import infer_schema

        op = torch.library.custom_op(qualname, mutates_args=())(fn)
        op.register_fake(fake)
        args = op._opoverload._schema.arguments
        n_out = len(op._opoverload._schema.returns)
        masks = [str(a.type) == "Optional[Tensor]" for a in args]
        diff = [i for i, m in enumerate(masks) if not m]
        head = infer_schema(fn, mutates_args=()).split(" -> ")[0][1:-1]
        schema = (f"({head}, {', '.join(f'Tensor? g{j}' for j in range(n_out))}) -> "
                  f"({', '.join(['Tensor'] * len(diff))})")

        def backward_impl(*a):
            inputs, grads = a[:len(args)], a[len(args):]
            return _scan_vjp(fn, inputs, diff, grads)

        bwd = torch.library.custom_op(f"{qualname}_backward", backward_impl,
                                      mutates_args=(), schema=schema)
        bwd.register_fake(lambda *a: tuple(a[i].new_empty(a[i].shape) for i in diff))

        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(*inputs)

        def backward(ctx, *grads):
            got = iter(bwd(*ctx.saved_tensors, *grads))
            return tuple(next(got) if i in diff else None for i in range(len(args)))

        op.register_autograd(backward, setup_context=setup_context)
        return op

    return deco


def _scan_vjp(fn: Callable, inputs, diff, grads) -> Tuple[torch.Tensor, ...]:
    """The gradients of ``fn``'s inputs at the indices ``diff`` against
    ``grads`` (one an output, None for an output with none), contiguous."""
    args = list(inputs)

    def part(*live):
        for i, t in zip(diff, live):
            args[i] = t
        return fn(*args)

    used = [j for j, g in enumerate(grads) if g is not None]
    return _ref.vjp(lambda *live: tuple(part(*live)[j] for j in used),
                    [inputs[i] for i in diff], tuple(grads[j] for j in used))


def _apply_scale(s, scale, scale_mode):
    if scale is None or scale_mode == "none":
        return s
    if scale_mode == "div":
        return s / scale
    if scale_mode == "mul":
        return s * scale
    raise ValueError(f"bad scale_mode {scale_mode!r}")


def _sdpa_direct(q, k, v, mask, *, scale, scale_mode, causal, out_dtype,
                 row0: int = 0, sq_total: Optional[int] = None):
    """Masked-softmax attention with fp32 scores, one downcast at the end.

    ``row0``/``sq_total`` place a query chunk inside the full query range
    so the causal alignment stays ``Sk - Sq`` of the whole sequence.
    """
    s = torch.matmul(q.float(), k.float().transpose(-2, -1))
    s = _apply_scale(s, scale, scale_mode)
    Sq, Sk = s.shape[-2], s.shape[-1]
    if causal:
        total = Sq if sq_total is None else sq_total
        row = torch.arange(Sq, device=s.device)[:, None] + row0 + (Sk - total)
        col = torch.arange(Sk, device=s.device)[None, :]
        s = torch.where(row >= col, s, torch.finfo(s.dtype).min)
    if mask is not None:
        s = s + mask.to(s.dtype)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(out_dtype)


def _sdpa_chunked(q, k, v, mask, *, scale, scale_mode, causal, q_chunk,
                  out_dtype):
    """q-chunked softmax attention: O(c·Sk) live scores instead of O(Sq·Sk)."""
    Sq, Sk = q.shape[-2], k.shape[-2]
    c = min(q_chunk, Sq)
    while Sq % c:
        c //= 2
    c = max(c, 1)
    if mask is not None:
        mask = mask.expand(*mask.shape[:-2], Sq, Sk)
    outs = []
    for i in range(0, Sq, c):
        m_i = mask[..., i:i + c, :] if mask is not None else None
        outs.append(_sdpa_direct(
            q[:, :, i:i + c], k, v, m_i, scale=scale, scale_mode=scale_mode,
            causal=causal, out_dtype=out_dtype, row0=i, sq_total=Sq,
        ))
    return torch.cat(outs, dim=2)


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    scale_mode: str = "mul",
    causal: bool = False,
    groups: int = 1,
    impl: Optional[str] = None,
    q_chunk: int = _DEFAULT_Q_CHUNK,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Fused scaled-dot-product attention dispatch.

    q: (B, H, Sq, D);  k, v: (B, H/groups, Sk, D).  ``mask`` is additive.
    ``out_dtype`` defaults to v.dtype.
    """
    _check_impl(impl)
    out_dtype = out_dtype or v.dtype
    if q.shape[1] != k.shape[1] * groups:
        raise ValueError(f"sdpa: H={q.shape[1]} != KVH={k.shape[1]} * groups={groups}")
    if scale is None:
        scale, scale_mode = 1.0 / (q.shape[-1] ** 0.5), "mul"
    if impl is None and mask is None:
        return flash_attention(q, k, v, scale=scale, scale_mode=scale_mode,
                               causal=causal).to(out_dtype)
    kx, vx = _ref._expand_kv(k, groups), _ref._expand_kv(v, groups)
    if q.shape[-2] * kx.shape[-2] > _CHUNK_THRESHOLD and q.shape[-2] > 1:
        return _sdpa_chunked(q, kx, vx, mask, scale=scale, scale_mode=scale_mode,
                             causal=causal, q_chunk=q_chunk, out_dtype=out_dtype)
    return _sdpa_direct(q, kx, vx, mask, scale=scale, scale_mode=scale_mode,
                        causal=causal, out_dtype=out_dtype)


def fused_linear(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    act: Optional[str] = None,
    residual: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """y = act(x·w + b) (+ residual).  x: (..., K), w: (K, N).

    The residual is added after the kernel, in x's dtype.
    """
    _check_impl(impl)
    if impl is None:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y = _fused_linear_kernel(x2, w.contiguous(),
                                 b.contiguous() if b is not None else None,
                                 act=act).reshape(*lead, w.shape[-1])
    else:
        y = _ref.fused_linear_ref(x, w, b, act=act)
    if residual is not None:
        y = y + residual
    return y


def swiglu(
    x: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    *,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Fused SwiGLU gate (beyond-paper mega-fusion): silu(x·Wg) ⊙ (x·Wu).
    x: (..., K); w_gate, w_up: (K, N).

    As the JAX package's kernel branch: two launches of the fused-linear
    kernel, the gate with ``act="silu"`` in its epilogue and the up
    projection plain, then their product in x's dtype."""
    _check_impl(impl)
    if impl is None:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        g = _fused_linear_kernel(x2, w_gate.contiguous(), None, act="silu")
        u = _fused_linear_kernel(x2, w_up.contiguous(), None, act=None)
        return (g * u).reshape(*lead, w_gate.shape[-1])
    return _ref.swiglu_ref(x, w_gate, w_up)


# --------------------------------------------------------------------------
# RG-LRU linear recurrence (the recurrent block's pre-fused dispatch)
# --------------------------------------------------------------------------


def rg_lru(
    x: torch.Tensor,
    a: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
    *,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t-1} + x_t over axis 1.  x, a: (B, T, D)."""
    _check_impl(impl)
    if impl is None:
        return _rg_lru_kernel.rg_lru(x, a, h0)
    return _ref.rg_lru_ref(x, a, h0)


def rg_lru_scan(
    x: torch.Tensor,
    a: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
    *,
    impl: Optional[str] = None,
) -> tuple:
    """Chunked-prefill RG-LRU scan: ``(h, h_last)`` for one chunk.

    Same recurrence as :func:`rg_lru` plus the ``h[:, -1]`` carry as a
    second output, so a caller chaining prompt chunks folds state
    between them without slicing the full sequence (the kernel writes
    it in the same launch)."""
    _check_impl(impl)
    if impl is None:
        return _rg_lru_kernel.rg_lru_chunked(x, a, h0)
    return _ref.rg_lru_chunk_ref(x, a, h0)


# --------------------------------------------------------------------------
# RMSNorm (the ``rms_norm_pallas`` dispatch; no model calls it, as in the
# JAX package)
# --------------------------------------------------------------------------


def rms_norm(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    eps: float = 1e-6,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Fused RMSNorm: x · rsqrt(mean(x², -1) + eps) · w.  x: (..., d); w: (d,)."""
    _check_impl(impl)
    if impl is None:
        return _rms_norm_kernel.rms_norm(x, w, eps)
    return _ref.rms_norm_ref(x, w, eps)


__all__ = ["sdpa", "fused_linear", "swiglu", "rg_lru", "rg_lru_scan", "rms_norm", "forge_op",
           "scan_op"]
