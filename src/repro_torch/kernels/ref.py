"""Plain PyTorch versions of the fused kernels.

They compute what the CUDA kernels compute, in the JAX package's
layouts (q ``(B, H, Sq, D)``, k/v ``(B, KVH, Sk, D)``; x ``(M, K)``,
w ``(K, N)``).  They are the CPU path, the oracle the kernels are held
against on the card, and the backward of every kernel's
``torch.autograd.Function``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def _expand_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, KVH, S, D) -> (B, KVH*groups, S, D), head h reading KV head h // groups."""
    if groups == 1:
        return x
    B, KVH, S, D = x.shape
    return x[:, :, None].expand(B, KVH, groups, S, D).reshape(B, KVH * groups, S, D)


def vjp(fn: Callable, inputs: Sequence[torch.Tensor], grads) -> Tuple[torch.Tensor, ...]:
    """The vector-Jacobian product of ``fn`` at ``inputs`` against
    ``grads`` (a tensor, or one per output): autograd through ``fn``, a
    gradient for every input, contiguous.  Callable inside a custom op's
    implementation, which runs below autograd (the dispatcher excludes
    the autograd keys there, and DTensor more besides): they are put
    back for the product."""
    from torch._C import DispatchKey

    exclude = torch._C._dispatch_tls_local_exclude_set()
    for key in (DispatchKey.AutogradFunctionality, DispatchKey.AutogradOther,
                DispatchKey.AutogradNestedTensor, DispatchKey.ADInplaceOrView):
        exclude = exclude.remove(key)
    live = [t.detach().requires_grad_(True) for t in inputs]
    with torch._C._ForceDispatchKeyGuard(torch._C._dispatch_tls_local_include_set(),
                                         exclude), torch.enable_grad():
        outs = fn(*live)
        if isinstance(outs, torch.Tensor):
            outs, grads = (outs,), (grads,)
        return tuple(d.contiguous() for d in torch.autograd.grad(outs, live, grads))


def sdpa_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Reference scaled-dot-product attention.

    q: (B, H, Sq, D); k, v: (B, KVH, Sk, D) with H % KVH == 0 (GQA).
    ``mask`` is additive, broadcastable to (B, H, Sq, Sk).  Scores and
    softmax in fp32; the probabilities are cast to v's dtype before the
    second product, as the JAX oracle does.
    """
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    k = _expand_kv(k, H // KVH)
    v = _expand_kv(v, H // KVH)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    s = torch.matmul(q.float(), k.float().transpose(-2, -1)) * scale
    if causal:
        row = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        col = torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(row >= col, s, torch.finfo(s.dtype).min)
    if mask is not None:
        s = s + mask.to(s.dtype)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Gather a contiguous per-row KV view out of a paged store.

    pages: (num_pages, page_size, KVH, D) — the flat page pool.
    page_table: (B, max_pages) int — per-row page indices; unallocated
    entries point at the trash page (0) and are masked out by the caller.

    Returns (B, KVH, max_pages * page_size, D), the layout a contiguous
    cache row has.
    """
    NP, ps, KVH, D = pages.shape
    B, MP = page_table.shape
    flat = pages.reshape(NP * ps, KVH, D)
    sl = torch.arange(MP * ps, device=pages.device)
    rows = page_table.long()[:, sl // ps] * ps + sl % ps  # (B, L)
    view = flat[rows]  # (B, L, KVH, D)
    return view.transpose(1, 2)


def paged_sdpa_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    pos: torch.Tensor,
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Reference paged-attention decode step (the kernel's oracle).

    q: (B, H, D) — one query token per row; k_pages/v_pages:
    (num_pages, page_size, KVH, D); page_table: (B, max_pages) int;
    pos: (B,) int — the query's position (keys at indices <= pos are
    live; with ``window``, also > pos - window).  Returns (B, H, D) in
    v's dtype.
    """
    ps = k_pages.shape[1]
    L = page_table.shape[1] * ps
    k = gather_pages(k_pages, page_table)
    v = gather_pages(v_pages, page_table)
    idx = torch.arange(L, device=q.device)[None, None, None, :]
    p = pos.long()[:, None, None, None]
    keep = idx <= p
    if window is not None:
        keep = keep & (idx > p - window)
    mask = torch.where(keep, 0.0, torch.finfo(torch.float32).min)
    return sdpa_ref(q[:, :, None, :], k, v, mask, scale=scale)[:, :, 0, :]


def fused_linear_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    act: Optional[str] = None,
) -> torch.Tensor:
    """Reference linear (+bias) (+activation). x: (..., K), w: (K, N).

    Product accumulated in fp32 and rounded to x's dtype before the
    bias and the activation, as the JAX oracle does.
    """
    y = torch.matmul(x.float(), w.float()).to(x.dtype)
    if b is not None:
        y = y + b
    return apply_act(y, act)


def swiglu_ref(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor) -> torch.Tensor:
    """Reference SwiGLU gate: silu(x·Wg) ⊙ (x·Wu), each product accumulated
    in fp32 and rounded to x's dtype, as the JAX oracle does."""
    g = torch.matmul(x.float(), w_gate.float()).to(x.dtype)
    u = torch.matmul(x.float(), w_up.float()).to(x.dtype)
    return F.silu(g) * u


def apply_act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """The five epilogue activations.  ``gelu`` is the tanh approximation
    (``jax.nn.gelu``'s default); ``gelu_exact`` is the erf form."""
    if act is None or act == "none":
        return y
    if act == "relu":
        return torch.relu(y)
    if act == "silu":
        return F.silu(y)
    if act == "gelu":
        return F.gelu(y, approximate="tanh")
    if act == "gelu_exact":
        return F.gelu(y)
    if act == "tanh":
        return torch.tanh(y)
    raise ValueError(f"unknown activation {act!r}")


def rg_lru_ref(
    x: torch.Tensor,
    a: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reference RG-LRU linear recurrence  h_t = a_t ⊙ h_{t-1} + x_t.

    x, a: (B, T, D); h0: (B, D) or None (zeros).  Returns h: (B, T, D) in
    x's dtype.  Computed in fp32 as a log-step (Hillis–Steele) doubling
    scan: after the step of span s, element t holds (A_t, X_t) with
    ``h_t = A_t · h_{t-s'} + X_t`` over the last 2s elements, so
    ceil(log2 T) steps of whole-tensor ops give ``h_t = A_t · h0 + X_t``
    — no Python loop over T (the JAX oracle's ``associative_scan``
    reassociates the same way).
    """
    A, X = a.float(), x.float()
    T = X.shape[1]
    s = 1
    while s < T:
        X = torch.cat([X[:, :s], A[:, s:] * X[:, :-s] + X[:, s:]], dim=1)
        A = torch.cat([A[:, :s], A[:, s:] * A[:, :-s]], dim=1)
        s *= 2
    if h0 is not None:
        X = X + A * h0.float()[:, None, :]
    return X.to(x.dtype)


def rg_lru_chunk_ref(
    x: torch.Tensor,
    a: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
) -> tuple:
    """Chunked-prefill RG-LRU oracle: ``(h, h_last)`` for one chunk, with
    ``h_last == h[:, -1]`` — the carry a caller folds into the next
    chunk's ``h0``; chaining chunks with it is the unchunked scan."""
    h = rg_lru_ref(x, a, h0)
    return h, h[:, -1, :].clone()


def rms_norm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Reference RMSNorm: x · rsqrt(mean(x², -1) + eps) · w, in fp32, cast
    back to x's dtype.  x: (..., d); w: (d,)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
