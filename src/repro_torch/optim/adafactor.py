"""Adafactor (Shazeer & Stern 2018), factored second moments: a port of
the JAX package's ``optim/adafactor.py``.

Leaves with ndim >= 2 keep row and column statistics over their last two
dims; 1-D leaves an unfactored second moment.  Each leaf's update is
RMS-clipped as a whole, and ``beta2_t = 1 - step^-decay``.

**The stacked view.**  Under ``scan_layers`` the JAX package stacks the
layers of a layer list (a leading ``n_layers`` axis on every leaf), so
its Adafactor sees an (L, d) norm scale as a 2-D leaf, factored over the
layer axis, and clips an (L, n, m) weight over all L layers at once.  The
port keeps per-layer lists; applied leaf by leaf it would compute
something else.  So Adafactor works on the stacked view: the layers of
each list in ``stacked`` are stacked leaf by leaf, updated as one leaf,
and split back.  ``for_config(cfg)`` sets ``stacked`` to the lists the
JAX package stacks for ``cfg`` (:func:`stacked_keys`); the train step
takes no other.  The optimizer state keeps the stacked layout, which is
the JAX package's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch
from torch.utils import _pytree as pytree

from .adamw import clipped_fp32, leaves_like


class AdafactorState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    vr: Any  # row stats   (tree; a zeros scalar where unfactored)
    vc: Any  # column stats
    v: Any   # unfactored fallback (a zeros scalar where factored)


def stacked_keys(cfg) -> Tuple[str, ...]:
    """The layer lists the JAX package stacks for ``cfg``: the dense, MoE
    and VLM decoders' ``blocks`` and the encoder-decoder's two lists under
    ``scan_layers``; the recurrent families keep lists of layers."""
    if not cfg.scan_layers:
        return ()
    if cfg.family in ("dense", "moe", "vlm"):
        return ("blocks",)
    if cfg.family == "encdec":
        return ("enc_blocks", "dec_blocks")
    return ()


def stack_layers(tree: Dict[str, Any], keys) -> Dict[str, Any]:
    """``tree`` with each layer list in ``keys`` stacked leaf by leaf
    (a leading layer axis), the JAX package's ``scan_layers`` layout."""
    out = dict(tree)
    for k in keys:
        layers = tree[k]
        cols = zip(*(pytree.tree_leaves(layer) for layer in layers))
        out[k] = pytree.tree_unflatten([torch.stack(c) for c in cols],
                                       pytree.tree_structure(layers[0]))
    return out


def unstack_layers(tree: Dict[str, Any], keys) -> Dict[str, Any]:
    """The inverse of :func:`stack_layers`: per-layer lists again."""
    out = dict(tree)
    for k in keys:
        flat, spec = pytree.tree_flatten(tree[k])
        out[k] = [pytree.tree_unflatten([t[i] for t in flat], spec)
                  for i in range(flat[0].shape[0])]
    return out


@dataclass(frozen=True)
class Adafactor:
    lr: float = 1e-3
    decay: float = 0.8  # beta2_t = 1 - step^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0
    #: the layer lists updated in the stacked view
    stacked: Tuple[str, ...] = ()

    def for_config(self, cfg) -> "Adafactor":
        """This optimizer with the JAX package's stacked lists for ``cfg``."""
        return dataclasses.replace(self, stacked=stacked_keys(cfg))

    def _keys(self, params) -> Tuple[str, ...]:
        return tuple(k for k in self.stacked if isinstance(params, dict) and k in params)

    def init(self, params: Any) -> AdafactorState:
        view = stack_layers(params, self._keys(params))
        f32 = dict(dtype=torch.float32)

        def row(p):
            return torch.zeros(p.shape[:-1] if p.ndim >= 2 else (), device=p.device, **f32)

        def col(p):
            return torch.zeros(p.shape[:-2] + p.shape[-1:] if p.ndim >= 2 else (),
                               device=p.device, **f32)

        def full(p):
            return torch.zeros(() if p.ndim >= 2 else p.shape, device=p.device, **f32)

        device = pytree.tree_leaves(params)[0].device
        t = pytree.tree_map
        return AdafactorState(step=torch.zeros((), dtype=torch.int32, device=device),
                              vr=t(row, view), vc=t(col, view), v=t(full, view))

    def update(self, grads: Any, state: AdafactorState, params: Any,
               lr_scale: Union[float, torch.Tensor] = 1.0) -> Tuple[Any, AdafactorState]:
        keys = self._keys(params)
        step = state.step + 1
        beta2 = 1.0 - step.float() ** (-self.decay)
        view = stack_layers(params, keys)
        flat_p, spec = pytree.tree_flatten(view)
        flat_g = clipped_fp32(leaves_like(view, stack_layers(grads, keys)), self.grad_clip)
        flat_vr, flat_vc, flat_v = (leaves_like(view, s) for s in (state.vr, state.vc, state.v))

        def upd(g, vr, vc, v, p):
            g2 = g * g + self.eps
            if p.ndim >= 2:
                vr2 = beta2 * vr + (1 - beta2) * g2.mean(-1)
                vc2 = beta2 * vc + (1 - beta2) * g2.mean(-2)
                # normalized row stats (Shazeer & Stern Alg. 4)
                r = vr2 / torch.clamp(vr2.mean(-1, keepdim=True), min=self.eps)
                u = (g * torch.rsqrt(r + self.eps)[..., None]
                     * torch.rsqrt(vc2 + self.eps)[..., None, :])
                v2 = v
            else:
                v2 = beta2 * v + (1 - beta2) * g2
                u = g * torch.rsqrt(v2 + self.eps)
                vr2, vc2 = vr, vc
            # update clipping by RMS (Adafactor §6)
            rms = torch.sqrt((u * u).mean() + 1e-30)
            u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
            p32 = p.float()
            new_p = p32 - self.lr * lr_scale * (u + self.weight_decay * p32)
            return new_p.to(p.dtype), vr2, vc2, v2

        out = [upd(*a) for a in zip(flat_g, flat_vr, flat_vc, flat_v, flat_p)]

        def tree(i):
            return pytree.tree_unflatten([o[i] for o in out], spec)

        return unstack_layers(tree(0), keys), AdafactorState(
            step=step, vr=tree(1), vc=tree(2), v=tree(3))
