"""AdamW with decoupled weight decay over a pytree of tensors: a port of
the JAX package's ``optim/adamw.py``.

Moments are fp32 and shaped like the parameters.  The update is computed
in fp32 and cast back to each parameter's dtype (bf16 parameters are
updated as the reference updates them: no fp32 master copy).  The
arithmetic runs leaf-wise through ``torch._foreach_*`` ops, in the
reference's order of operations, and is out of place: ``update`` returns
new parameter and moment tensors and writes none of its inputs.

A sharding plan's DTensor leaves (a planned step, the dry run) take the
same ops one leaf at a time (:func:`_ops_for`): DTensor plans a
``_foreach`` op over the whole list at once, a plan its cache never
serves again (the key is the list) and whose search grows with the
mesh's dims; leaf by leaf, each op's plan is made once for the layers'
alike leaves.  Each ``_foreach`` op is its op on each leaf (a norm may
reduce in another order).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.utils import _pytree as pytree


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32, on the parameters' device
    mu: Any  # first moment (a tree like the params, fp32)
    nu: Any  # second moment


def leaves_like(params: Any, tree: Any) -> List[Any]:
    """The leaves of ``tree`` (grads or a state shaped like ``params``) in
    ``params``' flattening order: dicts are matched by key, whatever
    order each was built in (the JAX package's trees come with sorted
    keys, as ``flatten_up_to`` matches them there)."""
    if isinstance(params, dict):
        return [x for k in params for x in leaves_like(params[k], tree[k])]
    if isinstance(params, (list, tuple)):
        return [x for p, t in zip(params, tree) for x in leaves_like(p, t)]
    return [tree]


class _PerLeaf:
    """The ``torch._foreach_*`` ops the update uses, one leaf at a time
    (``other``: a list of tensors, one tensor or a number)."""

    @staticmethod
    def _each(op, a, b):
        if isinstance(b, (list, tuple)):
            return [op(x, y) for x, y in zip(a, b)]
        return [op(x, b) for x in a]

    def _foreach_add(self, a, b):
        return self._each(torch.add, a, b)

    def _foreach_sub(self, a, b):
        return self._each(torch.sub, a, b)

    def _foreach_mul(self, a, b):
        return self._each(torch.mul, a, b)

    def _foreach_div(self, a, b):
        return self._each(torch.div, a, b)

    def _foreach_sqrt(self, a):
        return [torch.sqrt(x) for x in a]

    def _foreach_norm(self, a, ord):
        return [torch.linalg.vector_norm(x, ord) for x in a]


_PER_LEAF = _PerLeaf()


def _ops_for(leaves: Sequence[Any]) -> Any:
    """``torch`` for plain leaves; :data:`_PER_LEAF` where a leaf is a
    DTensor (module docstring)."""
    return _PER_LEAF if any(type(t) is not torch.Tensor and isinstance(t, torch.Tensor)
                            and hasattr(t, "placements") for t in leaves) else torch


def global_norm(tree: Any) -> torch.Tensor:
    """The L2 norm over every leaf of ``tree``, in fp32 (0-d tensor)."""
    return _norm([leaf.float() for leaf in pytree.tree_leaves(tree)])


def _norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(_ops_for(leaves)._foreach_norm(list(leaves), 2)))


def clipped_fp32(leaves: Sequence[torch.Tensor], grad_clip: Optional[float]
                 ) -> List[torch.Tensor]:
    """The gradients in fp32, scaled by ``min(1, clip / (‖g‖ + 1e-9))``
    over every leaf when ``grad_clip`` is set (the JAX package's
    clipping, whose scale promotes bf16 gradients to fp32)."""
    g32 = [g.float() for g in leaves]
    if grad_clip is None:
        return g32
    scale = torch.clamp(grad_clip / (_norm(g32) + 1e-9), max=1.0)
    return _ops_for(g32)._foreach_mul(g32, scale)


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0

    def init(self, params: Any) -> AdamWState:
        def zeros():
            return pytree.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)

        device = pytree.tree_leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                          mu=zeros(), nu=zeros())

    def update(self, grads: Any, state: AdamWState, params: Any,
               lr_scale: Union[float, torch.Tensor] = 1.0) -> Tuple[Any, AdamWState]:
        step = state.step + 1
        flat_p, spec = pytree.tree_flatten(params)
        flat_g = leaves_like(params, grads)
        flat_m, flat_v = leaves_like(params, state.mu), leaves_like(params, state.nu)
        if not len(flat_g) == len(flat_m) == len(flat_v) == len(flat_p):
            raise ValueError(f"AdamW: {len(flat_p)} params, {len(flat_g)} grads, "
                             f"{len(flat_m)} / {len(flat_v)} moments")
        f = _ops_for(flat_p)
        g = clipped_fp32(flat_g, self.grad_clip)
        m2 = f._foreach_add(f._foreach_mul(flat_m, self.b1), f._foreach_mul(g, 1 - self.b1))
        v2 = f._foreach_add(f._foreach_mul(flat_v, self.b2),
                            f._foreach_mul(f._foreach_mul(g, 1 - self.b2), g))
        t = step.float()
        mhat = f._foreach_div(m2, 1 - self.b1 ** t)
        vhat = f._foreach_div(v2, 1 - self.b2 ** t)
        delta = f._foreach_div(mhat, f._foreach_add(f._foreach_sqrt(vhat), self.eps))
        p32 = [p.float() for p in flat_p]
        delta = f._foreach_add(delta, f._foreach_mul(p32, self.weight_decay))
        new_p = f._foreach_sub(p32, f._foreach_mul(delta, self.lr * lr_scale))
        new_p = [x.to(p.dtype) for x, p in zip(new_p, flat_p)]
        return pytree.tree_unflatten(new_p, spec), AdamWState(
            step=step, mu=pytree.tree_unflatten(m2, spec), nu=pytree.tree_unflatten(v2, spec))
