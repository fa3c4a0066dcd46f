"""Pass — device-constant insertion (paper Table 10's "Device Constant").

The paper inserts explicit device-placement constants so accelerator
dispatches never re-marshal host literals.  In the ATen graph the
literal tensors that the executor would rebuild on every dispatch are
the tensor factories: a node with no tensor operand (``full``,
``arange``, ``scalar_tensor``, ``ones`` …) makes its tensor from frozen
literals at every call.  This pass materializes each one once, on the
device its ``device`` argument names (the program's device), and
promotes it to a graph constant, which the executors load into the
register file once at build time (paper Listing 9's
``regs = dict(self.constants)``).  A promoted constant is held by the
graph and the lowered program, so it lives as long as they do and sits
at one address: a CUDA graph captured over it reads it there.

Scalars stay literals (they parameterize kernels, not buffers).  The
pool is idempotent: constants of equal shape, dtype, device and bytes
share one slot (existing constants seed the pool), so the fixpoint loop
cannot grow it.  With constant folding on, the factories under its cap
are folded already; this pass then dedups, and promotes what folding
left (folding off, or a larger factory up to this pass's own cap).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from ..graph import Graph, GNode
from .base import ForgePass
from .fold import dispatch_mode_active, foldable_op, is_plain_tensor, mutating_users

#: factories with at least this many elements are promoted
_PROMOTE_MIN_ELEMS = 2
#: constants up to this many elements are pooled by value
_POOL_MAX_ELEMS = 4096


def _pool_key(t: torch.Tensor) -> Tuple[Any, ...]:
    if t.numel() > _POOL_MAX_ELEMS:
        return ("big", id(t))
    data = t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return (tuple(t.shape), t.dtype, str(t.device), data)


class DeviceConstantPass(ForgePass):
    name = "device_constant"

    def __init__(self, max_elements: int = 1 << 20):
        self.max_elements = max_elements
        self.last_detail: Dict[str, Any] = {}

    def _factory(self, g: Graph, node: GNode) -> bool:
        if node.invars or len(node.outvars) != 1 or not foldable_op(node):
            return False
        ov = node.outvars[0]
        return (_PROMOTE_MIN_ELEMS <= math.prod(ov.shape) <= self.max_elements
                and not g.is_output(ov) and not mutating_users(g, ov))

    def run(self, g: Graph) -> bool:
        promoted = shared = 0
        pool: Dict[Any, Any] = {}
        used = {iv.vid for n in g.nodes.values() for iv in n.invars}
        for cv, cval in zip(list(g.constvars), list(g.consts)):
            if not is_plain_tensor(cval):
                continue
            first = pool.setdefault(_pool_key(cval), cv)
            if first is not cv and cv.vid in used and not g.is_output(cv) \
                    and not mutating_users(g, cv) and not mutating_users(g, first):
                g.replace_all_uses(cv, first)
                shared += 1
        if not dispatch_mode_active():
            for node in list(g.nodes.values()):
                if not self._factory(g, node):
                    continue
                with torch.no_grad():
                    val = node.target(*node.params["args"], **node.params["kwargs"])
                ov = node.outvars[0]
                if not is_plain_tensor(val) or tuple(val.shape) != ov.shape \
                        or val.dtype != ov.dtype:
                    continue
                key = _pool_key(val)
                cv = pool.get(key)
                if cv is None:
                    cv = pool[key] = g.add_const(val)
                g.replace_all_uses(ov, cv)
                g.erase_node(node)
                promoted += 1
        self.last_detail = {"promoted": promoted, "shared": shared}
        return (promoted + shared) > 0
