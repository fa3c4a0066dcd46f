"""Pass 3 — constant folding (paper §4.3.3).

Two rewrites over the ATen graph, as the paper describes them for
transformer graphs:

* **identity arithmetic** — ``add``/``sub`` of a scalar 0, ``mul``/
  ``div`` by a scalar 1 and ``pow(x, 1)`` collapse onto ``x`` where the
  result has ``x``'s shape and dtype (paper: "identity arithmetic that
  arises in shape calculations");
* **literal evaluation** — an ATen node whose operands are all graph
  constants or frozen literals (an ``arange``, a mask built from two
  ``arange``\\ s, a RoPE frequency table, a cast of a constant) is run
  once at compile time and replaced by a graph constant.  A cap of
  ``1 << 20`` elements per value keeps huge materializations out of the
  constant pool (the reference's cap).

What is never folded, so that a folded graph computes what the
unfolded one does on every call:

* an op with a mutable schema, a random op (``nondeterministic_seeded``),
  ``empty*`` / ``new_empty*`` (undefined contents), a kernel custom op
  (``repro_torch::*``, ``forge_scan::*``) or a fused ``forge.*`` node;
* a value a graph output or a mutating op would hand on: the constant
  would be shared between calls;
* a constant that is not a plain tensor (a ``FakeTensor`` met when a body
  compiles inside an outer ``torch.export``), or any fold while a
  dispatch mode is active: the reference's ``Tracer`` check.

Parameters are graph inputs (``static_argnums``), never constants, so
folding never reads a parameter or a value derived from one: the
segment backend's read-at-address contract stays whole.  The folded op
runs on its constants' own device (a factory on its ``device``
argument), so the constant holds the bits the node would have produced
at run time.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from ..graph import Graph, GNode, GVar, _fill_template
from .base import ForgePass
from . import _match as M

#: op -> (identity value, which operand may be the literal)
_IDENTITIES = {
    "aten.add.Tensor": (0.0, "either"),
    "aten.sub.Tensor": (0.0, "rhs"),
    "aten.mul.Tensor": (1.0, "either"),
    "aten.div.Tensor": (1.0, "rhs"),
    "aten.pow.Tensor_Scalar": (1.0, "rhs"),
}
#: op namespaces that are kernels or opaque loops, never folded
_OPAQUE_PREFIXES = ("repro_torch.", "forge_scan.", "forge.")


def dispatch_mode_active() -> bool:
    """True inside a ``torch.export`` / fake-tensor trace: an op run now
    would give a traced value, not a concrete one."""
    return torch._C._len_torch_dispatch_stack() > 0


def is_plain_tensor(x: Any) -> bool:
    return type(x) is torch.Tensor


def foldable_op(node: GNode) -> bool:
    """An ATen op that computes the same values on every call from the
    same operands, with no side effect."""
    op = node.target
    if not isinstance(op, torch._ops.OpOverload) or node.op.startswith(_OPAQUE_PREFIXES):
        return False
    if op._schema.is_mutable or torch.Tag.nondeterministic_seeded in op.tags:
        return False
    return "empty" not in op._schema.name and bool(node.outvars)


def mutating_users(g: Graph, v: GVar) -> bool:
    return any(isinstance(u.target, torch._ops.OpOverload) and u.target._schema.is_mutable
               for u in g.users(v))


class ConstantFoldingPass(ForgePass):
    name = "constant_folding"

    def __init__(self, max_elements: int = 1 << 20):
        self.max_elements = max_elements
        self.last_detail: Dict[str, Any] = {}

    def _try_identity(self, g: Graph, node: GNode) -> bool:
        ident = _IDENTITIES.get(node.op)
        if ident is None or len(node.invars) != 1:
            return False
        val, side = ident
        args = node.args
        if len(args) != 2 or node.params.get("kwargs", {}).get("alpha", 1) != 1:
            return False
        a, b = args
        keep = None
        if side in ("rhs", "either") and M.scalar_lit(b) == val and isinstance(a, GVar):
            keep = a
        elif side == "either" and M.scalar_lit(a) == val and isinstance(b, GVar):
            keep = b
        out = node.outvars[0]
        if keep is None or keep.shape != out.shape or keep.dtype != out.dtype:
            return False
        if g.is_output(out) and not g.producer(keep):
            return False  # an output never becomes an input or a constant itself
        g.replace_all_uses(out, keep)
        g.erase_node(node)
        return True

    def _try_fold(self, g: Graph, node: GNode, consts: Dict[int, int]) -> bool:
        if not foldable_op(node):
            return False
        if sum(math.prod(ov.shape) for ov in node.outvars) > self.max_elements:
            return False
        vals: List[torch.Tensor] = []
        for iv in node.invars:
            i = consts.get(iv.vid)
            if i is None:
                return False
            c = g.consts[i]
            if not is_plain_tensor(c) or c.numel() > self.max_elements:
                return False
            vals.append(c)
        for ov in node.outvars:
            if g.is_output(ov) or mutating_users(g, ov):
                return False
        try:
            with torch.no_grad():
                outs = node.target(*_fill_template(node.params["args"], vals),
                                   **_fill_template(node.params["kwargs"], vals))
        except Exception:  # noqa: BLE001 — an op that cannot run here stays
            return False
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        if len(outs) != len(node.outvars) or not all(
                is_plain_tensor(o) and tuple(o.shape) == ov.shape and o.dtype == ov.dtype
                for o, ov in zip(outs, node.outvars)):
            return False
        for ov, res in zip(node.outvars, outs):
            cv = g.add_const(res)
            consts[cv.vid] = len(g.consts) - 1
            g.replace_all_uses(ov, cv)
        g.erase_node(node)
        return True

    def run(self, g: Graph) -> bool:
        folded = idents = 0
        consts = g.const_index()
        fold = not dispatch_mode_active()
        for node in list(g.nodes.values()):
            if node.nid not in g.nodes:
                continue
            if self._try_identity(g, node):
                idents += 1
            elif fold and self._try_fold(g, node, consts):
                folded += 1
        self.last_detail = {"folded": folded, "identities": idents}
        return (folded + idents) > 0
