"""Pass 6 — layout optimization (paper §4.3.6), on the ATen graph.

The paper inserts ``.contiguous()`` / channels-last conversions at NPU
boundaries and cancels redundant conversions.  The layout concerns of
an ATen LM graph on the H100 are:

* **transpose ∘ transpose** — ``transpose`` / ``permute`` / ``t`` pairs
  whose permutations compose to the identity are cancelled;
* **cast chains** — ``to(to(x, mid), dst)`` collapses to ``to(x, dst)``
  when ``mid`` holds every value of ``x`` exactly (the reference's
  value-preserving rule: float kinds, ``mid`` no narrower than ``x`` or
  ``dst``), and a cast to the dtype a value already has is erased;
* **view / reshape chains** collapse into one ``reshape`` of the source
  (or onto the source when the shapes agree);
* **transpose absorption into the product**: ``matmul(x, t(w))`` with a
  rank-2 ``w`` becomes ``linear(x, w)``, which reads ``w`` as stored (the
  tied LM head, ``layers.lm_head(..., transpose=True)``).  ATen's
  ``linear`` without a bias is ``matmul(x, w.t())``, so the values are
  the same bits; Phase 3 routes it to the accelerator (``ACCEL_OPS``);
* **tile hints**: ``forge.*`` nodes and bare products get
  ``meta["block_hint"]`` from :data:`HOPPER_PREFERRED_TILES`, the port's
  kernel tiles (the reference's ``MXU_PREFERRED_TILES``).  As in the
  reference nothing reads the hint: the kernels plan their own tiles.

``rewrite=False`` (λ = "hints") keeps only the annotation.  Every
sub-pass is idempotent, so the fixpoint loop cannot inflate the graph;
the annotation does not count as a modification.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ...kernels.fused_linear import WG_BK, WG_BN
from ..graph import Graph, GNode, GVar, Ref
from .base import ForgePass
from .fold import mutating_users
from . import _match as M

#: (K-tile, N-tile) of the fused-linear warpgroup kernel
#: (kernels/fused_linear.py ``WG_BK``, ``WG_BN``); (query rows, keys) of a
#: flash-attention warpgroup CTA (csrc/flash_attention.cu ``FW_Q``, ``BKV``
#: at D > 64)
HOPPER_PREFERRED_TILES: Dict[str, Tuple[int, int]] = {
    "forge.sdpa": (128, 64),
    "forge.linear_act": (WG_BK, WG_BN),
    "forge.swiglu": (WG_BK, WG_BN),
    "aten.matmul.default": (WG_BK, WG_BN),
    "aten.linear.default": (WG_BK, WG_BN),
}

_PERMUTES = ("aten.transpose.int", "aten.permute.default", "aten.t.default")
_CASTS = ("aten.to.dtype", "aten._to_copy.default")
_RESHAPES = ("aten.view.default", "aten.reshape.default", "aten._unsafe_view.default")
#: dtypes that hold every value of the dtypes listed with them
_HOLDS = {torch.float64: (torch.float64, torch.float32, torch.float16, torch.bfloat16),
          torch.float32: (torch.float32, torch.float16, torch.bfloat16),
          torch.float16: (torch.float16,), torch.bfloat16: (torch.bfloat16,)}


def _perm(node: GNode) -> Optional[List[int]]:
    """The permutation a transpose-like node applies (output dim i reads
    input dim p[i])."""
    if node.op not in _PERMUTES:
        return None
    args = node.args
    n = len(args[0].shape)
    if node.op == "aten.t.default":
        return [1, 0] if n == 2 else list(range(n))
    if node.op == "aten.transpose.int":
        p = list(range(n))
        a, b = int(args[1].val) % n, int(args[2].val) % n
        p[a], p[b] = p[b], p[a]
        return p
    return [int(d) % n for d in args[1].val]


def _cast_dtype(node: GNode) -> Optional[torch.dtype]:
    """The target dtype of a pure dtype cast, else None (a cast that also
    moves the device, the layout or the memory format is left alone)."""
    if node.op == "aten.to.dtype":
        args, kw = node.params["args"], node.params["kwargs"]
        extra = list(args[2:]) + list(kw.values())
        return args[1] if all(e in (False, None) for e in extra) else None
    if node.op == "aten._to_copy.default":
        kw = node.params["kwargs"]
        return kw.get("dtype") if set(kw) == {"dtype"} and len(node.params["args"]) == 1 \
            else None
    return None


def _unsafe_rewire(g: Graph, out: GVar, src: GVar) -> bool:
    """Rewiring ``out`` onto ``src`` would hand the caller an input or a
    constant as a graph output, or let a mutating op write ``src``."""
    return (g.is_output(out) and g.producer(src) is None) or mutating_users(g, out)


def _drop_if_dead(g: Graph, node: GNode) -> None:
    if node.nid in g.nodes and not any(g.n_uses(ov) or g.is_output(ov) for ov in node.outvars):
        g.erase_node(node)


def _retarget(g: Graph, node: GNode, op, args, invars: List[GVar]) -> None:
    """Rewrite ``node`` in place into ATen ``op`` over ``invars``."""
    for iv in node.invars:
        s = g.users_of.get(iv.vid)
        if s is not None:
            s.discard(node.nid)
    node.op, node.target = str(op), op
    node.params = {"args": tuple(args), "kwargs": {}}
    node.invars = list(invars)
    for iv in invars:
        g.users_of.setdefault(iv.vid, set()).add(node.nid)


class LayoutOptimizationPass(ForgePass):
    name = "layout_optimization"

    def __init__(self, rewrite: bool = True):
        #: λ='hints' keeps only the tile annotation sub-pass
        self.rewrite = rewrite
        self.last_detail: Dict[str, Any] = {}

    def _cancel_transposes(self, g: Graph) -> int:
        n = 0
        for node in list(g.nodes.values()):
            if node.nid not in g.nodes:
                continue
            p2 = _perm(node)
            inner = M.producer(g, node.args[0]) if p2 is not None else None
            p1 = _perm(inner) if inner is not None else None
            if p1 is None or [p1[i] for i in p2] != list(range(len(p2))):
                continue
            src, out = inner.args[0], node.outvars[0]
            if _unsafe_rewire(g, out, src):
                continue
            g.replace_all_uses(out, src)
            g.erase_node(node)
            _drop_if_dead(g, inner)
            n += 1
        return n

    def _collapse_casts(self, g: Graph) -> int:
        n = 0
        for node in list(g.nodes.values()):
            if node.nid not in g.nodes or node.op not in _CASTS:
                continue
            dst = _cast_dtype(node)
            src, out = node.args[0], node.outvars[0]
            if dst is None:
                continue
            if src.dtype == out.dtype:  # a cast to the dtype it has
                if not _unsafe_rewire(g, out, src):
                    g.replace_all_uses(out, src)
                    g.erase_node(node)
                    n += 1
                continue
            inner = M.producer(g, src)
            if inner is None or inner.op not in _CASTS or _cast_dtype(inner) is None \
                    or g.n_uses(src) != 1 or g.is_output(src):
                continue
            x = inner.args[0]
            mid = src.dtype
            if not (x.dtype in _HOLDS.get(mid, ()) and dst.is_floating_point
                    and mid.itemsize >= dst.itemsize):
                continue
            if x.dtype == out.dtype:  # a round trip through a wider dtype
                if _unsafe_rewire(g, out, x):
                    continue
                g.replace_all_uses(out, x)
                g.erase_node(node)
            else:  # the cast reads x itself
                kwargs = dict(node.params["kwargs"])
                _retarget(g, node, node.target, (Ref(0),) + tuple(node.params["args"][1:]), [x])
                node.params["kwargs"] = kwargs
            _drop_if_dead(g, inner)
            n += 1
        return n

    def _collapse_reshapes(self, g: Graph) -> int:
        n = 0
        for node in list(g.nodes.values()):
            if node.nid not in g.nodes or node.op not in _RESHAPES:
                continue
            inner = M.producer(g, node.args[0])
            if inner is None or inner.op not in _RESHAPES:
                continue
            mid, out = inner.outvars[0], node.outvars[0]
            if g.n_uses(mid) != 1 or g.is_output(mid):
                continue
            src = inner.args[0]
            if src.shape == out.shape:
                if _unsafe_rewire(g, out, src):
                    continue
                g.replace_all_uses(out, src)
                g.erase_node(node)
            else:
                _retarget(g, node, torch.ops.aten.reshape.default,
                          (Ref(0), list(out.shape)), [src])
            _drop_if_dead(g, inner)
            n += 1
        return n

    def _absorb_dot_transpose(self, g: Graph) -> int:
        """matmul(x, t(w)) with a rank-2 w -> linear(x, w)."""
        n = 0
        for node in list(g.nodes.values()):
            if node.nid not in g.nodes or node.op != "aten.matmul.default":
                continue
            x, rhs = node.args[:2]
            tp = M.producer(g, rhs)
            if tp is None or len(x.shape) < 2 or _perm(tp) != [1, 0]:
                continue
            w = tp.args[0]
            if len(w.shape) != 2:
                continue
            _retarget(g, node, torch.ops.aten.linear.default, (Ref(0), Ref(1)), [x, w])
            _drop_if_dead(g, tp)
            n += 1
        return n

    def _annotate_tiles(self, g: Graph) -> int:
        n = 0
        for node in g.nodes.values():
            hint = HOPPER_PREFERRED_TILES.get(node.op)
            if hint is not None and "block_hint" not in node.meta:
                node.meta["block_hint"] = hint
                n += 1
        return n

    def run(self, g: Graph) -> bool:
        t = c = r = a = 0
        if self.rewrite:
            t = self._cancel_transposes(g)
            c = self._collapse_casts(g)
            r = self._collapse_reshapes(g)
            a = self._absorb_dot_transpose(g)
        h = self._annotate_tiles(g)
        self.last_detail = {
            "transposes_cancelled": t,
            "converts_collapsed": c,
            "reshapes_collapsed": r,
            "dot_transposes_absorbed": a,
            "tiles_annotated": h,
        }
        return (t + c + r + a) > 0
