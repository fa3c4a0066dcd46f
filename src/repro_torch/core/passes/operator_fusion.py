"""Pass 5 — operator fusion (paper §4.3.5, Listing 6).

Targets the complementary pattern set: a linear projection immediately
followed by a point-wise epilogue.  In the exported graph each linear,
bias-add and activation is a separate ATen op — a separate kernel
boundary materializing the (tokens, d_ff) intermediate in device memory.
Matched chains become single ``forge.linear_act`` nodes dispatching the
fused matmul + bias + activation kernel (the activation is applied to
the fp32 accumulator before the one store).

Fusion patterns (paper: linear+relu / linear+gelu / linear+silu / mm+add),
tried in this order:

* ``mul(silu(x·Wg), x·Wu)`` with a shared ``x`` → ``forge.swiglu`` (the
  beyond-paper SwiGLU mega-fusion; ``enable_swiglu``)
* ``linear [+bias] + {relu, silu, gelu-tanh, gelu-exact, tanh}``
* ``linear [+bias] + residual-add``  (the paper's mm+add)

The ATen export keeps every activation as one node (``aten.gelu`` with
``approximate='tanh'`` is ``gelu``, without it ``gelu_exact``; silu is
``aten.silu`` or ``h * sigmoid(h)``), so the recognizers are single-node
matches rather than the JAX package's primitive-chain walks.  ``alpha``
fuses the first ⌈α·n⌉ of the n matches (the autotuner's α).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Set, Tuple

from ..graph import Graph, GNode, GVar, Operand
from .attention_fusion import dtype_name
from .base import ForgePass
from . import _match as M


class OperatorFusionPass(ForgePass):
    name = "operator_fusion"

    def __init__(self, alpha: float = 1.0, impl: Optional[str] = None,
                 enable_swiglu: bool = True):
        #: fusion aggressiveness α: the first ⌈α·n⌉ of n matches fuse
        self.alpha = alpha
        self.impl = impl
        self.enable_swiglu = enable_swiglu
        self.last_detail: Dict[str, Any] = {}

    # -- activation recognizers (anchored at the activation node) ----------

    def _match_activation(self, g: Graph, node: GNode) -> Optional[Tuple[str, Operand, List[GNode]]]:
        op = node.op
        if op == "aten.relu.default":
            return "relu", node.args[0], [node]
        if op == "aten.silu.default":
            return "silu", node.args[0], [node]
        if op == "aten.tanh.default":
            return "tanh", node.args[0], [node]
        if op == "aten.gelu.default":
            args = node.args
            approx = node.kwarg("approximate", args[1].val if len(args) > 1 else "none")
            return ("gelu" if approx == "tanh" else "gelu_exact"), args[0], [node]
        if op == "aten.mul.Tensor":  # silu written out: h * sigmoid(h)
            a, b = node.args[:2]
            for h, s in ((a, b), (b, a)):
                sp = M.producer(g, s)
                if sp is not None and sp.op == "aten.sigmoid.default" \
                        and M.same(sp.args[0], h):
                    return "silu", h, [sp, node]
        return None

    # -- linear producer (looks through casts) -------------------------------

    def _linear_producer(self, g: Graph, h: Operand):
        converts: List[GNode] = []
        base = M.skip_converts(g, h, converts)
        dp = M.producer(g, base)
        if dp is not None and M.is_plain_linear(dp):
            return dp, converts
        return None

    def _match_bias_add(self, g: Graph, h: Operand):
        """h == add(dot_out, b[N])?  Returns (dot_out, b, chain, dot)."""
        p = M.producer(g, h)
        if p is None or p.op != "aten.add.Tensor" or p.kwarg("alpha", 1) != 1:
            return None
        a, b = p.args[:2]
        for dot_side, bias_side in ((a, b), (b, a)):
            lp = self._linear_producer(g, dot_side)
            if lp is None or not isinstance(bias_side, GVar):
                continue
            dp, converts = lp
            if bias_side.shape == (dot_side.shape[-1],) and bias_side.dtype == dot_side.dtype:
                return dot_side, bias_side, [p] + converts, dp
        return None

    # -- pattern: swiglu -------------------------------------------------------

    def _match_swiglu(self, g: Graph, node: GNode) -> Optional[Dict[str, Any]]:
        """mul(silu(x·Wg), x·Wu) with a shared x (no biases)."""
        if node.op != "aten.mul.Tensor" or len(node.invars) != 2:
            return None
        a, b = node.args[:2]
        for gate_v, up_v in ((a, b), (b, a)):
            gp = M.producer(g, gate_v)
            silu_m = self._match_activation(g, gp) if gp is not None else None
            if silu_m is None or silu_m[0] != "silu":
                continue
            _, h, silu_chain = silu_m
            lp_g = self._linear_producer(g, h)
            lp_u = self._linear_producer(g, up_v)
            if lp_g is None or lp_u is None:
                continue
            (gate_dot, conv_g), (up_dot, conv_u) = lp_g, lp_u
            xg, wg = gate_dot.args[:2]
            xu, wu = up_dot.args[:2]
            if gate_dot.nid == up_dot.nid or not M.same(xg, xu):
                continue
            return {"kind": "swiglu", "anchor": node, "x": xg, "wg": wg, "wu": wu,
                    "chain": [gate_dot, up_dot] + conv_g + conv_u + list(silu_chain) + [node]}
        return None

    # -- pattern: linear (+bias) (+act | +residual) --------------------------

    def _match_linear_act(self, g: Graph, node: GNode) -> Optional[Dict[str, Any]]:
        act_m = self._match_activation(g, node)
        if act_m is None:
            return None
        act, h, chain = act_m
        chain = list(chain)
        bias = None
        bm = self._match_bias_add(g, h)
        if bm is not None:
            _, bias, bias_chain, dot = bm
            chain.extend(bias_chain)
        else:
            lp = self._linear_producer(g, h)
            if lp is None:
                return None
            dot, converts = lp
            chain.extend(converts)
        chain.append(dot)
        x, w = dot.args[:2]
        return {"kind": "linear_act", "anchor": node, "x": x, "w": w, "b": bias, "act": act,
                "residual": None, "chain": chain}

    def _match_mm_add(self, g: Graph, node: GNode) -> Optional[Dict[str, Any]]:
        """add(dot(x,W) [+bias], residual) — residual same-shape (paper mm+add)."""
        if node.op != "aten.add.Tensor" or node.kwarg("alpha", 1) != 1:
            return None
        out = node.outvars[0]
        a, b = node.args[:2]
        for dot_side, res_side in ((a, b), (b, a)):
            if not isinstance(res_side, GVar) or res_side.shape != out.shape \
                    or res_side.dtype != out.dtype:
                continue
            chain: List[GNode] = [node]
            bias = None
            bm = self._match_bias_add(g, dot_side)
            if bm is not None:
                _, bias, bias_chain, dot = bm
                chain.extend(bias_chain)
            else:
                lp = self._linear_producer(g, dot_side)
                if lp is None:
                    continue
                dot, converts = lp
                chain.extend(converts)
            chain.append(dot)
            rp = M.producer(g, res_side)
            if rp is not None and rp.nid == dot.nid:
                continue  # residual must not itself be the dot output
            return {"kind": "linear_act", "anchor": node, "x": dot.args[0], "w": dot.args[1],
                    "b": bias, "act": None, "residual": res_side, "chain": chain}
        return None

    # -- rewrite ---------------------------------------------------------------

    def _fuse(self, g: Graph, m: Dict[str, Any]) -> None:
        anchor: GNode = m["anchor"]
        out = anchor.outvars[0]
        if m["kind"] == "swiglu":
            op, invars = "forge.swiglu", [m["x"], m["wg"], m["wu"]]
            params: Dict[str, Any] = {"impl": self.impl, "out_dtype": dtype_name(out.dtype)}
        else:
            op, invars = "forge.linear_act", [m["x"], m["w"]]
            if m["b"] is not None:
                invars.append(m["b"])
            if m["residual"] is not None:
                invars.append(m["residual"])
            params = {
                "act": m["act"],
                "has_bias": m["b"] is not None,
                "has_residual": m["residual"] is not None,
                "out_dtype": dtype_name(out.dtype),
                "impl": self.impl,
            }
        fused = g.insert_node_like(anchor, op, params, invars, [out.aval],
                                   meta={"fused_from": len(m["chain"])})
        g.replace_all_uses(out, fused.outvars[0])
        M.erase_set(g, m["chain"])

    def _scan(self, g: Graph, limit: Optional[int], fuse: bool) -> List[Dict[str, Any]]:
        """One scan per matcher, at most ``limit`` matches; with ``fuse``
        each match fuses at once so later matches see post-rewrite
        operands (stale-reference safety)."""
        out: List[Dict[str, Any]] = []
        claimed: Set[int] = set()
        matchers = [self._match_swiglu] if self.enable_swiglu else []
        matchers += [self._match_linear_act, self._match_mm_add]
        for matcher in matchers:
            for node in list(g.nodes.values()):
                if limit is not None and len(out) >= limit:
                    return out
                if node.nid in claimed or node.nid not in g.nodes:
                    continue
                m = matcher(g, node)
                if m is None:
                    continue
                nids = {n.nid for n in m["chain"]}
                if nids & claimed:
                    continue
                interior = [n for n in m["chain"] if n.nid != m["anchor"].nid]
                if not M.uses_confined(g, interior, nids):
                    continue
                claimed.update(nids)
                out.append(m)
                if fuse:
                    self._fuse(g, m)
        return out

    def run(self, g: Graph) -> bool:
        n_matched = len(self._scan(g, None, fuse=False))
        n_fuse = math.ceil(self.alpha * n_matched) if n_matched else 0
        fused = self._scan(g, n_fuse, fuse=True) if n_fuse else []
        self.last_detail = {
            "matched": n_matched,
            "fused": len(fused),
            "swiglu": sum(1 for m in fused if m["kind"] == "swiglu"),
            "residual": sum(1 for m in fused if m.get("residual") is not None),
        }
        return bool(fused)
