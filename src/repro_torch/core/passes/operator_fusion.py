"""Pass 5 — operator fusion (paper §4.3.5, Listing 6).

Targets the complementary pattern set: a linear projection immediately
followed by a point-wise epilogue.  In the exported graph each linear,
bias-add and activation is a separate ATen op — a separate kernel
boundary materializing the (tokens, d_ff) intermediate in device memory.
Matched chains become single ``forge.linear_act`` nodes dispatching the
fused matmul + bias + activation kernel (the activation is applied to
the fp32 accumulator before the one store).

Fusion patterns (paper: linear+relu / linear+gelu / linear+silu / mm+add):

* ``linear [+bias] + {relu, silu, gelu-tanh, gelu-exact, tanh}``
* ``linear [+bias] + residual-add``  (the paper's mm+add)

The ATen export keeps every activation as one node (``aten.gelu`` with
``approximate='tanh'`` is ``gelu``, without it ``gelu_exact``), so the
recognizers are single-node matches rather than the JAX package's
primitive-chain walks.  The SwiGLU mega-fusion comes with the SwiGLU
configs in a later slice.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Set, Tuple

from ..graph import Graph, GNode, GVar, Operand
from .attention_fusion import dtype_name
from .base import ForgePass
from . import _match as M


class OperatorFusionPass(ForgePass):
    name = "operator_fusion"

    def __init__(self, impl: Optional[str] = None):
        self.impl = impl
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
        return {"anchor": node, "x": x, "w": w, "b": bias, "act": act,
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
            return {"anchor": node, "x": dot.args[0], "w": dot.args[1], "b": bias,
                    "act": None, "residual": res_side, "chain": chain}
        return None

    # -- rewrite ---------------------------------------------------------------

    def _fuse(self, g: Graph, m: Dict[str, Any]) -> None:
        anchor: GNode = m["anchor"]
        out = anchor.outvars[0]
        invars: List[GVar] = [m["x"], m["w"]]
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
        fused = g.insert_node_like(
            anchor, "forge.linear_act", params, invars, [out.aval],
            meta={"fused_from": len(m["chain"])},
        )
        g.replace_all_uses(out, fused.outvars[0])
        M.erase_set(g, m["chain"])

    def _scan(self, g: Graph) -> List[Dict[str, Any]]:
        """One scan per matcher; fuses each match at once so later matches
        see post-rewrite operands (stale-reference safety)."""
        out: List[Dict[str, Any]] = []
        claimed: Set[int] = set()
        for matcher in (self._match_linear_act, self._match_mm_add):
            for node in list(g.nodes.values()):
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
                self._fuse(g, m)
        return out

    def run(self, g: Graph) -> bool:
        fused = self._scan(g)
        self.last_detail = {
            "fused": len(fused),
            "residual": sum(1 for m in fused if m["residual"] is not None),
        }
        return bool(fused)
