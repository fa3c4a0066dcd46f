"""Pass 4 — attention fusion (paper §4.3.4, Listing 5).

The most impactful single optimization.  Unfused attention, as exported
by ``torch.export``, is a chain of discrete ATen ops:

    [to(q)] [to(k) → transpose] → matmul(Q,Kᵀ) → [mul/div scale]
      → [mask: where(pred, s, -inf) | add(s, mask)] → softmax
      → [to(v.dtype)] → matmul(·, V)

Each arrow is a kernel boundary with the (Sq, Sk) score matrix in device
memory between them.  This pass matches the chain (anchored at the
softmax) and replaces it with one ``forge.sdpa`` node, which Phase 3
routes to the accel device and which dispatches the flash-attention
kernel on the card (scores never leave registers).

Adaptations of the paper's matcher, kept from the JAX package:

* **GQA expansion unwrapping**: grouped-query K/V arrive through an
  ``unsqueeze → expand → reshape`` chain, which is unwrapped so the
  kernel indexes KV heads as ``h // groups`` without materializing copies.
* **causal-mask recognition**: ``where(row + (Sk-Sq) >= col, s, -inf)``
  whose predicate is a pure ``arange`` subgraph becomes the kernel's
  ``causal=True`` mode (the predicate producers are dropped); other
  masks remain explicit fused-node operands (``bool`` or ``add``).
* the erasure-safety condition generalizes the paper's "exactly one user"
  walk: every value-path node must be consumed only inside the match.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Set

from ..graph import Graph, GNode, GVar, Operand
from .base import ForgePass
from . import _match as M

SOFTMAX_OPS = ("aten.softmax.int", "aten._softmax.default", "aten._safe_softmax.default")
_SCORE_OPS = M.MATMUL_OPS + ("aten.mul.Tensor", "aten.div.Tensor") + M.CONVERT_OPS


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


class AttentionFusionPass(ForgePass):
    name = "attention_fusion"

    def __init__(self, alpha: float = 1.0, impl: Optional[str] = None):
        #: fusion aggressiveness α: the first ⌈α·n⌉ of n matches fuse
        self.alpha = alpha
        self.impl = impl
        self.last_detail: Dict[str, Any] = {}

    def _match_chain(self, g: Graph, sm: GNode) -> Optional[Dict[str, Any]]:
        x, dim = sm.args[0], sm.args[1]
        nd = len(x.shape)
        if nd != 4 or int(dim.val) % nd != nd - 1:
            return None
        sq, sk = x.shape[-2], x.shape[-1]
        value_path: List[GNode] = [sm]
        aux_path: List[GNode] = []  # shared-ok producers (causal iotas)

        # ---- backward from the softmax input ----------------------------
        cur: Operand = x
        mask_operand: Optional[GVar] = None
        mask_mode = "none"
        causal = False

        p = M.producer(g, cur)
        if p is not None and p.op == "aten.where.ScalarOther" and M.is_neg_inf(p.args[2]):
            pred, s_true = p.args[0], p.args[1]
            value_path.append(p)
            chain = M.is_causal_pred(g, pred, sq, sk)
            if chain is not None:
                causal = True
                aux_path.extend(chain)
            else:
                mask_operand, mask_mode = pred, "bool"
            cur = s_true
            p = M.producer(g, cur)
        elif p is not None and p.op == "aten.add.Tensor" and p.kwarg("alpha", 1) == 1:
            a, b = p.args[:2]
            for s_, m_ in ((a, b), (b, a)):
                sp = M.producer(g, s_)
                if sp is not None and sp.op in _SCORE_OPS and isinstance(m_, GVar):
                    value_path.append(p)
                    mask_operand, mask_mode = m_, "add"
                    cur = s_
                    break
            p = M.producer(g, cur)

        # optional scale
        scale, scale_mode = 1.0, "mul"
        if p is not None and p.op in ("aten.mul.Tensor", "aten.div.Tensor"):
            a, b = p.args[:2]
            lv, other = M.scalar_lit(b), a
            if lv is None and p.op == "aten.mul.Tensor":
                lv, other = M.scalar_lit(a), b
            if lv is not None and isinstance(other, GVar):
                scale = float(lv)
                scale_mode = "div" if p.op == "aten.div.Tensor" else "mul"
                value_path.append(p)
                cur = other

        # optional casts between the QK product and the scale
        converts: List[GNode] = []
        cur = M.skip_converts(g, cur, converts)
        value_path.extend(converts)
        p = M.producer(g, cur)
        qk_m = M.match_qk(g, p) if p is not None else None
        if qk_m is None:
            return None
        q_op, k_op, qk_chain = qk_m
        qk = p
        value_path.append(qk)
        value_path.extend(qk_chain)

        # ---- forward from the softmax output ----------------------------
        pv = None
        seek = sm.outvars[0]
        fwd: List[GNode] = []
        for _ in range(3):
            users = g.users(seek)
            if len(users) != 1 or g.is_output(seek) or g.n_uses(seek) != 1:
                break
            u = users[0]
            if u.op in M.CONVERT_OPS:
                fwd.append(u)
                seek = u.outvars[0]
                continue
            if M.is_pv(u) and M.same(u.args[0], seek):
                pv = u
            break
        if pv is None:
            return None
        value_path.extend(fwd)
        value_path.append(pv)
        v_chain: List[GNode] = []
        v_op = M.skip_private_converts(g, pv.args[1], v_chain)
        value_path.extend(v_chain)

        # ---- GQA operands -------------------------------------------------
        k0, gk, k_exp = M.unwrap_kv_expand(g, k_op)
        v0, gv, v_exp = M.unwrap_kv_expand(g, v_op)
        groups = 1
        if gk == gv and gk > 1:
            groups = gk
            value_path.extend(k_exp)
            value_path.extend(v_exp)
            k_op, v_op = k0, v0
        elif q_op.shape[1] != k_op.shape[1]:
            return None

        nids: Set[int] = {n.nid for n in value_path} | {n.nid for n in aux_path}
        interior = [n for n in value_path if n.nid != pv.nid]
        if not M.uses_confined(g, interior, nids):
            return None
        return {
            "pv": pv,
            "value_path": value_path,
            "aux_path": aux_path,
            "q": q_op,
            "k": k_op,
            "v": v_op,
            "mask": mask_operand,
            "mask_mode": mask_mode,
            "causal": causal,
            "scale": scale,
            "scale_mode": scale_mode,
            "groups": groups,
        }

    def _fuse(self, g: Graph, m: Dict[str, Any]) -> None:
        pv: GNode = m["pv"]
        out = pv.outvars[0]
        invars: List[GVar] = [m["q"], m["k"], m["v"]]
        has_mask = m["mask"] is not None
        if has_mask:
            invars.append(m["mask"])
        params = {
            "scale": m["scale"],
            "scale_mode": m["scale_mode"],
            "causal": m["causal"],
            "groups": m["groups"],
            "has_mask": has_mask,
            "mask_mode": m["mask_mode"],
            "out_dtype": dtype_name(out.dtype),
            "impl": self.impl,
        }
        fused = g.insert_node_like(
            pv, "forge.sdpa", params, invars, [out.aval],
            meta={"fused_from": len(m["value_path"])},
        )
        g.replace_all_uses(out, fused.outvars[0])
        M.erase_set(g, m["value_path"] + m["aux_path"])

    def _scan(self, g: Graph, limit: Optional[int], fuse: bool) -> List[Dict[str, Any]]:
        """One scan over the graph, at most ``limit`` matches; with
        ``fuse`` each match fuses at once so later matches see
        post-rewrite operands (stale-reference safety)."""
        out: List[Dict[str, Any]] = []
        claimed: Set[int] = set()
        for node in list(g.nodes.values()):
            if limit is not None and len(out) >= limit:
                break
            if node.nid not in g.nodes or node.op not in SOFTMAX_OPS or node.nid in claimed:
                continue
            m = self._match_chain(g, node)
            if m is None:
                continue
            nids = {n.nid for n in m["value_path"]}
            if nids & claimed:
                continue
            claimed |= nids
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
            "causal": sum(1 for m in fused if m["causal"]),
            "gqa": sum(1 for m in fused if m["groups"] > 1),
        }
        return bool(fused)
