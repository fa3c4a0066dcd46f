"""Shared pattern-matching helpers for the fusion passes.

The ATen-level equivalents of the paper's FX matching helpers
(``_is_scale``, ``_is_softmax``, ``_unwrap_transpose`` …): the chains
below are what the port's unfused model code exports to under
``torch.export`` (default IR): ``aten.matmul`` products,
``aten.transpose.int`` for Kᵀ, ``aten.to.dtype`` casts,
``aten.where``-based masks over ``aten.arange`` iotas.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Set, Tuple

import torch

from ..graph import Graph, GLit, GNode, GVar, Operand

#: value-preserving casts / copies the matchers look through
CONVERT_OPS = (
    "aten.to.dtype",
    "aten._to_copy.default",
    "aten.to.dtype_layout",
    "aten.clone.default",
    "aten.alias.default",
)
MATMUL_OPS = ("aten.matmul.default",)
VIEW_OPS = ("aten.view.default", "aten.reshape.default", "aten.unsqueeze.default",
            "aten._unsafe_view.default")
ARANGE_OPS = ("aten.arange.default", "aten.arange.start", "aten.arange.start_step")


def scalar_lit(x: Operand) -> Optional[float]:
    """Return the value of a scalar literal operand, else None."""
    if not isinstance(x, GLit) or isinstance(x.val, bool):
        return None
    if isinstance(x.val, (int, float)):
        return float(x.val)
    return None


def const_value(g: Graph, x: Operand):
    """The tensor of a graph constant operand, else None."""
    if not isinstance(x, GVar):
        return None
    for cv, cval in zip(g.constvars, g.consts):
        if cv.vid == x.vid:
            return cval
    return None


def producer(g: Graph, x: Operand) -> Optional[GNode]:
    return g.producer(x) if isinstance(x, GVar) else None


def same(a: Operand, b: Operand) -> bool:
    return isinstance(a, GVar) and isinstance(b, GVar) and a.vid == b.vid


def skip_converts(g: Graph, x: Operand, collect: Optional[List[GNode]] = None) -> Operand:
    """Walk backward through dtype casts and copies."""
    while True:
        p = producer(g, x)
        if p is None or p.op not in CONVERT_OPS:
            return x
        if collect is not None:
            collect.append(p)
        x = p.args[0]


def skip_private_converts(g: Graph, x: Operand, collect: List[GNode]) -> Operand:
    """:func:`skip_converts` through casts whose output has exactly one
    use — casts that a fusion can absorb without touching other users."""
    while True:
        p = producer(g, x)
        if p is None or p.op not in CONVERT_OPS or g.n_uses(x) != 1 or g.is_output(x):
            return x
        collect.append(p)
        x = p.args[0]


def uses_confined(g: Graph, nodes: Iterable[GNode], nids: Set[int]) -> bool:
    """True iff every output of every node is only consumed inside ``nids``
    and is not a graph output — the erasure-safety condition for fusion."""
    for node in nodes:
        for ov in node.outvars:
            if g.is_output(ov):
                return False
            for u in g.users(ov):
                if u.nid not in nids:
                    return False
    return True


def erase_set(g: Graph, nodes: Sequence[GNode]) -> int:
    """Erase a matched node set in reverse topological (insertion) order,
    skipping nodes that still have external uses (shared mask producers)."""
    order = {nid: i for i, nid in enumerate(g.nodes.keys())}
    erased = 0
    for node in sorted(nodes, key=lambda n: order.get(n.nid, -1), reverse=True):
        if node.nid not in g.nodes:
            continue
        if any(g.n_uses(ov) for ov in node.outvars):
            continue  # shared producer — leave for DCE
        g.erase_node(node)
        erased += 1
    return erased


# --------------------------------------------------------------------------
# matmul shape classification
# --------------------------------------------------------------------------


def _last_two(node: GNode) -> bool:
    """``aten.transpose.int(x, a, b)`` swapping the last two axes."""
    if node.op != "aten.transpose.int":
        return False
    x, a, b = node.args[:3]
    nd = len(x.shape)
    dims = {int(a.val) % nd, int(b.val) % nd}
    return dims == {nd - 2, nd - 1}


def match_qk(g: Graph, node: GNode) -> Optional[Tuple[Operand, Operand, List[GNode]]]:
    """Q·Kᵀ: ``matmul(q, transpose(k, -2, -1))`` on rank-4 (B, H, S, D)
    operands, casts allowed on either side.  Returns (q, k, chain)."""
    if node.op not in MATMUL_OPS:
        return None
    lhs, rhs = node.args[:2]
    if len(lhs.shape) != 4 or len(rhs.shape) != 4:
        return None
    chain: List[GNode] = []
    t = producer(g, rhs)
    if t is None or not _last_two(t):
        return None
    chain.append(t)
    k = skip_private_converts(g, t.args[0], chain)
    q = skip_private_converts(g, lhs, chain)
    return q, k, chain


def is_pv(node: GNode) -> bool:
    """P·V: rank-4 matmul (B, H, Sq, Sk) @ (B, H, Sk, D)."""
    if node.op not in MATMUL_OPS:
        return False
    lhs, rhs = node.args[:2]
    return len(lhs.shape) == 4 and len(rhs.shape) == 4 and lhs.shape[-1] == rhs.shape[-2]


def is_plain_linear(node: GNode) -> bool:
    """x·W with x: (..., K), W: (K, N) — the canonical projection form."""
    if node.op not in MATMUL_OPS:
        return False
    lhs, rhs = node.args[:2]
    return len(rhs.shape) == 2 and len(lhs.shape) >= 2


# --------------------------------------------------------------------------
# GQA broadcast-expansion unwrapping (the K-transpose-unwrap analogue)
# --------------------------------------------------------------------------


def unwrap_kv_expand(g: Graph, x: Operand) -> Tuple[Operand, int, List[GNode]]:
    """Detect ``(B,KVH,S,D) -unsqueeze-> (B,KVH,1,S,D) -expand->
    (B,KVH,g,S,D) -reshape-> (B,KVH*g,S,D)``.

    Returns (original operand, group count, chain nodes).  The fused SDPA
    kernel indexes KV heads as ``h // groups`` instead of materializing
    the expansion (paper Listing 5's ``_unwrap_transpose`` adapted to GQA).
    """
    r = producer(g, x)
    if r is None or r.op not in ("aten.reshape.default", "aten.view.default",
                                 "aten._unsafe_view.default"):
        return x, 1, []
    chain: List[GNode] = [r]
    cur = r.args[0]
    e = producer(g, cur)
    if e is not None and e.op == "aten.clone.default":  # reshape of an expand may copy
        chain.append(e)
        cur = e.args[0]
        e = producer(g, cur)
    if e is None or e.op != "aten.expand.default":
        return x, 1, []
    chain.append(e)
    u = producer(g, e.args[0])
    if u is None or u.op != "aten.unsqueeze.default":
        return x, 1, []
    chain.append(u)
    src = u.args[0]
    if not isinstance(src, GVar) or len(src.shape) != 4 or len(x.shape) != 4:
        return x, 1, []
    B, KVH, S, D = src.shape
    mid = tuple(cur.shape)
    if KVH == 0 or x.shape[1] % KVH:
        return x, 1, []
    groups = x.shape[1] // KVH
    if groups <= 1 or mid != (B, KVH, groups, S, D) or tuple(x.shape) != (B, KVH * groups, S, D):
        return x, 1, []
    return src, groups, chain


# --------------------------------------------------------------------------
# Causal-mask recognition
# --------------------------------------------------------------------------


def _iota(g: Graph, x: Operand) -> Optional[Tuple[int, int, List[GNode]]]:
    """``arange(n)`` viewed as a (n, 1) row or (1, n) column index.

    Returns (dim, n, chain) with dim 0 for rows and 1 for columns."""
    chain: List[GNode] = []
    p = producer(g, x)
    while p is not None and p.op in VIEW_OPS:
        chain.append(p)
        p = producer(g, p.args[0])
    if p is None or p.op not in ARANGE_OPS:
        return None
    args = [a.val for a in p.args]
    if p.op == "aten.arange.default":
        start, end, step = 0, args[0], 1
    elif p.op == "aten.arange.start":
        start, end, step = args[0], args[1], 1
    else:
        start, end, step = args[0], args[1], args[2]
    if start != 0 or step != 1:
        return None
    chain.append(p)
    shape = tuple(s for s in x.shape)
    while len(shape) > 2 and shape[0] == 1:
        shape = shape[1:]
    if shape == (end, 1) and end != 1:
        return 0, end, chain
    if shape == (1, end):
        return 1, end, chain
    if shape == (1, 1) and end == 1:  # a one-row query range
        return 0, end, chain
    return None


def is_causal_pred(g: Graph, pred: Operand, sq: int, sk: int) -> Optional[List[GNode]]:
    """Recognize ``row (+ off) >= col`` causal predicates with
    ``off == sk - sq``; returns the producer chain, or None.  Masks that
    do not match stay as explicit fused-node operands.

    A predicate that constant folding evaluated is a boolean graph
    constant: it is causal when every (sq, sk) slice of it is the
    ``row + (sk - sq) >= col`` pattern (the chain is then empty)."""
    p = producer(g, pred)
    if p is None:
        c = const_value(g, pred)
        if c is None or c.dtype != torch.bool or c.dim() < 2 or tuple(c.shape[-2:]) != (sq, sk):
            return None
        row = torch.arange(sq, device=c.device).view(sq, 1) + (sk - sq)
        tril = row >= torch.arange(sk, device=c.device).view(1, sk)
        return [] if bool((c.reshape(-1, sq, sk) == tril).all()) else None
    if p.op != "aten.ge.Tensor":
        return None
    chain: List[GNode] = [p]
    lhs, rhs = p.args[:2]
    col = _iota(g, rhs)
    if col is None or col[0] != 1 or col[1] != sk:
        return None
    chain.extend(col[2])
    off = 0
    pa = producer(g, lhs)
    if pa is not None and pa.op == "aten.add.Tensor":
        a, b = pa.args[:2]
        if scalar_lit(b) is None:
            a, b = b, a
        lv = scalar_lit(b)
        if lv is None or pa.kwarg("alpha", 1) != 1:
            return None
        off = int(lv)
        chain.append(pa)
        lhs = a
    row = _iota(g, lhs)
    if row is None or row[0] != 0 or row[1] != sq:
        return None
    chain.extend(row[2])
    if off != sk - sq:
        return None  # not the standard causal alignment
    return chain


def is_neg_inf(x: Operand) -> bool:
    """A literal operand at or below -1e30 (the masked-score floor)."""
    v = scalar_lit(x)
    return v is not None and v <= -1e30
