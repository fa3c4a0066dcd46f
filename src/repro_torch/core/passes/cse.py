"""Pass 2 — common subexpression elimination (paper §4.3.2, Listing 4).

Hash-consing over ``(op, canonical-params, operand-keys)`` triples: two
nodes computing the same ATen op with the same frozen arguments on the
same producers collapse onto the first occurrence (``replace_all_uses``
+ erase), the paper's ``_fx_node_key`` scheme with FX node names
replaced by SSA vids.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from ..graph import Graph, Ref
from .base import ForgePass


def _canon(x: Any) -> Any:
    """Canonicalize a params value / literal into a hashable key."""
    if isinstance(x, (bool, int, float, str, bytes, type(None))):
        return (type(x).__name__, x)
    if isinstance(x, Ref):
        return ("ref", x.i)
    if isinstance(x, (tuple, list)):
        return tuple(_canon(e) for e in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _canon(v)) for k, v in x.items()))
    try:
        hash(x)
        return x
    except TypeError:
        return repr(x)


def node_key(node) -> Tuple:
    return (node.op, _canon(node.params), tuple(iv.vid for iv in node.invars))


class CSEPass(ForgePass):
    name = "cse"

    def run(self, g: Graph) -> bool:
        canonical: Dict[Tuple, Any] = {}
        erased = 0
        for node in list(g.nodes.values()):
            if node.meta.get("no_cse") or not node.outvars:
                continue
            key = node_key(node)
            first = canonical.get(key)
            if first is None or first.nid not in g.nodes:
                canonical[key] = node
                continue
            # redirect all uses of every output onto the first occurrence
            for ov, cv in zip(node.outvars, first.outvars):
                g.replace_all_uses(ov, cv)
            g.erase_node(node)
            erased += 1
        self.last_detail = {"merged": erased}
        return erased > 0
