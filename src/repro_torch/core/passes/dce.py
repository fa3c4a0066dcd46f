"""Pass 1 — dead code elimination (paper §4.3.1, Listing 3).

Backward reachability walk from the graph outputs; every node not reached
is erased.  Removes capture artifacts (iota/mask subgraphs orphaned by the
fusion passes, dead shape arithmetic, side-effect-only export nodes).
"""
from __future__ import annotations

from typing import Set

from ..graph import Graph
from .base import ForgePass


class DCEPass(ForgePass):
    name = "dce"

    def run(self, g: Graph) -> bool:
        live_vids: Set[int] = set()
        stack = list(g.outvars)
        live_nodes: Set[int] = set()
        while stack:
            v = stack.pop()
            if v.vid in live_vids:
                continue
            live_vids.add(v.vid)
            pr = g.producer_of.get(v.vid)
            if pr is None:
                continue
            nid = pr[0]
            if nid in live_nodes:
                continue
            live_nodes.add(nid)
            node = g.nodes.get(nid)
            if node is None:
                continue
            stack.extend(node.invars)

        dead = [n for nid, n in g.nodes.items() if nid not in live_nodes]
        # erase in reverse topological order so use counts drain cleanly
        for node in reversed(dead):
            g.erase_node(node)
        self.last_detail = {"erased": len(dead)}
        return bool(dead)
