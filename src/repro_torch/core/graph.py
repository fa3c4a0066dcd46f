"""RGraph — the mutable register-graph IR at the heart of Forge-UGC.

The port's counterpart of the paper's FX ``GraphModule`` view: a flat,
topologically ordered list of ATen operations over explicit SSA values.
It is built from a ``torch.export`` program (Phase 1,
:mod:`repro_torch.core.capture`), mutated in place by the optimization
passes (Phase 2, :mod:`repro_torch.core.passes`), and lowered to the
typed register IR (Phase 3, :mod:`repro_torch.core.lowering`).

Design notes
------------
* ``GVar`` is an SSA value with a shape and a torch dtype.  ``GLit`` is
  a literal operand frozen at capture time (the paper's "frozen args").
* ``GNode`` is one operation.  For an ATen node, ``invars`` lists its
  tensor operands in order and ``params["args"]`` / ``params["kwargs"]``
  hold the call's argument template, in which :class:`Ref` ``(i)``
  stands for ``invars[i]`` and everything else is a frozen literal.
  A fused ``forge.*`` node has plain operands and fusion ``params``.
* The graph keeps use-def chains (``producer_of`` / ``users_of``) so
  the passes rewire in O(1), as FX's ``replace_all_uses_with`` and
  ``graph.erase_node`` do.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple, Union

import torch


class Aval:
    """Shape and dtype of a value (the abstract value the passes read)."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape: Sequence[int], dtype: Optional[torch.dtype]):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype

    @classmethod
    def of(cls, t: torch.Tensor) -> "Aval":
        return cls(t.shape, t.dtype)

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"{self.dtype}{list(self.shape)}"


class Ref:
    """Argument-template marker: this slot reads ``node.invars[i]``."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i

    def __repr__(self):  # pragma: no cover
        return f"Ref({self.i})"


class GVar:
    """An SSA value produced by a node or fed as a graph input/constant."""

    __slots__ = ("vid", "aval", "name")

    def __init__(self, vid: int, aval: Aval, name: str = ""):
        self.vid = vid
        self.aval = aval
        self.name = name or f"v{vid}"

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.aval.shape

    @property
    def dtype(self):
        return self.aval.dtype

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"%{self.name}:{self.dtype}{list(self.shape)}"


class GLit:
    """A literal operand frozen into the graph (paper: frozen args)."""

    __slots__ = ("val",)

    def __init__(self, val: Any):
        self.val = val

    def __repr__(self):  # pragma: no cover
        return f"lit({self.val!r})"


Operand = Union[GVar, GLit]


def _fill_template(t: Any, invars: Sequence[Any]) -> Any:
    """Replace every :class:`Ref` in a template by its operand."""
    if isinstance(t, Ref):
        return invars[t.i]
    if isinstance(t, (list, tuple)):
        return type(t)(_fill_template(e, invars) for e in t)
    if isinstance(t, dict):
        return {k: _fill_template(v, invars) for k, v in t.items()}
    return t


class GNode:
    """One operation: an ATen op application or a fused ``forge.*`` op."""

    __slots__ = ("nid", "op", "target", "params", "invars", "outvars", "meta")

    def __init__(
        self,
        nid: int,
        op: str,
        target: Optional[Callable],
        params: Dict[str, Any],
        invars: List[GVar],
        outvars: List[GVar],
        meta: Optional[Dict[str, Any]] = None,
    ):
        self.nid = nid
        self.op = op
        self.target = target
        self.params = params
        self.invars = invars
        self.outvars = outvars
        self.meta = meta or {}

    @property
    def is_fused(self) -> bool:
        return self.op.startswith("forge.")

    @property
    def args(self) -> List[Operand]:
        """Positional arguments: GVars for tensors, GLits for the rest."""
        if self.is_fused:
            return list(self.invars)
        out: List[Operand] = []
        for a in self.params.get("args", ()):
            if isinstance(a, Ref):
                out.append(self.invars[a.i])
            elif isinstance(a, (list, tuple)) and any(isinstance(e, Ref) for e in a):
                out.append(GLit(_fill_template(a, self.invars)))
            else:
                out.append(GLit(a))
        return out

    def kwarg(self, name: str, default: Any = None) -> Any:
        kw = self.params.get("kwargs", {})
        return kw.get(name, default)

    def __repr__(self):  # pragma: no cover
        outs = ", ".join(map(repr, self.outvars))
        ins = ", ".join(map(repr, self.args))
        return f"{outs} = {self.op}({ins})"


class Graph:
    """Mutable, topologically ordered operation graph (the FX analogue)."""

    def __init__(self):
        self._vid = itertools.count()
        self._nid = itertools.count()
        # nid -> GNode; insertion order == topological order (maintained by
        # passes: replacements occupy the position of the replaced chain's
        # last member).
        self.nodes: Dict[int, GNode] = {}
        self.invars: List[GVar] = []
        self.constvars: List[GVar] = []
        self.consts: List[Any] = []
        self.outvars: List[GVar] = []
        self.producer_of: Dict[int, Tuple[int, int]] = {}  # vid -> (nid, out_idx)
        self.users_of: Dict[int, Set[int]] = {}  # vid -> {nid}

    # -- construction -------------------------------------------------------

    def new_var(self, aval: Aval, name: str = "") -> GVar:
        v = GVar(next(self._vid), aval, name)
        self.users_of[v.vid] = set()
        return v

    def add_input(self, aval: Aval, name: str = "") -> GVar:
        v = self.new_var(aval, name)
        self.invars.append(v)
        return v

    def add_const(self, value: torch.Tensor, name: str = "") -> GVar:
        v = self.new_var(Aval.of(value), name or f"c{len(self.consts)}")
        self.constvars.append(v)
        self.consts.append(value)
        return v

    def add_node(
        self,
        op: str,
        target: Optional[Callable],
        params: Dict[str, Any],
        invars: Sequence[GVar],
        out_avals: Sequence[Aval],
        meta: Optional[Dict[str, Any]] = None,
    ) -> GNode:
        nid = next(self._nid)
        outvars = [self.new_var(a) for a in out_avals]
        node = GNode(nid, op, target, dict(params), list(invars), outvars, meta)
        self.nodes[nid] = node
        for k, ov in enumerate(outvars):
            self.producer_of[ov.vid] = (nid, k)
        for iv in invars:
            self.users_of.setdefault(iv.vid, set()).add(nid)
        return node

    def copy(self) -> "Graph":
        """A copy whose passes leave this graph as it is (the autotuner
        runs each candidate's passes on one copy of a single capture).

        Nodes, values, their avals, the node params' top level and
        ``kwargs``, metadata and the use lists are new; constant tensors
        and node targets are shared: passes add and replace constants but
        never write one (``passes/fold.py``, ``passes/device_const.py``).
        Ids are kept, so the copy's maps read as the original's."""
        g = Graph()
        vmap: Dict[int, GVar] = {}

        def var(v: GVar) -> GVar:
            nv = vmap.get(v.vid)
            if nv is None:
                nv = vmap[v.vid] = GVar(v.vid, Aval(v.aval.shape, v.aval.dtype), v.name)
            return nv

        g.invars = [var(v) for v in self.invars]
        g.constvars = [var(v) for v in self.constvars]
        g.consts = list(self.consts)
        for nid, n in self.nodes.items():
            params = dict(n.params)
            if isinstance(params.get("kwargs"), dict):
                params["kwargs"] = dict(params["kwargs"])
            g.nodes[nid] = GNode(nid, n.op, n.target, params, [var(v) for v in n.invars],
                                 [var(v) for v in n.outvars], dict(n.meta))
        g.outvars = [var(v) for v in self.outvars]
        g.producer_of = dict(self.producer_of)
        g.users_of = {vid: set(users) for vid, users in self.users_of.items()}
        vids = list(g.users_of) + list(g.producer_of) + list(vmap)
        g._vid = itertools.count(max(vids, default=-1) + 1)
        # past every node id a use list or producer entry may still name
        nids = (list(self.nodes) + [nid for users in self.users_of.values() for nid in users]
                + [nid for nid, _ in self.producer_of.values()])
        g._nid = itertools.count(max(nids, default=-1) + 1)
        return g

    # -- queries -------------------------------------------------------------

    def producer(self, v: Operand) -> Optional[GNode]:
        if not isinstance(v, GVar):
            return None
        pr = self.producer_of.get(v.vid)
        return self.nodes.get(pr[0]) if pr else None

    def users(self, v: GVar) -> List[GNode]:
        return [self.nodes[n] for n in self.users_of.get(v.vid, ()) if n in self.nodes]

    def n_uses(self, v: GVar) -> int:
        """Number of operand slots + graph outputs referencing ``v``."""
        cnt = sum(
            1
            for nid in self.users_of.get(v.vid, ())
            if nid in self.nodes
            for iv in self.nodes[nid].invars
            if iv.vid == v.vid
        )
        cnt += sum(1 for ov in self.outvars if ov.vid == v.vid)
        return cnt

    def is_output(self, v: GVar) -> bool:
        return any(ov.vid == v.vid for ov in self.outvars)

    def num_nodes(self) -> int:
        return len(self.nodes)

    def const_index(self) -> Dict[int, int]:
        """vid of each graph constant -> its position in ``consts``."""
        return {cv.vid: i for i, cv in enumerate(self.constvars)}

    def depth(self) -> int:
        """Longest def-use chain length (graph depth, cost-model term)."""
        memo: Dict[int, int] = {}
        d = 0
        for node in self.nodes.values():
            best = 0
            for iv in node.invars:
                pr = self.producer_of.get(iv.vid)
                if pr:
                    best = max(best, memo.get(pr[0], 0))
            memo[node.nid] = best + 1
            d = max(d, best + 1)
        return d

    # -- mutation ------------------------------------------------------------

    def replace_all_uses(self, old: GVar, new: GVar) -> None:
        """FX ``replace_all_uses_with``: rewire every consumer of ``old``."""
        for nid in list(self.users_of.get(old.vid, ())):
            node = self.nodes.get(nid)
            if node is None:
                continue
            changed = False
            for i, iv in enumerate(node.invars):
                if iv.vid == old.vid:
                    node.invars[i] = new
                    changed = True
            if changed:
                self.users_of.setdefault(new.vid, set()).add(nid)
        self.users_of[old.vid] = set()
        for i, ov in enumerate(self.outvars):
            if ov.vid == old.vid:
                self.outvars[i] = new

    def erase_node(self, node: GNode) -> None:
        """FX ``graph.erase_node``: node outputs must be unused."""
        for ov in node.outvars:
            if self.n_uses(ov):
                raise ValueError(f"erase_node: {node.op} output {ov} still in use")
        for iv in node.invars:
            s = self.users_of.get(iv.vid)
            if s is not None:
                s.discard(node.nid)
        for ov in node.outvars:
            self.producer_of.pop(ov.vid, None)
        del self.nodes[node.nid]

    def insert_node_like(
        self,
        anchor: GNode,
        op: str,
        params: Dict[str, Any],
        invars: Sequence[GVar],
        out_avals: Sequence[Aval],
        meta: Optional[Dict[str, Any]] = None,
    ) -> GNode:
        """Insert a new node occupying ``anchor``'s topological position.

        Used by fusion passes: the fused node replaces the last node of the
        matched chain, so def-before-use order is preserved.
        """
        node = self.add_node(op, None, params, invars, out_avals, meta)
        order: Dict[int, GNode] = {}
        for nid, n in self.nodes.items():
            if nid == node.nid:
                continue
            order[nid] = n
            if nid == anchor.nid:
                order[node.nid] = node
        if node.nid not in order:  # anchor missing => append
            order[node.nid] = node
        self.nodes = order
        return node

    # -- validation ----------------------------------------------------------

    def validate(self) -> None:
        """Check SSA & topological invariants; raise on violation."""
        defined: Set[int] = {v.vid for v in self.invars} | {v.vid for v in self.constvars}
        for node in self.nodes.values():
            for iv in node.invars:
                if iv.vid not in defined:
                    raise AssertionError(
                        f"use before def: {iv} consumed by {node.op} (nid={node.nid})"
                    )
            for ov in node.outvars:
                if ov.vid in defined:
                    raise AssertionError(f"double definition of {ov}")
                defined.add(ov.vid)
        for ov in self.outvars:
            if ov.vid not in defined:
                raise AssertionError(f"graph output {ov} is undefined")

    def __repr__(self):  # pragma: no cover
        lines = ["graph {"]
        lines += [f"  in  {v!r}" for v in self.invars]
        lines += [f"  cst {v!r}" for v in self.constvars]
        lines += [f"  {n!r}" for n in self.nodes.values()]
        lines += [f"  out {v!r}" for v in self.outvars]
        lines.append("}")
        return "\n".join(lines)
