"""Phase 1 — graph capture with ``torch.export`` at the ATen level.

``trace_to_graph`` exports an arbitrary function of a pytree of tensors
with ``torch.export.export`` and converts the default export IR (no
``run_decompositions()``) into a :class:`~repro_torch.core.graph.Graph`
of ATen operations — the capture the paper itself uses.  In that IR
``aten.matmul``, ``aten.gelu`` (with ``approximate``),
``aten.softmax.int``, ``aten.where`` and ``aten.arange`` stay single
nodes, which keeps the Phase-2 matchers small.  Export's own
``aten._assert_tensor_metadata`` checks are dropped, and
``operator.getitem`` projections of multi-output ops resolve to the
producing node's outputs.

Kernel calls: every kernel wrapper of the port is a
``torch.library.custom_op`` (``repro_torch::<kernel>``) with a fake
implementation, so export records a traced kernel call as ONE node whose
output shape comes from the fake, and no fake tensor ever reaches a
``ctypes`` launch.  Such a node enters the graph like any ATen node (its
target is the op overload, its literal arguments frozen); the passes
match no pattern through it, Phase 3 routes it to the accelerator
(``lowering.KERNEL_OP_PREFIX``) and the executor calls the op, which
launches the kernel on a CUDA tensor.

Tied-weight resolution (paper §4.2.1): when the example inputs contain
the *same tensor object* at several pytree leaves (e.g. tied embedding /
LM head), the duplicates are merged onto one canonical graph input —
matching by object identity exactly like the paper's ``id()`` check.
Only the unique leaves are handed to ``torch.export``.
"""
from __future__ import annotations

import operator
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Sequence

import torch
from torch.export.graph_signature import InputKind
from torch.utils import _pytree as pytree

from .graph import Aval, Graph, Ref

# export-only bookkeeping nodes with no runtime meaning
_DROP_TARGETS = (torch.ops.aten._assert_tensor_metadata.default,)


@dataclass
class CaptureResult:
    graph: Graph
    in_spec: Any
    out_spec: Any
    n_inputs_raw: int
    tied_map: Dict[int, int] = field(default_factory=dict)  # dup leaf idx -> canonical idx
    capture_ms: float = 0.0


def resolve_tied_weights(flat_leaves: Sequence[Any]) -> Dict[int, int]:
    """Map duplicate-leaf index -> canonical index, by object identity.

    The port's form of the paper's ``id()``-based tied-weight detection
    (Listing 2): two pytree leaves referencing the same tensor object are
    one logical parameter.
    """
    seen: Dict[int, int] = {}
    tied: Dict[int, int] = {}
    for i, leaf in enumerate(flat_leaves):
        key = id(leaf)
        if key in seen:
            tied[i] = seen[key]
        else:
            seen[key] = i
    return tied


def _flat_module(fn: Callable, in_spec: Any, n_raw: int, tied: Dict[int, int]):
    """``fn`` as a module of its unique flat tensor leaves (export's
    input), plus the dict its traced call records the output structure in."""
    keep = [i for i in range(n_raw) if i not in tied]
    pos = {i: j for j, i in enumerate(keep)}
    # raw leaf index -> position in the unique-leaf argument list
    src = [pos[tied.get(i, i)] for i in range(n_raw)]
    box: Dict[str, Any] = {}

    class FlatModule(torch.nn.Module):
        def forward(self, *uniq):
            args = pytree.tree_unflatten([uniq[j] for j in src], in_spec)
            flat, spec = pytree.tree_flatten(fn(*args))
            box["out_spec"] = spec
            return tuple(flat)

    return FlatModule(), box


def _avals(val: Any) -> List[Aval]:
    if isinstance(val, torch.Tensor):
        return [Aval.of(val)]
    if isinstance(val, (list, tuple)):
        return [Aval.of(v) for v in val]
    if val is None:
        return []
    raise TypeError(f"capture: unsupported node value {type(val).__name__}")


def from_exported(ep: torch.export.ExportedProgram) -> Graph:
    """Build a Graph from an ExportedProgram's ATen graph."""
    g = Graph()
    env: Dict[torch.fx.Node, Any] = {}
    specs = list(ep.graph_signature.input_specs)
    placeholders = [n for n in ep.graph.nodes if n.op == "placeholder"]
    for node, spec in zip(placeholders, specs):
        if spec.kind == InputKind.USER_INPUT:
            env[node] = g.add_input(Aval.of(node.meta["val"]), node.name)
        elif spec.kind in (InputKind.PARAMETER, InputKind.BUFFER):
            env[node] = g.add_const(ep.state_dict[spec.target], node.name)
        elif spec.kind == InputKind.CONSTANT_TENSOR:
            env[node] = g.add_const(ep.constants[spec.target], node.name)
        else:
            raise TypeError(f"capture: unsupported export input kind {spec.kind}")

    for node in ep.graph.nodes:
        if node.op != "call_function":
            continue
        if node.target in _DROP_TARGETS:
            continue
        if node.target is operator.getitem:
            src, idx = node.args
            env[node] = env[src][idx]
            continue
        invars: List[Any] = []

        def template(a):
            if isinstance(a, torch.fx.Node):
                invars.append(env[a])
                return Ref(len(invars) - 1)
            if isinstance(a, (list, tuple)):
                return type(a)(template(e) for e in a)
            return a

        args = template(tuple(node.args))
        kwargs = {k: template(v) for k, v in node.kwargs.items()}
        gnode = g.add_node(
            str(node.target), node.target, {"args": args, "kwargs": kwargs},
            invars, _avals(node.meta.get("val")),
        )
        val = node.meta.get("val")
        env[node] = gnode.outvars if isinstance(val, (list, tuple)) else (
            gnode.outvars[0] if gnode.outvars else None)

    (outs,) = [n.args[0] for n in ep.graph.nodes if n.op == "output"]
    g.outvars = [env[o] for o in outs]
    g.validate()
    return g


def trace_to_graph(fn: Callable, *example_args: Any, tie_weights: bool = True) -> CaptureResult:
    """Capture ``fn`` as a Graph (Phase 1).

    ``example_args`` is a pytree of tensors; the graph is specialised to
    their shapes, dtypes and device.  Integer positions that must vary
    between calls have to be tensors (0-d or per-row), not Python ints:
    a Python value is frozen into the graph.
    """
    t0 = time.perf_counter()
    flat, in_spec = pytree.tree_flatten(tuple(example_args))
    for leaf in flat:
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"capture: every input leaf must be a tensor, got "
                            f"{type(leaf).__name__}")
    tied = resolve_tied_weights(flat) if tie_weights else {}
    mod, box = _flat_module(fn, in_spec, len(flat), tied)
    uniq = tuple(x for i, x in enumerate(flat) if i not in tied)
    ep = torch.export.export(mod, uniq)
    g = from_exported(ep)
    return CaptureResult(
        graph=g,
        in_spec=in_spec,
        out_spec=box["out_spec"],
        n_inputs_raw=len(flat),
        tied_map=tied,
        capture_ms=(time.perf_counter() - t0) * 1e3,
    )
