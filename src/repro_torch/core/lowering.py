"""Phase 3 — lowering the optimized graph to the typed register IR (RGIR).

The port's form of the paper's NPUIR (§4.4): every graph node becomes one
:class:`RGIROp` instruction carrying

* an **opcode** — ``accel.<op>`` for tensor-core-bound dispatches (all
  ``forge.*`` fused nodes, the kernel custom ops ``repro_torch.*`` that
  capture met inside a traced kernel wrapper, plus raw matmuls),
  ``host.<op>`` for glue ops (the paper's ``npu.module`` /
  ``cpu.aten.*`` split),
* **typed virtual registers** — integer IDs for inputs/outputs with
  shape/dtype metadata,
* a **device** tag consumed by the Phase-4 scheduler.  On the card both
  tags run on the same CUDA tensors (no host round trip): the tag is
  scheduling metadata, as the segment boundary it marks is where a later
  segment backend cuts its programs,
* a **pre-resolved callable** — the ATen overload with its argument
  template, or the fused kernel dispatch — so the executor performs no
  attribute lookup at run time,
* **frozen args** — literal arguments are frozen into the instruction
  at lowering time; tensor operands are register references.

Lowering is a single topological traversal (paper Algorithm 1).  Only
constants actually referenced by live instructions are loaded into the
program's constant table.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Sequence, Tuple

from .fused_ops import fused_callable
from .graph import Graph, GNode, GVar, Ref

#: opcodes routed to the accelerator (tensor-core-bound dispatch units):
#: fused dispatches and bare matmuls
ACCEL_OPS = (
    "aten.matmul.default",
    "aten.mm.default",
    "aten.bmm.default",
    "aten.addmm.default",
    "aten.linear.default",
    "aten.convolution.default",
)


#: namespace of the port's kernel custom ops (``torch.library.custom_op``
#: ``repro_torch::<kernel>``).  A traced call of a kernel wrapper is one
#: opaque node of this namespace; it is an accelerator dispatch unit and
#: the executor calls the op itself, which launches the kernel (or takes
#: the plain version on the CPU).
KERNEL_OP_PREFIX = "repro_torch."


def route_device(op: str) -> str:
    if op.startswith("forge.") or op.startswith(KERNEL_OP_PREFIX):
        return "accel"
    if op in ACCEL_OPS:
        return "accel"
    return "host"


class RegRef:
    """Marker: operand slot reads virtual register ``reg`` (paper _RegRef)."""

    __slots__ = ("reg",)

    def __init__(self, reg: int):
        self.reg = reg

    def __repr__(self):  # pragma: no cover
        return f"r{self.reg}"


@dataclass
class RGIROp:
    """One typed instruction (paper Listing 7's ``NPUIROp``)."""

    op_id: int
    opcode: str
    device: str  # 'accel' | 'host'
    target: Callable  # pre-resolved: ATen call or fused kernel dispatch
    frozen_args: Tuple[Any, ...]  # RegRef per tensor operand
    input_regs: Tuple[int, ...]
    output_regs: Tuple[int, ...]
    params: Dict[str, Any] = field(default_factory=dict)
    out_avals: Tuple[Any, ...] = ()
    #: rough FLOP estimate (:func:`node_flops`)
    flops: float = 0.0

    def execute(self, read: Callable[[int], Any]) -> List[Any]:
        out = self.target(*[read(a.reg) for a in self.frozen_args])
        if out is None:
            return []
        return list(out) if isinstance(out, (list, tuple)) else [out]

    def __repr__(self):  # pragma: no cover
        ins = ", ".join(map(str, self.frozen_args))
        outs = ", ".join(f"r{r}" for r in self.output_regs)
        return f"[{self.device}] {outs} = {self.opcode}({ins})"


@dataclass
class RGIRProgram:
    """The flat instruction stream plus register metadata."""

    ops: List[RGIROp]
    n_vregs: int
    input_regs: List[int]
    output_regs: List[int]
    #: reg -> concrete value, pre-loaded once (paper: ``self.constants``)
    constants: Dict[int, Any]
    #: reg -> aval (shape/dtype) for every register
    reg_avals: Dict[int, Any]

    def device_transitions(self) -> int:
        """δ(I) — number of accel↔host boundaries (paper Eq. 17)."""
        return sum(1 for a, b in zip(self.ops, self.ops[1:]) if a.device != b.device)

    def renumber(self, order: Sequence[int]) -> "RGIRProgram":
        """Return a program with ops permuted into ``order`` (op_ids kept)."""
        return RGIRProgram(
            ops=[self.ops[i] for i in order],
            n_vregs=self.n_vregs,
            input_regs=self.input_regs,
            output_regs=self.output_regs,
            constants=self.constants,
            reg_avals=self.reg_avals,
        )


#: bare products: the operand position whose last axis is contracted
_PRODUCT_LHS = {"aten.matmul.default": 0, "aten.mm.default": 0, "aten.bmm.default": 0,
                "aten.linear.default": 0, "aten.addmm.default": 1}


def node_flops(node: GNode) -> float:
    """Rough FLOP estimate used by the cost model and the program stats:
    4·B·H·Sq·Sk·D for ``forge.sdpa``, 2·M·K·N for a linear (twice that
    for ``forge.swiglu``'s two products) and for a bare product, else one
    operation per output element."""
    if not node.outvars:
        return 0.0
    if node.op == "forge.sdpa":
        q, k = node.invars[0], node.invars[1]
        B, H, Sq, D = q.shape
        return 4.0 * B * H * Sq * k.shape[2] * D
    if node.op in ("forge.linear_act", "forge.swiglu"):
        x, w = node.invars[0], node.invars[1]
        mult = 2.0 if node.op == "forge.swiglu" else 1.0
        return mult * 2.0 * math.prod(x.shape[:-1]) * x.shape[-1] * w.shape[-1]
    if node.op in _PRODUCT_LHS:
        lhs = node.invars[_PRODUCT_LHS[node.op]]
        return 2.0 * math.prod(node.outvars[0].shape) * (lhs.shape[-1] if lhs.shape else 1)
    return float(math.prod(node.outvars[0].shape))


def _plain(t: Any) -> Any:
    """A template with export's immutable lists and dicts made plain ones
    (a torch.compile trace of the call takes no ``immutable_list``)."""
    if isinstance(t, (list, tuple)):
        return (list if isinstance(t, list) else type(t))(_plain(e) for e in t)
    if isinstance(t, dict):
        return {k: _plain(v) for k, v in t.items()}
    return t


def _aten_target(node: GNode) -> Callable:
    """The node's ATen call with its argument template pre-bound."""
    fn = node.target
    args_t, kwargs_t = _plain(node.params["args"]), _plain(node.params["kwargs"])
    # positions of top-level tensor operands; nested ones take the slow path
    flat = all(not isinstance(a, (list, tuple)) or not any(isinstance(e, Ref) for e in a)
               for a in args_t) and not any(isinstance(v, (Ref, list, tuple))
                                            for v in kwargs_t.values())
    if flat:
        slots = [(i, a.i) for i, a in enumerate(args_t) if isinstance(a, Ref)]
        base = list(args_t)

        def call(*vals):
            args = base.copy()
            for i, j in slots:
                args[i] = vals[j]
            return fn(*args, **kwargs_t)

        return call

    from .graph import _fill_template

    def call_nested(*vals):
        return fn(*_fill_template(args_t, vals), **_fill_template(kwargs_t, vals))

    return call_nested


def lower_to_rgir(g: Graph) -> RGIRProgram:
    """FX→NPUIR lowering, Algorithm 1: one topological traversal."""
    reg_of: Dict[int, int] = {}  # GVar vid -> vreg
    reg_avals: Dict[int, Any] = {}
    next_reg = 0

    def reg_for(v: GVar) -> int:
        nonlocal next_reg
        r = reg_of.get(v.vid)
        if r is None:
            r = next_reg
            next_reg += 1
            reg_of[v.vid] = r
            reg_avals[r] = v.aval
        return r

    input_regs = [reg_for(v) for v in g.invars]

    used_vids = {iv.vid for node in g.nodes.values() for iv in node.invars}
    used_vids |= {ov.vid for ov in g.outvars}
    constants: Dict[int, Any] = {}
    for cv, cval in zip(g.constvars, g.consts):
        if cv.vid in used_vids:
            constants[reg_for(cv)] = cval

    ops: List[RGIROp] = []
    for idx, node in enumerate(g.nodes.values()):
        in_regs: List[int] = []
        for iv in node.invars:
            r = reg_of.get(iv.vid)
            if r is None:
                raise ValueError(f"lowering: operand {iv} of {node.op} is undefined")
            in_regs.append(r)
        out_regs = [reg_for(ov) for ov in node.outvars]
        if node.is_fused:
            target = fused_callable(node)
            opcode = f"accel.{node.op}"
        else:
            target = _aten_target(node)
            opcode = f"{route_device(node.op)}.{node.op}"
        ops.append(
            RGIROp(
                op_id=idx,
                opcode=opcode,
                device=route_device(node.op),
                target=target,
                frozen_args=tuple(RegRef(r) for r in in_regs),
                input_regs=tuple(in_regs),
                output_regs=tuple(out_regs),
                params=dict(node.params),
                out_avals=tuple(ov.aval for ov in node.outvars),
                flops=node_flops(node),
            )
        )

    return RGIRProgram(
        ops=ops,
        n_vregs=next_reg,
        input_regs=input_regs,
        output_regs=[reg_of[ov.vid] for ov in g.outvars],
        constants=constants,
        reg_avals=reg_avals,
    )
