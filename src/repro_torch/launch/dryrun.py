"""Multi-pod dry run: prove the distribution config is coherent, on a fake
mesh in one process: a port of the JAX package's ``launch/dryrun.py``.

For every (architecture × input shape × mesh) cell this program

1. builds the production mesh ((16,16) single-pod / (2,16,16) multi-pod)
   over a ``fake`` process group of 256 / 512 ranks (every collective a
   no-op, ``launch/mesh.fake_world``),
2. places the params, optimizer state, batch and cache by the cell's
   ``ShardingPlan`` as DTensors whose local shards are fake tensors
   (``FakeTensorMode``: no allocation anywhere),
3. runs the family step (``train_step`` / ``prefill_step`` /
   ``serve_step``, through the Forge-compiled bodies unless ``--fuse
   none``) on them: once on the first layer unit (its bodies compile,
   DTensor's sharding cache fills), then whole under
   :class:`StepCounter`, which sees the ops DTensor runs on one device's
   local shards: their FLOPs, their bytes, every collective (kind,
   shape, bytes) and the live bytes of the shards they make,
4. derives the three roofline terms (``launch/roofline.py``, H100
   constants) and writes the cell's record, the reference's keys, to
   the JSON file the caller names (reruns skip cached cells).

What differs from the reference's XLA dry run:

* the counts are the op-by-op program the port runs (no fusion): bytes
  are every op's inputs read once and outputs written once; per-device
  memory is the local shards of params, optimizer state, batch and cache
  plus the step's peak of live shards;
* the mesh is a ``cpu`` mesh, on which DTensor moves a dim's shards
  between mesh dims with an all-gather and a slice where NCCL would use
  an all-to-all;
* every layer runs, so the counts are exact without calibration;
  ``calibrated_totals`` keeps the reference's 1-unit / 2-unit
  extrapolation as a cross-check.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.json
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCH_IDS, SHAPES, get_config, input_specs, params_specs, shape_applicable
from ..distrib.sharding import distribute_tree, plan_for, replicate_plain
from .mesh import fake_world, make_production_mesh
from .roofline import RooflineTerms, collective_bytes, model_flops_for, weighted_bytes

# --------------------------------------------------------------------------
# counting one step's per-device work
# --------------------------------------------------------------------------

#: functional collectives (native and legacy) -> the reference's kinds
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional")


def _shape(t) -> Tuple[int, ...]:
    return tuple(t.shape)


def _linear_flops(x, w, *args, out_shape=None, **kwargs) -> int:
    return 2 * math.prod(x[:-1]) * x[-1] * w[-1]


def _flash_flops(q, k, v, *args, out_shape=None, **kwargs) -> int:
    B, H, Sq, D = q
    return 4 * B * H * Sq * k[2] * D


def _paged_flops(q, k_pages, v_pages, page_table, *args, out_shape=None, **kwargs) -> int:
    B, H, D = q
    return 4 * B * H * D * page_table[1] * k_pages[1]


def _mlstm_flops(q, k, v, *args, out_shape=None, **kwargs) -> int:
    B, H, S, D = q
    return 4 * B * H * S * S * D


def _slstm_flops(pre, r, *args, out_shape=None, **kwargs) -> int:
    B, S = pre[:2]
    H, hd, four_hd = r
    return 2 * B * S * H * hd * four_hd


def _rerun_and_vjp(forward: Callable[..., int]) -> Callable[..., int]:
    """A backward op's FLOPs: its forward's two products rerun, then their
    four vector-Jacobian products."""
    return lambda *shapes, **kw: 3 * forward(*shapes, **kw)


#: the kernel and opaque ops' matmul FLOPs (``torch.utils.flop_counter``
#: counts only ATen's); shapes in, as its formulas take them
_KERNEL_FLOPS: Dict[str, Callable[..., int]] = {
    "repro_torch::fused_linear": _linear_flops,
    "repro_torch::fused_linear_backward": _rerun_and_vjp(_linear_flops),
    "repro_torch::flash_attention": _flash_flops,
    "repro_torch::flash_attention_backward": _rerun_and_vjp(_flash_flops),
    "repro_torch::paged_attention": _paged_flops,
    "repro_torch::forge_mlstm": _mlstm_flops,
    "repro_torch::forge_mlstm_backward": _rerun_and_vjp(_mlstm_flops),
    "forge_scan::slstm": _slstm_flops,
    "forge_scan::slstm_backward": _rerun_and_vjp(_slstm_flops),
}


class StepCounter(TorchDispatchMode):
    """Counts what one device runs: a DTensor op is let through
    (``NotImplemented``), so DTensor desugars it into ops on local shards
    and collectives, which come back here.  ``flops`` (matmul-like ops;
    ``flops_by_op`` by op), ``bytes`` (each non-view op's tensor inputs and outputs),
    ``collectives`` (kind, output shape, output bytes) and ``peak`` (the
    most bytes of storages made inside the mode alive at once).

    An op counts when it makes tensors from none or reads a local shard
    of the step: one of ``inputs`` (the step's arguments, whose storages
    are not counted as made here) or of an op counted before.  Ops on
    other tensors only, such as DTensor's sharding propagation on global
    shapes and a Forge body's capture, are not the device's work."""

    def __init__(self, inputs: Any = ()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0
        self.flops_by_op: Dict[str, int] = {}
        self.bytes = 0
        self.collectives: List[Tuple[str, Tuple[int, ...], int]] = []
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, int] = {}
        self._sizes: Dict[int, int] = {}
        self._inputs = {_key(t.to_local() if isinstance(t, DTensor) else t)
                        for t in pytree.tree_leaves(inputs) if isinstance(t, torch.Tensor)}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        ins = [_key(t) for t in pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        if not (any(k in self._refs or k in self._inputs for k in ins) if ins
                else not _in_propagation()):
            return out
        self._count(func, args, kwargs, out)
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ns, name = func.namespace, func._overloadpacket._qualified_op_name.split("::")[-1]
        if ns in _COLLECTIVE_NS:
            kind = _COLLECTIVE_OPS.get(name)
            if kind is not None:
                for t in pytree.tree_leaves(out):
                    self.collectives.append((kind, _shape(t), t.numel() * t.element_size()))
            return
        formula = self._flop_registry.get(func._overloadpacket)
        flops = 0
        if formula is not None:
            flops = formula(*args, **kwargs, out_val=out)
        else:
            kernel = _KERNEL_FLOPS.get(f"{ns}::{name}")
            if kernel is not None:
                flops = kernel(*pytree.tree_map(
                    lambda a: _shape(a) if isinstance(a, torch.Tensor) else a, args))
        if flops:
            self.flops += flops
            key = f"{ns}::{name}"
            self.flops_by_op[key] = self.flops_by_op.get(key, 0) + flops
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in pytree.tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._inputs:
            return
        n = self._refs.get(key)
        if n is None:
            self._sizes[key] = st.nbytes()
            self.live += self._sizes[key]
            self.peak = max(self.peak, self.live)
            n = 0
        self._refs[key] = n + 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        n = self._refs[key] - 1
        if n:
            self._refs[key] = n
            return
        del self._refs[key]
        self.live -= self._sizes.pop(key)


def _in_propagation() -> bool:
    """Whether a tensor is being made for DTensor's sharding propagation
    (its stand-ins of the global shapes, ``OpSchema.gen_fake_args``)."""
    f = sys._getframe(2)
    for _ in range(12):
        if f is None:
            return False
        if f.f_code.co_name in ("gen_fake_args", "gen_fake_kwargs"):
            return True
        f = f.f_back
    return False


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def local_bytes(tree: Any) -> int:
    """The bytes of ``tree``'s local shards on one device."""
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel() * t.element_size()
               for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor))


# --------------------------------------------------------------------------
# cells
# --------------------------------------------------------------------------


def _act_policy(mesh, act_shard: Optional[str]):
    from ..distrib.actsharding import ActivationPolicy

    if act_shard in (None, "off"):
        return None
    if act_shard == "logits":  # head-output pin only (MoE archs)
        return ActivationPolicy(mesh=mesh, only=frozenset({"logits"}))
    return ActivationPolicy(mesh=mesh, sequence_parallel=(act_shard == "sp"))


def build_cell(cfg, shape_name: str, mesh, *, fsdp: Optional[bool] = None,
               seq_shard_cache: bool = True, moe_fsdp_dim: str = "contract",
               vocab_fsdp: bool = False):
    """Returns ``(step_fn, args, plan, spec)``: the cell's step and its
    arguments placed by the plan.  Call under ``FakeTensorMode``: the
    arguments are fake DTensors (the reference's abstract inputs with
    their shardings)."""
    from ..optim.adafactor import Adafactor, stack_layers
    from .steps import default_optimizer, make_prefill_step, make_serve_step, make_train_step

    spec = SHAPES[shape_name]
    plan = plan_for(cfg, mesh, fsdp=fsdp, seq_shard_cache=seq_shard_cache,
                    moe_fsdp_dim=moe_fsdp_dim, vocab_fsdp=vocab_fsdp)
    specs = input_specs(cfg, shape_name)
    p_sds = params_specs(cfg)
    params = distribute_tree(p_sds, plan.params_shardings(p_sds))

    if spec.kind == "train":
        opt = default_optimizer(cfg)
        o_sds = opt.init(p_sds)
        laid = stack_layers(p_sds, opt.stacked) if isinstance(opt, Adafactor) else p_sds
        opt_state = distribute_tree(o_sds, plan.opt_state_shardings(o_sds, laid))
        batch = distribute_tree(specs, plan.batch_shardings(specs))
        return make_train_step(cfg, opt), (params, opt_state, batch), plan, spec
    if spec.kind == "prefill":
        batch = distribute_tree(specs, plan.batch_shardings(specs))
        return make_prefill_step(cfg), (params, batch), plan, spec
    cache = distribute_tree(specs["cache"], plan.cache_shardings(specs["cache"]))
    token = distribute_tree(specs["token"], plan.batch_shardings(specs["token"]))
    pos = distribute_tree(specs["pos"], plan.scalar_sharding())
    return make_serve_step(cfg), (params, cache, token, pos), plan, spec


def _calib_layers(cfg) -> int:
    """Smallest homogeneous layer-pattern unit for flop calibration."""
    if cfg.family == "hybrid":
        return len(cfg.block_pattern or ("rec", "rec", "attn"))
    if cfg.family == "ssm" and cfg.slstm_every:
        return cfg.slstm_every
    return 1


def _with_layers(cfg, n: int):
    kw = dict(n_layers=n, scan_layers=False)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=n, n_dec_layers=n)
    return cfg.with_(**kw)


#: the layer lists of the port's trees (params, optimizer states, caches)
_LAYER_KEYS = ("blocks", "enc_blocks", "dec_blocks", "layers")


def _truncated(tree: Any, n: int) -> Any:
    """``tree`` with every layer list cut to its first ``n`` layers, and
    the leaves of a layer-stacked dict (an Adafactor state) to their first
    ``n`` rows."""

    def walk(x, stacked=False):
        if isinstance(x, dict):
            return {k: (x[k][:n] if k in _LAYER_KEYS and isinstance(x[k], list)
                        else walk(x[k], stacked or (k in _LAYER_KEYS and isinstance(x[k], dict))))
                    for k in x}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(walk(v, stacked) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v, stacked) for v in x)
        if stacked and isinstance(x, torch.Tensor) and x.ndim >= 1:
            return x[:n]
        return x

    return walk(tree)


def _run(cfg, shape_name: str, mesh, *, fsdp, seq_shard_cache, act_shard=None,
         moe_fsdp_dim="contract", vocab_fsdp=False) -> Dict[str, Any]:
    """Place one variant and count its step: a first call on the first
    layer unit (``_calib_layers``; the same config, so the same bodies)
    compiles the Forge bodies and fills DTensor's sharding cache, then the
    whole step runs under :class:`StepCounter`: the steady step, as the
    reference's compiled program is."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..distrib.actsharding import use_policy

    with FakeTensorMode():
        t0 = time.perf_counter()
        fn, args, plan, spec = build_cell(cfg, shape_name, mesh, fsdp=fsdp,
                                          seq_shard_cache=seq_shard_cache,
                                          moe_fsdp_dim=moe_fsdp_dim, vocab_fsdp=vocab_fsdp)
        base = local_bytes(args)
        t_place = time.perf_counter() - t0
        policy = _act_policy(mesh, act_shard)
        t0 = time.perf_counter()
        with use_policy(policy), replicate_plain():
            fn(*_truncated(args, _calib_layers(cfg)))
        t_warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        counter = StepCounter(args)
        with use_policy(policy), replicate_plain(), counter:
            out = fn(*args)
        del out
        t_step = time.perf_counter() - t0
    return {"plan": plan, "spec": spec, "flops": float(counter.flops),
            "flops_by_op": dict(counter.flops_by_op), "bytes": float(counter.bytes),
            "collectives": counter.collectives,
            "args_bytes": base, "peak_bytes": counter.peak,
            "place_s": t_place, "warm_s": t_warm, "step_s": t_step}


def _measure(cfg, shape_name: str, mesh, *, fsdp, seq_shard_cache,
             act_shard: Optional[str] = None,
             moe_fsdp_dim: str = "contract", vocab_fsdp: bool = False):
    """Run one variant; return (flops, bytes, coll_bytes) per device."""
    r = _run(cfg, shape_name, mesh, fsdp=fsdp, seq_shard_cache=seq_shard_cache,
             act_shard=act_shard, moe_fsdp_dim=moe_fsdp_dim, vocab_fsdp=vocab_fsdp)
    return r["flops"], r["bytes"], weighted_bytes(collective_bytes(r["collectives"]))


def calibrated_totals(cfg, shape_name: str, mesh, *, fsdp,
                      seq_shard_cache,
                      act_shard: Optional[str] = None,
                      moe_fsdp_dim: str = "contract",
                      vocab_fsdp: bool = False) -> Dict[str, float]:
    """Per-device totals extrapolated from 1-unit and 2-unit variants (the
    reference's calibration; 1 layer for homogeneous stacks, the block
    pattern for hybrid/ssm).  The port counts every layer of a full run,
    so this is a cross-check of the full run's totals."""
    unit = _calib_layers(cfg)
    L = cfg.n_layers
    kw = dict(fsdp=fsdp, seq_shard_cache=seq_shard_cache,
              act_shard=act_shard, moe_fsdp_dim=moe_fsdp_dim,
              vocab_fsdp=vocab_fsdp)
    f1, b1, c1 = _measure(_with_layers(cfg, unit), shape_name, mesh, **kw)
    f2, b2, c2 = _measure(_with_layers(cfg, 2 * unit), shape_name, mesh, **kw)
    n_units = L / unit
    return {
        "flops": f1 + (f2 - f1) * (n_units - 1),
        "bytes": b1 + (b2 - b1) * (n_units - 1),
        "coll_bytes": c1 + (c2 - c1) * (n_units - 1),
        "per_unit": {"flops": f2 - f1, "bytes": b2 - b1, "coll_bytes": c2 - c1},
        "base": {"flops": f1, "bytes": b1, "coll_bytes": c1},
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             fuse: Optional[str] = None, fsdp: Optional[bool] = None,
             seq_shard_cache: bool = True, calibrate: bool = True,
             act_shard: Optional[str] = None,
             moe_fsdp_dim: str = "contract", vocab_fsdp: bool = False,
             mesh=None, cfg=None, verbose: bool = True) -> Dict[str, Any]:
    """One cell's record.  Without ``mesh`` it builds the production mesh
    over a ``fake`` group of its size (none may be live).  ``cfg``
    replaces ``get_config(arch)`` (a cut-down variant)."""
    cfg = cfg or get_config(arch)
    if fuse is not None:
        cfg = cfg.with_(fuse=fuse)
    runs, reason = shape_applicable(cfg, shape_name)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell_id = f"{arch}|{shape_name}|{mesh_name}"
    if not runs:
        return {"cell": cell_id, "status": "skipped", "reason": reason}
    if mesh is None:
        with fake_world(512 if multi_pod else 256):
            return run_cell(arch, shape_name, multi_pod=multi_pod, fsdp=fsdp,
                            seq_shard_cache=seq_shard_cache, calibrate=calibrate,
                            act_shard=act_shard, moe_fsdp_dim=moe_fsdp_dim,
                            vocab_fsdp=vocab_fsdp, mesh=make_production_mesh(multi_pod=multi_pod),
                            cfg=cfg, verbose=verbose)
    chips = math.prod(mesh.shape)
    kw = dict(moe_fsdp_dim=moe_fsdp_dim, vocab_fsdp=vocab_fsdp)
    r = _run(cfg, shape_name, mesh, fsdp=fsdp, seq_shard_cache=seq_shard_cache,
             act_shard=act_shard, **kw)
    plan, spec = r["plan"], r["spec"]
    coll = collective_bytes(r["collectives"])
    counts = coll.pop("_counts")
    weighted = weighted_bytes(coll)

    calib: Dict[str, Any] = {}
    if calibrate:
        try:
            calib = calibrated_totals(cfg, shape_name, mesh, fsdp=plan.fsdp,
                                      seq_shard_cache=plan.seq_shard_cache,
                                      act_shard=act_shard, **kw)
        except Exception as e:  # noqa: BLE001 — the full run's counts stand
            calib = {"error": f"{type(e).__name__}: {e}"}

    mem = {"args_bytes": float(r["args_bytes"]), "peak_step_bytes": float(r["peak_bytes"]),
           "total_bytes_per_device": float(r["args_bytes"] + r["peak_bytes"])}
    terms = RooflineTerms(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=r["flops"], hlo_bytes=r["bytes"], coll_bytes=weighted,
        coll_detail={**coll, "counts": counts},
        model_flops=model_flops_for(cfg, spec.kind, spec.seq_len, spec.global_batch) / chips,
        bytes_per_device=mem["total_bytes_per_device"],
    )
    rec = {
        "cell": cell_id,
        "status": "ok",
        "kind": spec.kind,
        "fuse": cfg.fuse,
        "fsdp": plan.fsdp,
        "seq_shard_cache": plan.seq_shard_cache,
        "lower_s": round(r["place_s"], 2),  # placing the arguments
        "compile_s": round(r["warm_s"], 2),  # the first call: bodies compile
        "step_s": round(r["step_s"], 2),  # the counted step
        "memory": mem,
        "cost": {"flops": r["flops"], "bytes accessed": r["bytes"],
                 "flops_by_op": r["flops_by_op"]},
        "cost_scan_raw": {"flops": r["flops"], "coll_bytes": weighted},
        "calibration": calib,
        "roofline": terms.as_dict(),
        "fallbacks": plan.fallbacks[:20],
        "collectives": {"n_ops": len(r["collectives"]), "note": (
            "cpu fake mesh: DTensor moves shards between mesh dims by all-gather + slice "
            "where NCCL would all-to-all")},
    }
    if verbose:
        print(f"[dryrun] {cell_id}: fuse={cfg.fuse} step={r['step_s']:.1f}s "
              f"flops/dev={terms.hlo_flops:.3g} bytes/dev={terms.hlo_bytes:.3g} "
              f"coll/dev={terms.coll_bytes:.3g} mem/dev="
              f"{terms.bytes_per_device / 2**30:.2f}GiB dom={terms.dominant}")
        print(f"  memory: {mem}")
    return rec


def load_results(path: str) -> Dict[str, Any]:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_results(path: str, results: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1, default=str)
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--fuse", choices=["forge", "none"], default=None)
    ap.add_argument("--fsdp", choices=["auto", "on", "off"], default="auto")
    ap.add_argument("--act-shard", choices=["off", "tp", "sp", "logits"], default="off",
                    help="activation sharding constraints")
    ap.add_argument("--moe-fsdp-dim", choices=["contract", "output"], default="contract")
    ap.add_argument("--vocab-fsdp", action="store_true")
    ap.add_argument("--no-seq-shard-cache", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every arch to this many layers (a quick sweep)")
    ap.add_argument("--out", default=None, help="JSON results file (cells cached by key)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="variant tag")
    args = ap.parse_args(argv)

    fsdp = {"auto": None, "on": True, "off": False}[args.fsdp]
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(arch, shape, mp) for mp in meshes for arch in archs for shape in shapes]

    results = load_results(args.out) if args.out else {}
    n_ok = n_skip = n_fail = 0
    for arch, shape, mp in cells:
        key = f"{arch}|{shape}|{'pod2x16x16' if mp else 'pod16x16'}"
        if args.tag:
            key += f"|{args.tag}"
        if key in results and results[key].get("status") in ("ok", "skipped") \
                and not args.force:
            print(f"[dryrun] cached: {key}")
            continue
        cfg = get_config(arch)
        if args.layers:
            cfg = _with_layers(cfg, args.layers)
        t0 = time.perf_counter()
        try:
            rec = run_cell(
                arch, shape, multi_pod=mp, fuse=args.fuse, fsdp=fsdp,
                seq_shard_cache=not args.no_seq_shard_cache,
                act_shard=args.act_shard, moe_fsdp_dim=args.moe_fsdp_dim,
                vocab_fsdp=args.vocab_fsdp, cfg=cfg,
                calibrate=not mp,  # single-pod roofline only
            )
            rec["tag"] = args.tag
            rec["cell_s"] = round(time.perf_counter() - t0, 2)  # the whole cell, calibration too
            results[key] = rec
            n_ok += rec["status"] == "ok"
            n_skip += rec["status"] == "skipped"
        except Exception as e:  # noqa: BLE001 — the sweep must survive
            traceback.print_exc()
            results[key] = {"cell": key, "status": "failed",
                            "error": f"{type(e).__name__}: {e}"}
            n_fail += 1
        if args.out:
            save_results(args.out, results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_fail} failed"
          + (f" -> {args.out}" if args.out else ""))
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
