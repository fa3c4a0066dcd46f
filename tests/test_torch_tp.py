"""Tensor parallelism in the port's distributed layer: a planned call
does one device's share of the work on the ``model`` axis, as XLA
partitions the JAX package's products.

* On spawned gloo ranks (``torch_dist_workers.tp_rank``), meshes (1, 2)
  and (2, 2) (and (1, 4) for qwen2.5-14b, whose 2 KV heads do not divide
  4): forge-125m (GELU, biases), deepseek-7b (SwiGLU) and qwen2.5-14b
  (GQA, QKV bias) smoke in f32, planned ``apply`` logits and the loss and
  every gradient within the f32 smoke bar (rtol 2e-4 / atol 2e-5) of the
  unplanned port run and of the JAX package; the fused-linear launches
  take column- and row-parallel shards and flash runs on local heads.
* ``ShardingPlan.attention_layout``: heads sharded, K/V repeated, or
  gathered and recorded in ``plan.fallbacks``.
* The dry run's counter on fake meshes: the fused-linear FLOPs a device
  on (2, 4) are 1/4 of (2, 1)'s, and the 2-layer qwen2.5-14b smoke
  cell's FLOPs a layer a device are within ``REF_FACTOR`` of the JAX
  package's ``calibrated_totals`` (run in a subprocess on 8 host
  devices).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_config as jax_get_config
from repro.launch import steps as jax_steps
from repro.models import get_model as jax_get_model
from repro_torch.configs import get_config, params_specs
from repro_torch.distrib.sharding import plan_for
from repro_torch.launch import steps
from repro_torch.launch.mesh import fake_world, make_mesh, make_production_mesh
from repro_torch.models import get_model

from torch_dist_workers import dry_count_rank, spawn_all, tp_rank
from torch_port_support import TOL_F32, jax_params, port_params

ARCHS = ("forge-125m", "deepseek-7b", "qwen2.5-14b")
CASES = [(a, s) for s in ((1, 2), (2, 2)) for a in ARCHS] + [("qwen2.5-14b", (1, 4))]
B, S = 4, 16
#: the port's FLOPs a layer a device against the reference's: the port
#: counts its op-by-op program (the attention core's backward reruns the
#: forward), XLA's cost analysis a fused one
REF_FACTOR = 1.5
REF_CELL = ("qwen2.5-14b", "train_4k")

_REFERENCE_CELL = """
import json, sys
import jax
from repro.configs import get_config
from repro.launch import dryrun
cfg = dryrun._with_layers(get_config(sys.argv[1], smoke=True), 2)
mesh = jax.make_mesh((2, 4), ("data", "model"))
print(json.dumps(dryrun.calibrated_totals(cfg, sys.argv[2], mesh, fsdp=False,
                                          seq_shard_cache=True)))
"""


def _batch():
    rng = np.random.default_rng(0)
    vocab = get_config("forge-125m", smoke=True).vocab
    assert all(get_config(a, smoke=True).vocab == vocab for a in ARCHS)
    return {k: rng.integers(0, vocab, (B, S)).astype(np.int32) for k in ("tokens", "labels")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the reference dry-run subprocess, the gloo ranks and the
    dry run's counts (``torch_dist_workers.dry_count_rank``), and
    computes the unplanned port run and the JAX package's meanwhile."""
    d = tmp_path_factory.mktemp("tp")
    env = dict(os.environ, PYTHONPATH="src",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS=os.environ.get("JAX_PLATFORMS", "cpu"))
    ref_cell = subprocess.Popen([sys.executable, "-c", _REFERENCE_CELL, *REF_CELL], env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                cwd=os.path.dirname(os.path.dirname(__file__)))
    nb = _batch()
    torch.save({k: torch.from_numpy(v).long() for k, v in nb.items()}, d / "batch.pt")
    setups = {}
    for arch in ARCHS:
        jcfg = jax_get_config(arch, smoke=True).with_(dtype="float32")
        jp = jax_params(jcfg)
        p = port_params(jp)
        torch.save(p, d / f"{arch}.pt")
        setups[arch] = (jcfg, jp, p)
    cases = [(a, str(d / f"{a}.pt")) for a in ARCHS]
    refs = {}

    def unplanned_and_jax():
        tb = {k: torch.from_numpy(v).long() for k, v in nb.items()}
        jb = {k: jnp.asarray(v) for k, v in nb.items()}
        for arch, (jcfg, jp, p) in setups.items():
            cfg = get_config(arch, smoke=True).with_(dtype="float32")
            with torch.no_grad():
                logits = get_model(cfg).apply(p, tb["tokens"], cfg)
            loss, grads = steps.loss_and_grads(steps.make_loss_fn(cfg), p, tb)
            jlogits = jax_get_model(jcfg).apply(jp, jb["tokens"], jcfg)
            jloss, jgrads = jax.jit(jax.value_and_grad(jax_steps.make_loss_fn(jcfg)))(jp, jb)
            refs[arch] = {"port": (logits, loss, grads),
                          "jax": (torch.from_numpy(np.array(jlogits)),
                                  torch.tensor(float(jloss)), port_params(jgrads))}

    batch = str(d / "batch.pt")
    two, four, count = spawn_all(
        [(tp_rank, 2, d / "two", [((1, 2), cases)], batch),
         (tp_rank, 4, d / "four", [((2, 2), cases), ((1, 4), cases[-1:])], batch),
         (dry_count_rank, 1, d / "count", *REF_CELL)], timeout=120, meanwhile=unplanned_and_jax)
    planned = {**torch.load(os.path.join(two, "tp.pt")), **torch.load(os.path.join(four, "tp.pt"))}
    counted = torch.load(os.path.join(count, "counts.pt"))
    out, err = ref_cell.communicate(timeout=120)
    assert ref_cell.returncode == 0, err[-2000:]
    return {"planned": planned, "refs": refs, "counted": counted,
            "ref_cell": json.loads(out.strip().splitlines()[-1])}


def _close(got, want, what):
    torch.testing.assert_close(got, want, **TOL_F32, msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("arch,shape", CASES, ids=[f"{a}-{s[0]}x{s[1]}" for a, s in CASES])
@pytest.mark.parametrize("against", ["port", "jax"])
def test_planned_matches(runs, arch, shape, against):
    got = runs["planned"][(arch, shape)]
    logits, loss, grads = runs["refs"][arch][against]
    _close(got["logits"], logits, "logits")
    _close(got["loss"], loss, "loss")
    want = dict(pytree.tree_flatten_with_path(grads)[0])
    flat = pytree.tree_flatten_with_path(got["grads"])[0]
    assert len(flat) == len(want)
    for path, g in flat:
        _close(g, want[path], f"grad {pytree.keystr(path)}")


def test_kernels_take_local_shards(runs):
    """forge-125m smoke (d 64, 4 heads of 16, d_ff 128) on (1, 2): the
    fused-linear launches are column-parallel (w (64, 64) of the FFN's
    (64, 128)) and row-parallel (x (64, 32) into wo's 32 rows, x (64, 64)
    into w_out's 64 rows), flash runs 2 heads a device; qwen2.5-14b on
    (1, 4): 1 query head a device on 1 KV head (2 repeated to 4)."""
    seen = {(n, s) for n, s in runs["planned"][("forge-125m", (1, 2))]["kernel_shapes"]}
    assert ("fused_linear", ((64, 64), (64, 64), (64,))) in seen  # w_fc, column-parallel
    assert ("fused_linear", ((64, 64), (64, 64), (64,))) in seen
    assert ("fused_linear", ((64, 32), (32, 64))) in seen  # wo, row-parallel
    assert ("flash_attention", ((B, 2, S, 16),) * 3) in seen
    assert not any(n == "fused_linear" and s[1] in ((64, 128), (128, 64)) for n, s in seen)
    qwen = runs["planned"][("qwen2.5-14b", (1, 4))]
    assert qwen["layout"] == {"mode": "kv_repeated", "kv_heads": 4}
    assert {s for n, s in qwen["kernel_shapes"] if n == "flash_attention"} == {
        ((B, 1, S, 16),) * 3}
    for key, r in runs["planned"].items():
        assert r["fallbacks"] == [], key


def test_attention_layout_and_fallbacks():
    with fake_world(8):
        mesh = make_mesh((1, 8), ("data", "model"))
        cfg = get_config("forge-125m", smoke=True)
        plan = plan_for(cfg, mesh)
        assert plan.attention_layout() == {"mode": "gathered", "kv_heads": 4}
        assert plan.fallbacks == []
        for _ in range(2):  # recorded once, where the params are placed
            plan.params_shardings(params_specs(cfg))
            assert plan.fallbacks == ["attention: n_heads 4 % model(8) != 0 -> heads gathered"]
    with fake_world(256):
        mesh = make_production_mesh()
        layouts = {a: plan_for(get_config(a), mesh).attention_layout()
                   for a in ("qwen2.5-14b", "qwen2-vl-72b", "deepseek-7b")}
    assert layouts == {"qwen2.5-14b": {"mode": "gathered", "kv_heads": 8},
                       "qwen2-vl-72b": {"mode": "kv_repeated", "kv_heads": 16},
                       "deepseek-7b": {"mode": "heads", "kv_heads": 32}}


@pytest.fixture(scope="module")
def counted(runs):
    return runs["counted"]


def test_fused_linear_flops_split_over_model(counted):
    one = counted[(2, 1), 1]["flops_by_op"]
    four = counted[(2, 4), 1]["flops_by_op"]
    assert four["repro_torch::fused_linear"] * 4 == one["repro_torch::fused_linear"]
    assert four["repro_torch::flash_attention"] * 4 == one["repro_torch::flash_attention"]
    assert counted[(2, 4), 1]["flops"] < counted[(2, 1), 1]["flops"] / 2


def test_flops_a_layer_against_reference(runs, counted):
    port = counted[(2, 4), 2]["flops"] - counted[(2, 4), 1]["flops"]
    ref = runs["ref_cell"]["per_unit"]["flops"]
    assert ref / REF_FACTOR <= port <= ref * REF_FACTOR, (port, ref)
