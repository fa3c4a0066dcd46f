"""The port's dry run and its pieces against the JAX package's:
``model_flops_for`` equal to the reference's; the roofline terms of a
record (H100 constants); a smoke cell on a fake (2, 4) mesh whose local
parameter bytes equal those the JAX plan's specs imply, whose record has
the reference's keys and whose calibrated totals equal its full counts;
``hloprof``'s summary; and the counterpart of the reference's
``TestHostMeshExecution``: deepseek-7b smoke's train step on planned
DTensors over a one-rank gloo mesh, its loss within rtol 2e-4 of the JAX
step's, and a two-rank data-sharded step equal to it."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.utils import _pytree as pytree

from repro import configs as jconfigs
from repro.distrib import sharding as jshard
from repro.launch import roofline as jroof
from repro_torch import configs
from repro_torch.launch import dryrun, hloprof, roofline
from repro_torch.launch.mesh import fake_world, make_mesh

from torch_dist_workers import spawn, train_rank
from torch_port_support import jax_params, port_params


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_flops_for(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for name, spec in configs.SHAPES.items():
        assert roofline.model_flops_for(cfg, spec.kind, spec.seq_len, spec.global_batch) == \
            jroof.model_flops_for(jcfg, spec.kind, spec.seq_len, spec.global_batch)


def test_roofline_terms():
    records = [("all-reduce", (1024,), 4096), ("all-gather", (8, 8), 256),
               ("all-reduce", (2,), 8), ("reduce-scatter", (4,), 16)]
    coll = roofline.collective_bytes(records)
    counts = coll.pop("_counts")
    assert counts == {"all-gather": 1, "all-reduce": 2, "reduce-scatter": 1, "all-to-all": 0,
                      "collective-permute": 0}
    assert coll["all-reduce"] == 4104 and roofline.weighted_bytes(coll) == 2 * 4104 + 256 + 16
    t = roofline.RooflineTerms("a", "s", "m", 256, hlo_flops=989e12, hlo_bytes=6.7e12,
                               coll_bytes=45e9, model_flops=494.5e12)
    assert (t.t_compute, t.t_memory, t.t_collective) == (1.0, 2.0, 0.1)
    assert t.dominant == "memory" and t.useful_flops_ratio == 0.5
    assert set(t.as_dict()) == set(jroof.RooflineTerms("a", "s", "m", 1, 0, 0, 0).as_dict())


def _jax_local_bytes(jcfg, amesh, **kw):
    plan = jshard.plan_for(jcfg, amesh, **kw)
    p = jconfigs.params_specs(jcfg)
    total = 0
    for sds, sh in zip(jax.tree_util.tree_leaves(p),
                       jax.tree_util.tree_leaves(plan.params_shardings(p))):
        split = math.prod(jshard.mesh_axis_size(amesh, ax) for ax in sh.spec)
        total += sds.size // split * jnp.dtype(sds.dtype).itemsize
    return total


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "kimi-k2-1t-a32b", "recurrentgemma-2b"])
def test_smoke_cell_local_bytes(arch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = configs.get_config(arch, smoke=True)
    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"))
        for fsdp in (True, False):
            with FakeTensorMode():
                _, (params, *_), plan, spec = dryrun.build_cell(cfg, "train_4k", mesh, fsdp=fsdp)
                got = dryrun.local_bytes(params)
            assert spec.kind == "train" and plan.fsdp == fsdp
            assert got == _jax_local_bytes(jconfigs.get_config(arch, smoke=True),
                                           AbstractMesh((2, 4), ("data", "model")), fsdp=fsdp)


def test_smoke_cell_record():
    """A whole cell on a fake (2, 4) mesh: the reference's record keys, a
    positive roofline, and the 1-unit / 2-unit calibration equal to the
    full run's counts (every layer is counted, and layers are alike)."""
    cfg = configs.get_config("forge-125m", smoke=True).with_(n_layers=3)
    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"))
        rec = dryrun.run_cell("forge-125m", "train_4k", mesh=mesh, cfg=cfg, verbose=False)
    assert rec["status"] == "ok" and rec["kind"] == "train" and rec["fuse"] == "forge"
    for key in ("cell", "fsdp", "seq_shard_cache", "lower_s", "compile_s", "memory", "cost",
                "cost_scan_raw", "calibration", "roofline", "fallbacks"):
        assert key in rec
    r = rec["roofline"]
    assert r["chips"] == 8 and r["hlo_flops"] > 0 and r["hlo_bytes"] > 0 and r["coll_bytes"] > 0
    assert rec["memory"]["total_bytes_per_device"] > rec["memory"]["args_bytes"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    calib = rec["calibration"]
    assert "error" not in calib, calib
    assert calib["flops"] == pytest.approx(r["hlo_flops"], rel=1e-9)
    assert calib["coll_bytes"] == pytest.approx(r["coll_bytes"], rel=1e-9)
    with fake_world(8):
        skipped = dryrun.run_cell("forge-125m", "long_500k", mesh=make_mesh(
            (2, 4), ("data", "model")), cfg=cfg, verbose=False)
    assert skipped["status"] == "skipped"


def test_results_file_roundtrip(tmp_path):
    path = str(tmp_path / "sub" / "dryrun.json")
    dryrun.save_results(path, {"a|b|c": {"status": "ok", "x": (1, 2)}})
    assert dryrun.load_results(path) == {"a|b|c": {"status": "ok", "x": [1, 2]}}
    assert dryrun.load_results(str(tmp_path / "none.json")) == {}


def test_hloprof_summary():
    records = [("all-reduce", (4, 4), 64), ("all-gather", (1024,), 4096),
               ("all-reduce", (), 4), ("all-gather", (8,), 32)]
    assert hloprof.summarize(records) == {"all-reduce": (2, 68.0), "all-gather": (2, 4128.0)}
    top = hloprof.top_collectives(records, 2)
    assert top == [(4096, "all-gather", "1024"), (64, "all-reduce", "4x4")]
    assert hloprof.top_collectives(records, 10)[-1] == (4, "all-reduce", "scalar")


def test_hloprof_main(capsys):
    assert hloprof.main(["--arch", "forge-125m", "--layers", "1", "--top", "3"]) == 0
    out = capsys.readouterr().out
    assert "== forge-125m train_4k layers=1 mesh=16x16 ==" in out
    assert "all-reduce" in out and "-- top 3 by payload --" in out


def _deepseek_case(tmp_path):
    """deepseek-7b smoke in f32: the JAX params through the bridge, a
    seeded (4, 16) batch, and the JAX package's train-step loss."""
    from repro.launch.steps import default_optimizer, make_train_step

    jcfg = jconfigs.get_config("deepseek-7b", smoke=True).with_(dtype="float32")
    jp = jax_params(jcfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab, (4, 16)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (4, 16)).astype(np.int32)
    opt = default_optimizer(jcfg)
    _, _, m = jax.jit(make_train_step(jcfg, opt))(
        jp, opt.init(jp), {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    torch.save(port_params(jp), tmp_path / "params.pt")
    torch.save({"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)},
               tmp_path / "batch.pt")
    return float(m["loss"])


def test_host_mesh_train_step(tmp_path):
    jloss = _deepseek_case(tmp_path)
    args = ("deepseek-7b", str(tmp_path / "params.pt"), str(tmp_path / "batch.pt"))
    one = torch.load(spawn(train_rank, 1, tmp_path / "one", *args) + "/step.pt")
    two = torch.load(spawn(train_rank, 2, tmp_path / "two", *args) + "/step.pt")
    assert np.isfinite(float(one["loss"]))
    np.testing.assert_allclose(float(one["loss"]), jloss, rtol=2e-4)
    assert two["batch_placements"] == "(Shard(dim=0), Replicate())"
    torch.testing.assert_close(two["loss"], one["loss"], rtol=1e-6, atol=1e-6)
    for a, b in zip(pytree.tree_leaves(two["params"]), pytree.tree_leaves(one["params"])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
