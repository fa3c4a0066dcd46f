"""Expert parallelism in the port's distributed layer: under a sharding
plan ``moe_ffn`` runs in the GShard layout the JAX package's plan pins
(experts over ``model``, the capacity over the data axes), with the
unplanned routing: the same capacity, the same positions, the same
dropped tokens.

* On spawned gloo ranks (``torch_dist_workers.ep_rank``), meshes (1, 2),
  (2, 1), (2, 2) and (1, 4): phi3.5-moe and kimi-k2 smoke in f32, at the
  config's capacity factor and at one that drops tokens: planned
  ``apply`` logits, the loss and every gradient within the f32 smoke bar
  (rtol 2e-4 / atol 2e-5) of the unplanned port run and of the JAX
  package (``jax.jit``); layer 0's ``moe_ffn`` on a placed input: the
  routing, the kept and dropped entries equal to the unplanned port's
  and the JAX package's, its output and gradients within the bar; each
  rank's expert products on its own experts and share of the capacity.
* The dry run's counter on fake meshes: on (2, 4) and (4, 2) the expert
  ``bmm`` FLOPs a device are 1/8 of the one-device count.
* A plan whose ``model`` axis does not divide E replicates the experts
  and records it in ``plan.fallbacks``.

The JAX package's model runs with ``fuse="none"``: its Forge body cache
keys a body by the config's name and the shapes, not the capacity
factor, so in one process its second capacity factor reuses the first
one's compiled bodies (its raw bodies, which the compiled ones equal at
one factor, are the reference).
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_config as jax_get_config
from repro.launch import steps as jax_steps
from repro.models import get_model as jax_get_model
from repro.models import moe as jax_moe
from repro_torch.configs import get_config, params_specs
from repro_torch.distrib.sharding import plan_for
from repro_torch.launch import steps
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.models import get_model
from repro_torch.models import moe as M

from torch_dist_workers import ep_count_rank, ep_rank, spawn_all
from torch_port_support import TOL_F32, jax_params, port_params

ARCHS = ("phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b")
#: the smoke configs' capacity factor, and one at which tokens drop
FACTORS = (1.25, 0.25)
MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))
CASES = [(a, s, cf) for s in MESHES for a in ARCHS for cf in FACTORS]
B, S = 4, 16
#: the dry-run cells of the FLOPs check and the meshes they run on
COUNT_CELLS = (("phi3.5-moe-42b-a6.6b", "train_4k"), ("phi3.5-moe-42b-a6.6b", "prefill_32k"),
               ("kimi-k2-1t-a32b", "train_4k"))
COUNT_MESHES = ((1, 1), (2, 4), (4, 2))


def _inputs():
    rng = np.random.default_rng(0)
    vocab = get_config(ARCHS[0], smoke=True).vocab
    d = get_config(ARCHS[0], smoke=True).d_model
    assert all(get_config(a, smoke=True).vocab == vocab and get_config(a, smoke=True).d_model == d
               for a in ARCHS)
    batch = {k: rng.integers(0, vocab, (B, S)).astype(np.int32) for k in ("tokens", "labels")}
    ffn = {k: rng.standard_normal((B, S, d)).astype(np.float32) for k in ("x", "cot")}
    return batch, ffn


def _jax_routing(x, jmp, E, k, cf):
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    logits = jnp.einsum("td,de->te", xf, jmp["router"], preferred_element_type=jnp.float32)
    _, idx = jax.lax.top_k(logits, k)
    pos = jax_moe._positions_sort(idx.reshape(-1), E)
    cap = max(1, int(np.ceil(k * xf.shape[0] / E * cf)))
    return np.asarray(idx), np.asarray(pos), cap


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the gloo ranks and the dry run's counts, and computes the
    unplanned port runs and the JAX package's meanwhile."""
    d = tmp_path_factory.mktemp("ep")
    nb, nf = _inputs()
    torch.save({k: torch.from_numpy(v).long() for k, v in nb.items()}, d / "batch.pt")
    torch.save({k: torch.from_numpy(v) for k, v in nf.items()}, d / "ffn.pt")
    setups = {}
    for arch in ARCHS:
        jp = jax_params(jax_get_config(arch, smoke=True).with_(dtype="float32"))
        p = port_params(jp)
        torch.save(p, d / f"{arch}.pt")
        setups[arch] = (jp, p)
    cases = [(a, str(d / f"{a}.pt"), cf) for a in ARCHS for cf in FACTORS]
    refs = {}

    def unplanned_and_jax():
        tb = {k: torch.from_numpy(v).long() for k, v in nb.items()}
        jb = {k: jnp.asarray(v) for k, v in nb.items()}
        for (arch, (jp, p)), cf in [(s, cf) for s in setups.items() for cf in FACTORS]:
            cfg = get_config(arch, smoke=True).with_(dtype="float32", capacity_factor=cf)
            jcfg = jax_get_config(arch, smoke=True).with_(dtype="float32", capacity_factor=cf,
                                                          fuse="none")
            with torch.no_grad():
                logits = get_model(cfg).apply(p, tb["tokens"], cfg)
            loss, grads = steps.loss_and_grads(steps.make_loss_fn(cfg), p, tb)
            jlogits = jax_get_model(jcfg).apply(jp, jb["tokens"], jcfg)
            jloss, jgrads = jax.jit(jax.value_and_grad(jax_steps.make_loss_fn(jcfg)))(jp, jb)
            kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k, capacity_factor=cf)
            mp = p["blocks"][0]["moe"]
            x = torch.from_numpy(nf["x"])
            top_idx, _, pos, keep, _ = M.route(x.reshape(B * S, -1), mp, **kw)
            leaves, spec = pytree.tree_flatten(mp)
            leaves = [t.detach().requires_grad_(True) for t in leaves]
            x = x.detach().requires_grad_(True)
            y = M.moe_ffn(x, pytree.tree_unflatten(leaves, spec), **kw)
            ffn_grads = torch.autograd.grad((y * torch.from_numpy(nf["cot"])).sum(), leaves + [x])
            jmp = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])["moe"]
            jidx, jpos, jcap = _jax_routing(nf["x"], jmp, cfg.n_experts, cfg.top_k, cf)
            jy = jax_moe.moe_ffn(jnp.asarray(nf["x"]), jmp, **kw)
            refs[arch, cf] = {
                "port": (logits, loss, grads),
                "jax": (torch.from_numpy(np.array(jlogits)), torch.tensor(float(jloss)),
                        port_params(jgrads)),
                "ffn": {"top_idx": top_idx, "pos": pos, "keep": keep, "y": y.detach(),
                        "grads": [g for g in ffn_grads]},
                "jax_ffn": {"top_idx": torch.from_numpy(jidx.copy()),
                            "pos": torch.from_numpy(jpos.copy()),
                            "keep": torch.from_numpy(jpos < jcap),
                            "y": torch.from_numpy(np.array(jy))}}

    batch, ffn = str(d / "batch.pt"), str(d / "ffn.pt")
    two, four, count = spawn_all(
        [(ep_rank, 2, d / "two", [((1, 2), cases), ((2, 1), cases)], batch, ffn),
         (ep_rank, 4, d / "four", [((2, 2), cases), ((1, 4), cases)], batch, ffn),
         (ep_count_rank, 1, d / "count", COUNT_CELLS, COUNT_MESHES)],
        timeout=240, meanwhile=unplanned_and_jax)
    planned = {**torch.load(os.path.join(two, "ep.pt")), **torch.load(os.path.join(four, "ep.pt"))}
    return {"planned": planned, "refs": refs,
            "counted": torch.load(os.path.join(count, "counts.pt"))}


def _close(got, want, what):
    torch.testing.assert_close(got, want, **TOL_F32, msg=lambda m: f"{what}: {m}")


def _ids(cases):
    return [f"{a.split('-')[0]}-{s[0]}x{s[1]}-cf{cf}" for a, s, cf in cases]


@pytest.mark.parametrize("arch,shape,cf", CASES, ids=_ids(CASES))
@pytest.mark.parametrize("against", ["port", "jax"])
def test_planned_matches(runs, arch, shape, cf, against):
    got = runs["planned"][(arch, shape, cf)]
    logits, loss, grads = runs["refs"][arch, cf][against]
    _close(got["logits"], logits, "logits")
    _close(got["loss"], loss, "loss")
    want = dict(pytree.tree_flatten_with_path(grads)[0])
    flat = pytree.tree_flatten_with_path(got["grads"])[0]
    assert len(flat) == len(want)
    for path, g in flat:
        _close(g, want[path], f"grad {pytree.keystr(path)}")


@pytest.mark.parametrize("arch,shape,cf", CASES, ids=_ids(CASES))
def test_same_tokens_dropped(runs, arch, shape, cf):
    """Layer 0's FFN on a placed input: the routing, the positions and the
    kept entries are the unplanned port's and the JAX package's exactly;
    the output and the gradients within the bar."""
    got = runs["planned"][(arch, shape, cf)]["ffn"]
    ref, jref = runs["refs"][arch, cf]["ffn"], runs["refs"][arch, cf]["jax_ffn"]
    for key in ("top_idx", "pos", "keep"):
        assert torch.equal(got[key].long(), ref[key].long()), key
        assert torch.equal(got[key].long(), jref[key].long()), key
    assert bool(got["keep"].all()) == (cf > 1)  # at the low factor, tokens drop
    _close(got["y"], ref["y"], "moe_ffn")
    _close(got["y"], jref["y"], "moe_ffn against the JAX package")
    for i, (g, w) in enumerate(zip(got["grads"], ref["grads"])):
        _close(g, w, f"moe_ffn gradient {i}")


@pytest.mark.parametrize("arch,shape", [(a, s) for s in MESHES for a in ARCHS],
                         ids=[f"{a.split('-')[0]}-{s[0]}x{s[1]}" for s in MESHES for a in ARCHS])
def test_each_rank_runs_its_experts(runs, arch, shape):
    """The expert products run on (E / model, C / data, D) local buffers:
    no ``bmm`` holds more experts or more capacity than a device's share
    (the capacity padded up to a multiple of the data axis)."""
    cfg = get_config(arch, smoke=True)
    data, model = shape
    cap = math.ceil(cfg.top_k * B * S / cfg.n_experts * 1.25)
    local = (cfg.n_experts // model, -(-cap // data) * data // data, cfg.d_model)
    seen = runs["planned"][(arch, shape, 1.25)]["bmm_shapes"]
    forward = [(a, b) for a, b in seen if a == local]
    assert forward, sorted(set(seen))
    assert all(a[0] == local[0] and b[0] == local[0] for a, b in seen), sorted(set(seen))
    assert all(local[1] in a or local[1] in b for a, b in seen), sorted(set(seen))
    assert runs["planned"][(arch, shape, 1.25)]["fallbacks"] == []


@pytest.mark.parametrize("arch,cell", [(a, c) for a, c in COUNT_CELLS],
                         ids=[f"{a.split('-')[0]}-{c}" for a, c in COUNT_CELLS])
@pytest.mark.parametrize("shape", COUNT_MESHES[1:], ids=lambda s: f"{s[0]}x{s[1]}")
def test_expert_flops_split_over_the_mesh(runs, arch, cell, shape):
    """The dry run's ``aten::bmm`` FLOPs a device on an 8-device mesh are
    1/8 of one device's within 5%, and the step's peak bytes fall by
    more than half that factor."""
    one = runs["counted"][arch, cell, (1, 1)]
    eight = runs["counted"][arch, cell, shape]
    ratio = eight["flops_by_op"]["aten::bmm"] / one["flops_by_op"]["aten::bmm"]
    assert abs(ratio * 8 - 1) <= 0.05, ratio
    if shape == (2, 4):
        assert eight["peak_bytes"] * 4 <= one["peak_bytes"], (eight["peak_bytes"],
                                                               one["peak_bytes"])


def test_experts_replicated_where_model_does_not_divide_them():
    cfg = get_config(ARCHS[0], smoke=True)  # 4 experts
    with fake_world(8):
        plan = plan_for(cfg, make_mesh((1, 8), ("data", "model")))
        specs = plan.params_shardings(params_specs(cfg))
    assert tuple(specs["blocks"][0]["moe"]["w_gate"].spec)[0] is None
    assert "moe: n_experts 4 % model(8) != 0 -> experts replicated" in plan.fallbacks
    with fake_world(4):
        plan = plan_for(cfg, make_mesh((1, 4), ("data", "model")))
        specs = plan.params_shardings(params_specs(cfg))
    assert tuple(specs["blocks"][0]["moe"]["w_gate"].spec)[0] == "model"
    assert not any(f.startswith("moe:") for f in plan.fallbacks)
