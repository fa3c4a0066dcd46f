"""The dry-run cells that once had no end in the port, each at smoke
width, each under its own time limit (a subprocess or spawned ranks):

1. a prefill_32k cell on the (16, 16) fake mesh: the capture's FFN met
   the attention's pending sum, which DTensor reduce-scattered onto the
   sequence (32 rows on 16 data shards), and planned the strided shard
   of the flattened (B, S) by reading its indices through fake tensors,
   one unbacked symbol an index (``layers.apply_ffn`` settles the sum,
   ``sharding._real_strided_offsets`` reads them on real tensors); and
   its FLOPs a layer on a fake (2, 4) mesh against the JAX package's XLA
   count, whose ``lax.map`` over query chunks counts one chunk;
2. the sLSTM loop's backward op: on gloo ranks over (1, 2) and (2, 1)
   meshes its gradients equal plain autograd's and ``jax.grad`` of the
   JAX block's, each device running the loop on its rows;
3. xlstm-350m's decode on the planned cache (the mLSTM memory sharded on
   ``dv`` over ``model``) gives the unplanned decode's tokens and logits;
4. seamless-m4t-large-v2's prefill_32k cell (at smoke width the
   decoder's cross-attention splits 4 heads on 16 shards: the capture
   must see the compiled body's layout there, ``attention`` settles);
5. a pod2x16x16 cell (512 fake ranks: the loss's reductions over the
   vocab and AdamW's update leaf by leaf).
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
from repro.models import xlstm as jax_xlstm
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import xlstm

from torch_dist_workers import slstm_grad_rank, spawn_all, xlstm_decode_rank
from torch_port_support import TOL_F32, jax_params, port_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the port's FLOPs a layer a device against the reference's (as in
#: ``test_torch_tp.py``)
REF_FACTOR = 1.5
#: seconds a cell's subprocess may take
CELL_LIMIT = 120

_PORT_CELL = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
arch, shape, multi_pod, layers = sys.argv[1], sys.argv[2], sys.argv[3] == "1", int(sys.argv[4])
cfg = dryrun._with_layers(get_config(arch, smoke=True), layers)
rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod, cfg=cfg, calibrate=False, verbose=False)
print(json.dumps({k: rec.get(k) for k in ("cell", "status", "roofline", "fallbacks")}))
"""

_PORT_COUNT = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_mesh
cfg = get_config(sys.argv[1], smoke=True)
with fake_world(8):
    mesh = make_mesh((2, 4), ("data", "model"))
    flops = [dryrun._run(dryrun._with_layers(cfg, n), sys.argv[2], mesh, fsdp=False,
                         seq_shard_cache=True)["flops"] for n in (1, 2)]
print(json.dumps({"per_unit": flops[1] - flops[0]}))
"""

_REFERENCE_COUNT = """
import json, sys
import jax
from repro.configs import get_config
from repro.launch import dryrun
cfg = dryrun._with_layers(get_config(sys.argv[1], smoke=True), 2)
mesh = jax.make_mesh((2, 4), ("data", "model"))
print(json.dumps(dryrun.calibrated_totals(cfg, sys.argv[2], mesh, fsdp=False,
                                          seq_shard_cache=True)))
"""

CELLS = {
    "deepseek-prefill": ("deepseek-7b", "prefill_32k", False, 1),
    "seamless-prefill": ("seamless-m4t-large-v2", "prefill_32k", False, 1),
    "qwen-train-multipod": ("qwen2.5-14b", "train_4k", True, 1),
}


def _start(script, *args, jax_devices=False):
    env = dict(os.environ, PYTHONPATH="src")
    if jax_devices:
        env.update(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   JAX_PLATFORMS=os.environ.get("JAX_PLATFORMS", "cpu"))
    return subprocess.Popen([sys.executable, "-c", script, *map(str, args)], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _result(proc):
    try:
        out, err = proc.communicate(timeout=CELL_LIMIT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"no end in {CELL_LIMIT} s: {proc.args[3:]}")
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cells():
    """Every subprocess started at once; their records by name."""
    procs = {name: _start(_PORT_CELL, arch, shape, int(mp), layers)
             for name, (arch, shape, mp, layers) in CELLS.items()}
    procs["port-count"] = _start(_PORT_COUNT, "deepseek-7b", "prefill_32k")
    procs["reference-count"] = _start(_REFERENCE_COUNT, "deepseek-7b", "prefill_32k",
                                      jax_devices=True)
    try:
        return {name: _result(p) for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.mark.parametrize("name", list(CELLS))
def test_cell_ends(cells, name):
    arch, shape, mp, _ = CELLS[name]
    rec = cells[name]
    assert rec["cell"] == f"{arch}|{shape}|{'pod2x16x16' if mp else 'pod16x16'}"
    assert rec["status"] == "ok"
    r = rec["roofline"]
    assert r["chips"] == (512 if mp else 256)
    assert r["hlo_flops"] > 0 and r["hlo_bytes"] > 0 and r["bytes_per_device"] > 0


def test_prefill_flops_a_layer_against_reference(cells):
    """deepseek-7b smoke prefill_32k on (2, 4): B 16, 1 of 4 heads of 16
    a device, S = 32768.  XLA's cost analysis counts the body of the
    reference's ``lax.map`` over 32 query chunks of 1024 once, so its
    count holds one chunk's attention products (4 B H c S D); the port
    counts the whole flash attention.  The reference's count with the
    other 31 chunks added is held against the port's."""
    cfg = get_config("deepseek-7b", smoke=True)
    chunks, chunk = 32768 // 1024, 1024
    B, H, D = 32 // 2, cfg.n_heads // 4, cfg.d_model // cfg.n_heads
    ref = cells["reference-count"]["per_unit"]["flops"] + (chunks - 1) * 4 * B * H * chunk * 32768 * D
    port = cells["port-count"]["per_unit"]
    assert ref / REF_FACTOR <= port <= ref * REF_FACTOR, (port, ref)


# --------------------------------------------------------------------------
# the sLSTM backward op and the planned xLSTM decode on gloo ranks
# --------------------------------------------------------------------------

B, S = 4, 8
SLSTM_LAYER = 2  # smoke: slstm_every = 3


def _jcfg():
    return jax_get_config("xlstm-350m", smoke=True).with_(dtype="float32")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two spawned jobs (sLSTM gradients on (1, 2) and (2, 1), the
    planned decode on (1, 2)), and meanwhile the unplanned port runs and
    the JAX package's."""
    d = tmp_path_factory.mktemp("cells")
    jcfg = _jcfg()
    jp = jax_params(jcfg)
    torch.save(port_params(jp), d / "params.pt")
    rng = np.random.default_rng(0)
    data = {"x": rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32),
            "cot": rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)}
    torch.save({k: torch.from_numpy(v) for k, v in data.items()}, d / "data.pt")
    first = torch.from_numpy(rng.integers(0, jcfg.vocab, (B, 1))).long()
    torch.save(first, d / "token.pt")
    refs = {}

    def unplanned_and_jax():
        cfg = get_config("xlstm-350m", smoke=True).with_(dtype="float32")
        p = port_params(jp)
        block = p["blocks"][SLSTM_LAYER]
        leaves, spec = pytree.tree_flatten(block)
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        x, cot = (torch.from_numpy(data[k]) for k in ("x", "cot"))
        x.requires_grad_(True)
        y = xlstm.slstm_block_apply(pytree.tree_unflatten(leaves, spec), x, cfg)
        grads = torch.autograd.grad((y * cot).sum(), leaves + [x])
        refs["port"] = {"params": pytree.tree_unflatten(list(grads[:-1]), spec), "x": grads[-1]}

        def loss(bp, bx):
            return jnp.sum(jax_xlstm.slstm_block_apply(bp, bx, jcfg) * data["cot"])

        jg, jx = jax.grad(loss, argnums=(0, 1))(jp["blocks"][SLSTM_LAYER], jnp.asarray(data["x"]))
        refs["jax"] = {"params": {k: torch.from_numpy(np.array(v)) if not isinstance(v, dict)
                                  else {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
                                  for k, v in jg.items()},
                       "x": torch.from_numpy(np.array(jx))}
        step = make_serve_step(cfg, logits=True)
        cache = xlstm.init_cache(cfg, B, device="cpu")
        token, tokens, logits = first, [], []
        with torch.no_grad():
            for t in range(4):
                token, cache, last = step(p, cache, token, t)
                token = token.long()
                tokens.append(token)
                logits.append(last)
        refs["unplanned_decode"] = {"tokens": tokens, "logits": logits}

    params = str(d / "params.pt")
    grads_dir, decode_dir = spawn_all(
        [(slstm_grad_rank, 2, d / "slstm", [(1, 2), (2, 1)], params, str(d / "data.pt")),
         (xlstm_decode_rank, 2, d / "decode", params, str(d / "token.pt"), 4)],
        timeout=120, meanwhile=unplanned_and_jax)
    return {"slstm": torch.load(os.path.join(grads_dir, "slstm.pt")),
            "decode": torch.load(os.path.join(decode_dir, "decode.pt")), **refs}


def _close(got, want, what):
    torch.testing.assert_close(got, want, **TOL_F32, msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("against", ["port", "jax"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 1)], ids=["1x2", "2x1"])
def test_slstm_backward_gradients(ranks, shape, against):
    got, want = ranks["slstm"][shape], ranks[against]
    _close(got["x"], want["x"], "d x")
    flat = dict(pytree.tree_flatten_with_path(want["params"])[0])
    mine = pytree.tree_flatten_with_path(got["params"])[0]
    assert len(mine) == len(flat) == 4
    for path, g in mine:
        _close(g, flat[path], f"d {pytree.keystr(path)}")


def test_slstm_backward_runs_on_local_rows(ranks):
    """The loop's backward op ran once on each device's rows: all B rows
    on (1, 2) (rows are not split over ``model``), B / 2 on (2, 1), where
    the recurrent weight's gradient is a pending sum over the two."""
    hd = get_config("xlstm-350m", smoke=True).d_model // 4
    for shape, rows in (((1, 2), B), ((2, 1), B // 2)):
        got = ranks["slstm"][shape]
        assert got["fallbacks"] == []
        (shapes,) = got["backward_shapes"]
        assert shapes[0] == (rows, S, 4, 4 * hd) and shapes[1] == (4, hd, 4 * hd)


def test_planned_xlstm_decode(ranks):
    """4 greedy steps of xlstm-350m smoke (B 4, 4 heads of dv 32) on a
    (1, 2) mesh, the cache placed as the plan says (``C`` on ``dv``),
    against the unplanned decode."""
    got, want = ranks["decode"], ranks["unplanned_decode"]
    assert got["C_placements"] == "(Replicate(), Shard(dim=2))"
    assert got["fallbacks"] == []
    for t, (a, b) in enumerate(zip(got["tokens"], want["tokens"])):
        assert torch.equal(a, b), t
    for t, (a, b) in enumerate(zip(got["logits"], want["logits"])):
        _close(a, b, f"logits step {t}")
