"""Parity of the port's distributed layer (``repro_torch.distrib``) with the
JAX package's: every ``ShardingPlan`` spec, leaf for leaf, for all eleven
configs on (16, 16), (2, 16, 16) and (2, 4) meshes (the JAX side on a
``jax.sharding.AbstractMesh``, the port on a ``DeviceMesh`` over a
``fake`` process group of the same size), with FSDP on and off, both
``moe_fsdp_dim`` settings and ``vocab_fsdp``: params, AdamW and
Adafactor states, batch and cache specs and the ``fallbacks`` log;
``ActivationPolicy.spec_for`` for every kind; ``constrain`` (and the
other planned-call hooks) return plain tensors untouched; the spec ->
placements mapping and the path strings."""
import itertools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard
from torch.utils import _pytree as pytree

from repro import configs as jconfigs
from repro.distrib import actsharding as jact
from repro.distrib import sharding as jshard
from repro.optim import Adafactor as JAdafactor
from repro.optim import AdamW as JAdamW
from repro_torch import configs
from repro_torch.distrib import actsharding, sharding
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.optim import AdafactorState, AdamWState

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
ARCHS = configs.ARCH_IDS


@pytest.fixture(params=list(MESHES))
def meshes(request):
    """(port DeviceMesh over a fake group, JAX AbstractMesh) of one shape."""
    shape, axes = MESHES[request.param]
    n = 1
    for s in shape:
        n *= s
    with fake_world(n):
        yield make_mesh(shape, axes), AbstractMesh(shape, axes)


def _meta(tree):
    """The reference's abstract tree as meta tensors, structure kept (a
    NamedTuple state becomes the port's NamedTuple of the same fields)."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
            return type(x)(conv(v) for v in x)
        if hasattr(x, "_fields"):
            port = {"AdamWState": AdamWState, "AdafactorState": AdafactorState}[type(x).__name__]
            return port(*(conv(v) for v in x))
        return torch.empty(tuple(x.shape), dtype=getattr(torch, jnp.dtype(x.dtype).name),
                           device="meta")
    return conv(tree)


def _port_specs(tree):
    return {sharding.keystr(kp): tuple(s.spec)
            for kp, s in pytree.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, sharding.NamedSharding))[0]}


def _jax_specs(tree):
    return {jax.tree_util.keystr(kp): tuple(s.spec)
            for kp, s in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _norm(spec):
    return tuple(tuple(a) if isinstance(a, list) else a for a in spec)


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_leaf_for_leaf(meshes, arch, fsdp):
    mesh, amesh = meshes
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    j_params = jconfigs.params_specs(jcfg)
    params = _meta(j_params)
    j_adamw = jax.eval_shape(JAdamW().init, j_params)
    j_adafactor = jax.eval_shape(JAdafactor().init, j_params)
    j_batch = jconfigs.input_specs(jcfg, "train_4k")
    j_cache = jconfigs.input_specs(jcfg, "decode_32k")["cache"]
    j_long = jconfigs.input_specs(jcfg, "long_500k")
    for moe_dim, vocab in itertools.product(("contract", "output"), (False, True)):
        kw = dict(fsdp=fsdp, moe_fsdp_dim=moe_dim, vocab_fsdp=vocab)
        jp, tp = jshard.plan_for(jcfg, amesh, **kw), sharding.plan_for(cfg, mesh, **kw)
        assert tp.summary() == jp.summary()
        got = _port_specs(tp.params_shardings(params))
        assert got == _jax_specs(jp.params_shardings(j_params)), (moe_dim, vocab)
        for jstate in (j_adamw, j_adafactor):
            assert _port_specs(tp.opt_state_shardings(_meta(jstate), params)) == \
                _jax_specs(jp.opt_state_shardings(jstate, j_params))
        for j_tree in (j_batch, {"token": j_long["token"]}):
            assert _port_specs(tp.batch_shardings(_meta(j_tree))) == \
                _jax_specs(jp.batch_shardings(j_tree))
        assert _port_specs(tp.cache_shardings(_meta(j_cache))) == \
            _jax_specs(jp.cache_shardings(j_cache))
        assert tuple(tp.scalar_sharding().spec) == tuple(jp.scalar_sharding().spec)
        # the port's plan also records attention's gathered heads (40 heads
        # on a 16-way model axis), which the JAX plan leaves to XLA
        m = sharding.mesh_axis_size(mesh, "model")
        heads = [f for f in tp.fallbacks if f.startswith("attention:")]
        assert [f for f in tp.fallbacks if f not in heads] == jp.fallbacks
        assert heads == ([f"attention: n_heads {cfg.n_heads} % model({m}) != 0 -> heads gathered"]
                         if cfg.n_heads % m else [])
    # the auto FSDP threshold
    assert sharding.plan_for(cfg, mesh).fsdp == jshard.plan_for(jcfg, amesh).fsdp


@pytest.mark.parametrize("arch", ["forge-125m", "qwen2.5-14b", "kimi-k2-1t-a32b",
                                  "seamless-m4t-large-v2", "recurrentgemma-2b"])
def test_port_tree_gets_stacked_specs(arch):
    """The port's per-layer leaves take the reference's stacked leaf's spec
    without its leading layer dim."""
    with fake_world(256):
        mesh, amesh = make_mesh((16, 16), ("data", "model")), AbstractMesh((16, 16),
                                                                          ("data", "model"))
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        got = _port_specs(sharding.plan_for(cfg, mesh, fsdp=True).params_shardings(
            configs.params_specs(cfg)))
        want = _jax_specs(jshard.plan_for(jcfg, amesh, fsdp=True).params_shardings(
            jconfigs.params_specs(jcfg)))
        for path, spec in got.items():
            head, sep, rest = path.partition("]")
            stacked = path
            if head in ("['blocks'", "['enc_blocks'", "['dec_blocks'") and rest.startswith("["):
                layer_idx = rest[1:rest.index("]")]
                stacked = head + sep + rest[len(layer_idx) + 2:]
                if stacked in want and len(want[stacked]) == len(spec) + 1:
                    assert want[stacked][1:] == spec, path
                    continue
            assert want[path] == spec, path


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_safe_pspec_and_helpers(mesh_name):
    shape, axes = MESHES[mesh_name]
    n = 1
    for s in shape:
        n *= s
    amesh = AbstractMesh(shape, axes)
    with fake_world(n):
        mesh = make_mesh(shape, axes)
        assert sharding.dp_axes(mesh) == jshard.dp_axes(amesh)
        for ax in (None, "data", "model", ("data", "model"), sharding.dp_axes(mesh)):
            assert sharding.mesh_axis_size(mesh, ax) == jshard.mesh_axis_size(amesh, ax)
        for dims in ((16, 8), (3, 8), (0, 8), (256, 5120), (1, 40)):
            for spec in (("data", "model"), (("data", "model"), None), ("model", None),
                         (sharding.dp_axes(mesh), "model")):
                log_t, log_j = [], []
                t = sharding.safe_pspec(dims, spec, mesh, log_t, "t")
                j = jshard.safe_pspec(dims, spec, amesh, log_j, "t")
                assert _norm(t) == tuple(j) and log_t == log_j


def test_placements():
    with fake_world(512):
        mesh = make_mesh((2, 16, 16), ("pod", "data", "model"))
        assert sharding.placements((("pod", "data"), None, "model"), mesh) == \
            (Shard(0), Shard(0), Shard(2))
        assert sharding.placements((None, None), mesh) == (Replicate(),) * 3
        assert sharding.placements(("model", ("pod", "data")), mesh) == \
            (Shard(1), Shard(1), Shard(0))
        with pytest.raises(ValueError):
            sharding.placements(("model", "model"), mesh)
    with fake_world(4):
        mesh = make_mesh((4, 1), ("data", "model"))
        # a size-1 mesh dim holds the whole dim
        assert sharding.placements(("data", "model"), mesh) == (Shard(0), Replicate())


def test_keystr_matches_jax():
    tree = {"blocks": [{"attn": {"wq": 1}}, {"attn": {"wq": 2}}], "embed": 3,
            "s": (4, 5)}
    jpaths = [jax.tree_util.keystr(kp) for kp, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    tpaths = [p for p, _ in sharding.flatten_with_paths(tree)[0]]
    assert sorted(tpaths) == sorted(jpaths)
    state = AdamWState(step=0, mu={"a": [1]}, nu={"a": [2]})
    jstate = jax.eval_shape(JAdamW().init, {"a": [jax.ShapeDtypeStruct((2,), jnp.float32)]})
    assert [p for p, _ in sharding.flatten_with_paths(state)[0]] == \
        [jax.tree_util.keystr(kp) for kp, _ in jax.tree_util.tree_flatten_with_path(jstate)[0]]


KINDS = ["heads", "kv", "tokens", "ffn_hidden", "logits", "moe_tokens", "moe_dispatch",
         "unknown"]
SHAPES = [(256, 40, 4096, 128), (256, 8, 4096, 128), (1, 16, 8, 64), (256, 4096, 5120),
          (3, 4096, 152064), (8192, 5120), (384, 640, 7168), (16, 8)]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_activation_policy_spec_for(mesh_name):
    shape, axes = MESHES[mesh_name]
    n = 1
    for s in shape:
        n *= s
    amesh = AbstractMesh(shape, axes)
    with fake_world(n):
        mesh = make_mesh(shape, axes)
        for sp, only in itertools.product((False, True), (None, frozenset({"logits"}))):
            tp = actsharding.ActivationPolicy(mesh=mesh, sequence_parallel=sp, only=only)
            jp = jact.ActivationPolicy(mesh=amesh, sequence_parallel=sp, only=only)
            for kind, shp in itertools.product(KINDS, SHAPES):
                t, j = tp.spec_for(kind, shp), jp.spec_for(kind, shp)
                assert (t is None and j is None) or _norm(t) == tuple(j), (kind, shp)


def test_constrain_is_identity_without_policy():
    x = torch.randn(2, 4, 8, 16)
    assert actsharding.current() is None
    for kind in KINDS:
        assert actsharding.constrain(x, kind) is x
    with actsharding.use_policy(None):
        assert actsharding.constrain(x, "heads") is x
    assert actsharding.gathered(x, 3) is x
    args = (x, {"w": x})
    assert actsharding.settled(args) is args and actsharding.fsdp_gathered(args) is args
    with fake_world(8):
        pol = actsharding.ActivationPolicy(mesh=make_mesh((2, 4), ("data", "model")),
                                           enabled=False)
        with actsharding.use_policy(pol):
            assert actsharding.current() is pol
            assert actsharding.constrain(x, "heads") is x
        assert actsharding.current() is None


def test_constrain_under_policy_redistributes():
    """Under a policy ``constrain`` pins a DTensor to the spec's placements,
    and a body captured under the policy keeps the pin as a node."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import ForgeCompiler, PipelineConfig

    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"))
        sharding.register_kernel_shardings()
        pol = actsharding.ActivationPolicy(mesh=mesh)
        with FakeTensorMode():
            x = sharding.local_stand_in(torch.empty(8, 16, 32), mesh, (Replicate(), Replicate()))
            with actsharding.use_policy(pol):
                y = actsharding.constrain(x, "tokens")
                h = actsharding.constrain(sharding.local_stand_in(
                    torch.empty(8, 4, 16, 8), mesh, (Replicate(), Replicate())), "heads")
        assert y.placements == (Shard(0), Replicate()) and tuple(y.shape) == (8, 16, 32)
        assert h.placements == (Shard(0), Shard(1))

    def body(x):
        return actsharding.constrain(torch.tanh(x), "tokens") * 2.0

    with fake_world(8):
        pol = actsharding.ActivationPolicy(mesh=make_mesh((2, 4), ("data", "model")))
        x = torch.randn(8, 16, 32)
        plain = ForgeCompiler(PipelineConfig()).compile(body, x)
        with actsharding.use_policy(pol):
            pinned = ForgeCompiler(PipelineConfig()).compile(body, x)
        targets = [op.opcode for op in pinned.executor.prog.ops]
        assert any("constrain" in t for t in targets)
        assert not any("constrain" in op.opcode for op in plain.executor.prog.ops)
        torch.testing.assert_close(pinned(x), plain(x), rtol=0, atol=0)
