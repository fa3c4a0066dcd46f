"""Parity of the port's assigned input shapes (``repro_torch.configs.shapes``)
with the JAX package's: every arch × shape's ``input_specs``, each
family's ``cache_specs`` and every arch's ``params_specs`` (the port's
per-layer lists against the reference's layer-stacked leaves) have the
reference's shapes and dtypes, and ``shape_applicable`` gives the
reference's verdicts.  The port's stand-ins are meta tensors."""
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils import _pytree as pytree

from repro import configs as jconfigs
from repro_torch import configs
from repro_torch.distrib.sharding import keystr

ARCHS = configs.ARCH_IDS
SHAPES = list(configs.SHAPES)


def _torch_leaves(tree):
    return {keystr(kp): (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for kp, t in pytree.tree_flatten_with_path(tree)[0]}


def _jax_leaves(tree):
    return {jax.tree_util.keystr(kp): (tuple(s.shape), jnp.dtype(s.dtype).name)
            for kp, s in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _unstacked(tree):
    """The reference's tree with its layer-stacked dicts as per-layer lists
    (the port's layout; ``repro_torch.bridge.params_from_numpy``)."""
    out = {}
    for k, v in tree.items():
        if k in ("blocks", "enc_blocks", "dec_blocks") and isinstance(v, dict):
            n = jax.tree_util.tree_leaves(v)[0].shape[0]
            out[k] = [jax.tree_util.tree_map(
                lambda s: jax.ShapeDtypeStruct(s.shape[1:], s.dtype), v) for _ in range(n)]
        else:
            out[k] = v
    return out


def test_tables_equal():
    assert configs.SUBQUADRATIC == jconfigs.SUBQUADRATIC
    assert configs.shapes.VLM_N_PATCHES == jconfigs.shapes.VLM_N_PATCHES
    assert {k: (s.name, s.seq_len, s.global_batch, s.kind) for k, s in configs.SHAPES.items()} \
        == {k: (s.name, s.seq_len, s.global_batch, s.kind) for k, s in jconfigs.SHAPES.items()}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs(arch, shape):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert configs.shape_applicable(cfg, shape) == jconfigs.shape_applicable(jcfg, shape)
    got = configs.input_specs(cfg, shape)
    assert all(t.device.type == "meta" for t in pytree.tree_leaves(got))
    assert _torch_leaves(got) == _jax_leaves(jconfigs.input_specs(jcfg, shape))
    small = configs.input_specs(cfg, shape, seq_len=64, global_batch=2)
    assert _torch_leaves(small) == _jax_leaves(
        jconfigs.input_specs(jcfg, shape, seq_len=64, global_batch=2))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs(arch):
    cfg, jcfg = configs.get_config(arch, smoke=True), jconfigs.get_config(arch, smoke=True)
    for batch, max_len in ((2, 16), (3, 40)):
        assert _torch_leaves(configs.cache_specs(cfg, batch, max_len)) == \
            _jax_leaves(jconfigs.cache_specs(jcfg, batch, max_len))


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_params_specs(arch, smoke):
    cfg, jcfg = configs.get_config(arch, smoke=smoke), jconfigs.get_config(arch, smoke=smoke)
    got = configs.params_specs(cfg)
    assert all(t.device.type == "meta" for t in pytree.tree_leaves(got))
    assert _torch_leaves(got) == _jax_leaves(_unstacked(jconfigs.params_specs(jcfg)))


def test_smoke_names_applicable():
    for arch in ARCHS:
        for shape in SHAPES:
            cfg = configs.get_config(arch, smoke=True)
            jcfg = jconfigs.get_config(arch, smoke=True)
            assert configs.shape_applicable(cfg, shape) == jconfigs.shape_applicable(jcfg, shape)
    assert configs.shape_applicable(configs.get_config("xlstm-350m"), "long_500k") == (True, "")
    assert not configs.shape_applicable(configs.get_config("forge-125m"), "long_500k")[0]
    t = configs.shapes.sds((2, 3), torch.bfloat16)
    assert t.device.type == "meta" and tuple(t.shape) == (2, 3) and t.dtype == torch.bfloat16
