"""The MoE family (phi3.5-moe-42b-a6.6b, kimi-k2-1t-a32b) in the port,
against the JAX package, on the smoke configs in f32 with the JAX
package's parameters:

* ``moe_ffn`` with both position implementations, with token drops
  (``capacity_factor=0.25``) and with kimi's shared expert: the routing
  (``top_idx``, ``pos_in_e``, ``keep``) equal to the JAX package's and
  the output within rtol 2e-4 / atol 2e-5; top-k ties break toward the
  lower index as ``lax.top_k`` does; ``aux_load_balance_loss``;
* ``apply`` and ``decode_step`` logits within rtol 2e-4 / atol 2e-5;
* the Forge-compiled block bodies fuse the same nodes as the JAX
  compiler's: the batched expert SwiGLU (3-D weights) is no
  ``forge.swiglu``, kimi's shared expert is one;
* MoE has no batched prefill: ``prefill_step`` raises and the serve
  fronts take the sequential decode-step prefill.

The serving paths (the three servers and both slot schedulers) are in
``test_torch_moe_serve.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import get_config as jax_get_config
from repro.core import ForgeCompiler as JaxForgeCompiler
from repro.core import PipelineConfig as JaxPipelineConfig
from repro.models import get_model as jax_get_model
from repro.models import moe as jax_moe
from repro.models import transformer as jax_T
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import ForgeCompiler
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

from torch_port_support import TOL_F32, as_np, jax_params, port_params

ARCHS = ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"]


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    cfg = get_config(arch, smoke=True).with_(dtype="float32")
    jcfg = jax_get_config(arch, smoke=True).with_(dtype="float32")
    jp = jax_params(jcfg)
    return cfg, jcfg, jp, port_params(jp)


def test_configs_registered():
    for arch in ARCHS:
        assert arch in ARCH_IDS
        for smoke in (False, True):
            cfg, jcfg = get_config(arch, smoke=smoke), jax_get_config(arch, smoke=smoke)
            assert cfg.family == "moe" and cfg == type(cfg)(**{
                f: getattr(jcfg, f) for f in cfg.__dataclass_fields__})
    k = get_config("kimi-k2-1t-a32b")
    assert (k.n_experts, k.top_k, k.shared_experts, k.head_dim_) == (384, 8, 1, 112)
    p = get_config("phi3.5-moe-42b-a6.6b")
    assert (p.d_model, p.n_experts, p.top_k, p.d_ff, p.vocab) == (4096, 16, 2, 6400, 32064)


def test_bridge_carries_moe_params(setup):
    cfg, _, jp, p = setup
    assert "lm_head" in p and p["lm_head"] is not p["embed"]
    for i, blk in enumerate(p["blocks"]):
        mp = blk["moe"]
        assert "ffn" not in blk and mp["router"].dtype == torch.float32
        assert tuple(mp["w_gate"].shape) == (cfg.n_experts, cfg.d_model, cfg.d_ff)
        assert tuple(mp["w_down"].shape) == (cfg.n_experts, cfg.d_ff, cfg.d_model)
        np.testing.assert_array_equal(mp["w_up"].numpy(),
                                      np.asarray(jp["blocks"]["moe"]["w_up"][i]))
        assert ("shared" in mp) == bool(cfg.shared_experts)
    if cfg.shared_experts:
        assert tuple(p["blocks"][0]["moe"]["shared"]["w_gate"].shape) == (
            cfg.d_model, cfg.shared_d_ff)


def _jax_routing(x, jmp, E, k, cf, impl):
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    logits = jnp.einsum("td,de->te", xf, jmp["router"], preferred_element_type=jnp.float32)
    vals, idx = lax.top_k(logits, k)
    e_flat = idx.reshape(-1)
    pos = (jax_moe._positions_sort if impl == "sort" else jax_moe._positions_onehot)(e_flat, E)
    cap = max(1, int(np.ceil(k * xf.shape[0] / E * cf)))
    return np.asarray(idx), np.asarray(jax.nn.softmax(vals, -1)), np.asarray(pos), cap


@pytest.mark.parametrize("impl", ["sort", "onehot"])
@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_moe_ffn_matches_jax(setup, impl, cf):
    cfg, _, jp, p = setup
    x = _normal((2, 8, cfg.d_model), 4)
    jmp = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])["moe"]
    mp = p["blocks"][0]["moe"]
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k, capacity_factor=cf,
              position_impl=impl)
    top_idx, gates, pos, keep, cap = M.route(torch.from_numpy(x).reshape(16, -1), mp, **kw)
    jidx, jgates, jpos, jcap = _jax_routing(x, jmp, cfg.n_experts, cfg.top_k, cf, impl)
    assert cap == jcap
    np.testing.assert_array_equal(top_idx.numpy(), jidx)
    np.testing.assert_array_equal(pos.numpy(), jpos)
    np.testing.assert_array_equal(keep.numpy(), jpos < jcap)
    np.testing.assert_allclose(gates.numpy(), jgates, **TOL_F32)
    if cf < 1:
        assert not keep.all()  # tokens dropped
    got = M.moe_ffn(torch.from_numpy(x), mp, **kw)
    want = jax_moe.moe_ffn(jnp.asarray(x), jmp, **kw)
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL_F32)
    loss = M.aux_load_balance_loss(torch.from_numpy(x), mp, n_experts=cfg.n_experts,
                                   top_k=cfg.top_k)
    jloss = jax_moe.aux_load_balance_loss(jnp.asarray(x), jmp, n_experts=cfg.n_experts,
                                          top_k=cfg.top_k)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL_F32)


def test_positions_agree_and_top_k_ties():
    rng = np.random.default_rng(7)
    e = rng.integers(0, 6, (40,)).astype(np.int32)
    want = np.asarray(jax_moe._positions_sort(jnp.asarray(e), 6))
    for fn in (M._positions_sort, M._positions_onehot):
        np.testing.assert_array_equal(fn(torch.from_numpy(e).long(), 6).numpy(), want)
    # integer-valued logits: every row has ties
    logits = rng.integers(0, 3, (32, 8)).astype(np.float32)
    vals, idx = M.select_top_k(torch.from_numpy(logits), 3)
    jvals, jidx = lax.top_k(jnp.asarray(logits), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_moe_init_layout():
    g = torch.Generator().manual_seed(0)
    p = M.moe_init(g, 16, 8, 4, shared_experts=1, shared_d_ff=12, dtype=torch.bfloat16)
    assert p["router"].dtype == torch.float32 and tuple(p["router"].shape) == (16, 4)
    assert tuple(p["w_gate"].shape) == (4, 16, 8) and p["w_gate"].dtype == torch.bfloat16
    assert tuple(p["w_down"].shape) == (4, 8, 16)
    assert tuple(p["shared"]["w_up"].shape) == (16, 12)
    jp = jax_moe.moe_init(jax.random.PRNGKey(0), 16, 8, 4, shared_experts=1, shared_d_ff=12)

    def layout(t):
        return {k: layout(v) if isinstance(v, dict)
                else (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in t.items()}

    assert layout(p) == layout(jp)


def test_apply_logits_match_jax(setup):
    cfg, jcfg, jp, p = setup
    toks = _tokens((2, 8), 1)
    got = get_model(cfg).apply(p, torch.from_numpy(toks).long(), cfg)
    want = jax_get_model(jcfg).apply(jp, jnp.asarray(toks), jcfg)
    assert tuple(got.shape) == (2, 8, cfg.vocab)
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL_F32)


def test_decode_steps_match_jax(setup):
    """Three decode steps from a fresh cache, per-row positions and a
    slot mask on the last: logits and the cache within tolerance."""
    cfg, jcfg, jp, p = setup
    m, jm = get_model(cfg), jax_get_model(jcfg)
    cache, jcache = m.init_cache(cfg, 3, 16, device="cpu"), jm.init_cache(jcfg, 3, 16)
    toks = _tokens((3, 3), 2)
    for i in range(3):
        pos = np.array([i, i + 1, i], np.int32) if i == 2 else np.int32(i)
        mask = np.array([True, False, True]) if i == 2 else None
        logits, cache = m.decode_step(
            p, cache, torch.from_numpy(toks[:, i:i + 1]).long(), torch.as_tensor(pos), cfg,
            slot_mask=None if mask is None else torch.from_numpy(mask))
        jlogits, jcache = jm.decode_step(
            jp, jcache, jnp.asarray(toks[:, i:i + 1]), jnp.asarray(pos), jcfg,
            slot_mask=None if mask is None else jnp.asarray(mask))
        np.testing.assert_allclose(as_np(logits), as_np(jlogits), **TOL_F32)
    np.testing.assert_allclose(as_np(cache["k"]), as_np(jcache["k"]), **TOL_F32)


def test_no_batched_prefill(setup):
    cfg, _, _, p = setup
    m = get_model(cfg)
    assert m.prefill_step is None and m.paged_prefill_step is None
    assert not T.supports_batched_prefill(cfg)
    cache = m.init_cache(cfg, 1, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="sequentially through decode_step"):
        T.prefill_step(p, cache, torch.zeros((1, 4), dtype=torch.long), 0, cfg)
    pc = T.init_paged_cache(cfg, 1, 16, num_pages=3, page_size=8, device="cpu")
    with pytest.raises(NotImplementedError, match="paged_decode_step"):
        T.paged_prefill_step(p, pc, torch.zeros((1, 4), dtype=torch.long), 0, cfg)


def _summary(nodes):
    out = []
    for n in nodes:
        q = n.params
        if n.op == "forge.linear_act":
            out.append((n.op, q["act"], q["has_bias"], q["has_residual"]))
        elif n.op == "forge.sdpa":
            out.append((n.op, q["causal"], q["mask_mode"], q["groups"]))
        elif n.op == "forge.swiglu":
            out.append((n.op,))
    return sorted(out, key=repr)


@pytest.mark.parametrize("mode", ["apply", "decode", "paged_decode"])
def test_block_fusions_match_jax(setup, mode):
    cfg, jcfg, jp, p = setup
    B, S, KVH, D = 2, 8, cfg.n_kv_heads, cfg.head_dim_
    x = _normal((B, S if mode == "apply" else 1, cfg.d_model), 2)
    one = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])
    if mode == "apply":
        cos, sin = T._rope_for(cfg, torch.arange(S))
        jcos, jsin = jax_T._rope_for(jcfg, jnp.arange(S, dtype=jnp.int32), None)
        fn, jfn = T.block_apply, jax_T.block_apply
        args = (p["blocks"][0], torch.from_numpy(x), cos, sin)
        jargs = (one, jnp.asarray(x), jcos, jsin)
    elif mode == "decode":
        kc = _normal((B, KVH, 16, D), 3)
        pos = torch.tensor(3)
        cos, sin = T._rope_for(cfg, L.decode_positions(pos))
        jcos, jsin = jax_T._rope_for(jcfg, jnp.asarray(3, jnp.int32)[None], None)
        fn, jfn = T.block_decode, jax_T.block_decode
        args = (p["blocks"][0], torch.from_numpy(x), torch.from_numpy(kc),
                torch.from_numpy(kc.copy()), pos, cos, sin)
        jargs = (one, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(kc),
                 jnp.asarray(3, jnp.int32), jcos, jsin)
    else:
        kp = _normal((5, 8, KVH, D), 3)
        pt = np.array([[1, 2], [3, 4]], np.int32)
        pos = np.array([3, 9], np.int32)
        mask = np.array([True, True])
        cos, sin = T._rope_for(cfg, L.decode_positions(torch.from_numpy(pos)))
        jcos, jsin = jax_T._rope_for(jcfg, jnp.asarray(pos)[:, None], None)
        fn, jfn = T.block_paged_decode, jax_T.block_paged_decode
        args = (p["blocks"][0], torch.from_numpy(x), torch.from_numpy(kp),
                torch.from_numpy(kp.copy()), torch.from_numpy(pt), torch.from_numpy(pos),
                torch.from_numpy(mask), cos, sin)
        jargs = (one, jnp.asarray(x), jnp.asarray(kp), jnp.asarray(kp), jnp.asarray(pt),
                 jnp.asarray(pos), jnp.asarray(mask), jcos, jsin)
    mod = ForgeCompiler().compile(lambda *a: fn(*a, cfg=cfg), *args)
    jmod = JaxForgeCompiler(JaxPipelineConfig()).compile(lambda *a: jfn(*a, cfg=jcfg), *jargs)
    got = _summary([n for n in mod.graph.nodes.values() if n.is_fused])
    assert got == _summary([n for n in jmod.graph.nodes.values()
                            if n.op.startswith("forge.")])
    # the batched expert SwiGLU stays bmm + silu·mul; the shared one fuses
    assert got.count(("forge.swiglu",)) == (1 if cfg.shared_experts else 0)
    ops = [n.op for n in mod.graph.nodes.values()]
    assert ops.count("aten.bmm.default") == 3
    outs = mod(*args)
    want = fn(*args, cfg=cfg)
    for a, b in zip(*(o if isinstance(o, tuple) else (o,) for o in (outs, want))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
