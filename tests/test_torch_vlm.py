"""The VLM backbone (qwen2-vl-72b smoke, f32, the JAX package's
parameters) in the port, against the JAX package:

* ``mrope_tables``, ``text_mrope_positions`` and the stub frontend
  ``merge_patches`` equal to the JAX functions; the two behaviours of the
  reference pinned: text positions restart at 1 after the patches, and
  decode broadcasts its one position to the three streams;
* ``apply`` with 4 patch embeddings, ``apply`` on text and
  ``decode_step`` logits within rtol 2e-4 / atol 2e-5;
* the Forge-compiled block bodies fuse the same nodes as the JAX
  compiler's (``forge.swiglu`` among them);
* greedy tokens of the interpret and the jit server equal to the JAX
  ``mode="jit"`` server's, and of the forge fronts (lockstep decode
  program, sequential prefill) equal to the JAX ``mode="forge"``
  (interpret) server's;
* the VLM has no slot-level decode: the slot scheduler, the slot step and
  the paged server refuse it as the JAX package does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import ForgeCompiler as JaxForgeCompiler
from repro.core import PipelineConfig as JaxPipelineConfig
from repro.launch.serve import BatchedServer as JaxBatchedServer
from repro.models import layers as jax_L
from repro.models import transformer as jax_T
from repro.models import vlm as jax_vlm
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import ForgeCompiler
from repro_torch.launch import serve
from repro_torch.launch.serve import BatchedServer, SlotScheduler
from repro_torch.launch.steps import make_slot_serve_step, supports_slot_decode
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import vlm

from torch_port_support import TOL_F32, as_np, jax_params, port_params

ARCH = "qwen2-vl-72b"
MAX_LEN = 32


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config(ARCH, smoke=True).with_(dtype="float32")
    jcfg = jax_get_config(ARCH, smoke=True).with_(dtype="float32")
    jp = jax_params(jcfg)
    return cfg, jcfg, jp, port_params(jp)


def test_config_registered():
    assert ARCH in ARCH_IDS
    for smoke in (False, True):
        cfg, jcfg = get_config(ARCH, smoke=smoke), jax_get_config(ARCH, smoke=smoke)
        assert cfg.family == "vlm" and cfg == type(cfg)(**{
            f: getattr(jcfg, f) for f in cfg.__dataclass_fields__})
    full = get_config(ARCH)
    assert (full.d_model, full.n_heads, full.n_kv_heads, full.d_ff, full.vocab) == (
        8192, 64, 8, 29568, 152064)
    assert full.mrope_sections == (16, 24, 24) and full.qkv_bias
    assert get_model(full).module is vlm


@pytest.mark.parametrize("sections,hd", [((4, 2, 2), 16), ((16, 24, 24), 128)])
def test_mrope_tables_match_jax(sections, hd):
    pos = np.random.default_rng(3).integers(0, 300, (3, 2, 7)).astype(np.int32)
    cos, sin = L.mrope_tables(torch.from_numpy(pos), hd, sections, 1e6)
    jcos, jsin = jax_L.mrope_tables(jnp.asarray(pos), hd, sections, 1e6)
    assert tuple(cos.shape) == (2, 7, hd // 2)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), **TOL_F32)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), **TOL_F32)


def test_positions_and_merge_match_jax(setup):
    cfg, _, jp, p = setup
    np.testing.assert_array_equal(vlm.text_mrope_positions(2, 5, 3).numpy(),
                                  np.asarray(jax_vlm.text_mrope_positions(2, 5, 3)))
    toks, patches = _tokens((2, 6), 1), _normal((2, 5, cfg.d_model), 2)
    x, pos = vlm.merge_patches(p, torch.from_numpy(toks).long(), torch.from_numpy(patches))
    jx, jpos = jax_vlm.merge_patches(jp, jnp.asarray(toks), jnp.asarray(patches))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    assert pos.dtype == torch.int32 and tuple(pos.shape) == (3, 2, 11)
    # 5 patches on a grid of side 2 at time 0; text restarts at 1 in
    # every stream
    assert pos[:, 0].tolist() == [[0] * 5 + [1, 2, 3, 4, 5, 6],
                                  [0, 0, 1, 1, 2] + [1, 2, 3, 4, 5, 6],
                                  [0, 1, 0, 1, 0] + [1, 2, 3, 4, 5, 6]]


@pytest.mark.parametrize("patches", [4, 0])
def test_apply_logits_match_jax(setup, patches):
    cfg, jcfg, jp, p = setup
    toks = _tokens((2, 8), 1)
    if patches:
        pe = _normal((2, patches, cfg.d_model), 5)
        got = vlm.apply(p, torch.from_numpy(toks).long(), cfg, patch_embeds=torch.from_numpy(pe))
        want = jax_vlm.apply(jp, jnp.asarray(toks), jcfg, patch_embeds=jnp.asarray(pe))
    else:
        got = get_model(cfg).apply(p, torch.from_numpy(toks).long(), cfg)
        want = jax_vlm.apply(jp, jnp.asarray(toks), jcfg)
    assert tuple(got.shape) == (2, 8 + patches, cfg.vocab)
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL_F32)


def test_forward_and_eval_steps_match_jax(setup):
    """``steps.make_forward`` / ``make_eval_step`` on the VLM branch (the
    patch embeddings from ``batch["patches"]``) against the JAX package's."""
    from repro.launch import steps as jax_steps
    from repro_torch.launch import steps

    cfg, jcfg, jp, p = setup
    toks, pe = _tokens((2, 8), 1), _normal((2, 4, cfg.d_model), 5)
    labels = _tokens((2, 12), 6)
    batch = {"tokens": torch.from_numpy(toks).long(), "patches": torch.from_numpy(pe),
             "labels": torch.from_numpy(labels).long()}
    jbatch = {"tokens": jnp.asarray(toks), "patches": jnp.asarray(pe),
              "labels": jnp.asarray(labels)}
    np.testing.assert_allclose(as_np(steps.make_forward(cfg)(p, batch)),
                               as_np(jax_steps.make_forward(jcfg)(jp, jbatch)), **TOL_F32)
    got, want = steps.make_eval_step(cfg)(p, batch), jax_steps.make_eval_step(jcfg)(jp, jbatch)
    for k in ("loss", "ppl"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), **TOL_F32)


def test_decode_steps_match_jax(setup):
    cfg, jcfg, jp, p = setup
    cache, jcache = vlm.init_cache(cfg, 2, 16, device="cpu"), jax_vlm.init_cache(jcfg, 2, 16)
    toks = _tokens((2, 4), 2)
    for i in range(4):
        logits, cache = vlm.decode_step(p, cache, torch.from_numpy(toks[:, i:i + 1]).long(),
                                        i, cfg)
        jlogits, jcache = jax_vlm.decode_step(jp, jcache, jnp.asarray(toks[:, i:i + 1]),
                                              jnp.asarray(i, jnp.int32), jcfg)
        np.testing.assert_allclose(as_np(logits), as_np(jlogits), **TOL_F32)
    # one position broadcast to the three streams: the M-RoPE tables of a
    # text token are the plain RoPE tables
    mpos = torch.full((3, 2, 1), 3, dtype=torch.int32)
    for a, b in zip(T._rope_for(cfg, None, mpos), T._rope_for(cfg, L.decode_positions(
            torch.tensor(3)))):
        np.testing.assert_allclose(a.numpy(), b.expand(a.shape).numpy(), rtol=1e-6, atol=1e-6)


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


@pytest.mark.parametrize("mode", ["apply", "decode"])
def test_block_fusions_match_jax(setup, mode):
    cfg, jcfg, jp, p = setup
    B, S = 2, 8
    x = _normal((B, S if mode == "apply" else 1, cfg.d_model), 2)
    one = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])
    if mode == "apply":
        mpos = np.asarray(jax_vlm.merge_patches(jp, jnp.zeros((B, 4), jnp.int32),
                                                jnp.zeros((B, 4, cfg.d_model)))[1])
        cos, sin = T._rope_for(cfg, None, torch.from_numpy(mpos))
        jcos, jsin = jax_T._rope_for(jcfg, None, jnp.asarray(mpos))
        fn, jfn = T.block_apply, jax_T.block_apply
        args = (p["blocks"][0], torch.from_numpy(x), cos, sin)
        jargs = (one, jnp.asarray(x), jcos, jsin)
    else:
        kc = _normal((B, cfg.n_kv_heads, 16, cfg.head_dim_), 3)
        mpos = np.full((3, B, 1), 3, np.int32)
        cos, sin = T._rope_for(cfg, None, torch.from_numpy(mpos))
        jcos, jsin = jax_T._rope_for(jcfg, None, jnp.asarray(mpos))
        fn, jfn = T.block_decode, jax_T.block_decode
        args = (p["blocks"][0], torch.from_numpy(x), torch.from_numpy(kc),
                torch.from_numpy(kc.copy()), torch.tensor(3), cos, sin)
        jargs = (one, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(kc),
                 jnp.asarray(3, jnp.int32), jcos, jsin)
    mod = ForgeCompiler().compile(lambda *a: fn(*a, cfg=cfg), *args)
    jmod = JaxForgeCompiler(JaxPipelineConfig()).compile(lambda *a: jfn(*a, cfg=jcfg), *jargs)
    got = _summary([n for n in mod.graph.nodes.values() if n.is_fused])
    assert got == _summary([n for n in jmod.graph.nodes.values()
                            if n.op.startswith("forge.")])
    assert ("forge.swiglu",) in got
    outs = mod(*args)
    want = fn(*args, cfg=cfg)
    for a, b in zip(*(o if isinstance(o, tuple) else (o,) for o in (outs, want))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_tokens(setup):
    _, jcfg, jp, _ = setup
    prompts = _tokens((3, 6), 0)
    jit = JaxBatchedServer(jcfg, jp, max_len=MAX_LEN, mode="jit").generate(prompts, 4)
    forge = JaxBatchedServer(jcfg, jp, max_len=MAX_LEN, mode="forge",
                             backend="interpret").generate(prompts, 4)
    return np.asarray(jit["tokens"]), np.asarray(forge["tokens"])


@pytest.mark.parametrize("mode", ["interpret", "jit", "forge"])
def test_server_tokens_equal_jax(setup, jax_tokens, mode):
    cfg, _, _, p = setup
    srv = BatchedServer(cfg, p, max_len=MAX_LEN, mode=mode)
    r = srv.generate(_tokens((3, 6), 0), 4)
    assert r["prefill_mode"] == "sequential"
    np.testing.assert_array_equal(r["tokens"], jax_tokens[1 if mode == "forge" else 0])
    if mode == "forge":
        assert srv.prefill_bucketed is None and not srv.slot_capable
        (key,) = srv.bucketed.programs
        assert key.extents == (4,)


def test_slot_paths_refused(setup):
    cfg, _, _, p = setup
    assert not supports_slot_decode(cfg)
    with pytest.raises(ValueError, match="no slot-level decode"):
        make_slot_serve_step(cfg)
    with pytest.raises(ValueError, match="no slot-level decode"):
        SlotScheduler(BatchedServer(cfg, p, max_len=MAX_LEN, mode="forge"), max_slots=2)
    with pytest.raises(ValueError, match="no paged decode path"):
        BatchedServer(cfg, p, max_len=MAX_LEN, mode="forge", paged=True, kv_page_size=8)


def test_cli_vlm_smoke_on_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mode", "forge",
                       "--batch", "2", "--prompt-len", "5", "--gen", "3",
                       "--max-len", "32"]) == 0
    out = capsys.readouterr().out
    assert "qwen2-vl-72b-smoke batch=2 prompt=5" in out and "(prefill=sequential)" in out
