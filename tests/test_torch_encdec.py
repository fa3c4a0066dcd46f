"""The encoder-decoder family (seamless-m4t-large-v2 smoke: 2 + 2 layers,
d 64, 4 heads of 16, GELU d_ff 128, vocab 512, tied head) in the port,
against the JAX package, in f32 and in bf16, with the JAX parameters
carried over by the bridge and the inputs made with numpy from a seed.
The JAX side runs as ``tests/test_models.py`` runs it (``fuse="forge"``).

* ``bridge`` unstacks ``enc_blocks`` and ``dec_blocks`` and keeps the
  tied embedding one tensor;
* ``encode``, ``apply`` (Forge bodies on and off), ``init_cache``'s cross
  K/V, 6 decode steps (logits and every cache leaf) and greedy tokens;
* the serve step compiled whole by ``ForgeCompiler`` on ``interpret`` and
  ``segment_jit``, bitwise equal to the eager step;
* the encoder and decoder bodies fuse what the JAX compiler fuses (one
  ``forge.sdpa`` per attention), and the compiled step's fused nodes;
* ``make_forward``, ``make_eval_step``, ``make_prefill_step`` and
  ``losses.cross_entropy`` (``ignore_id``) against the JAX package's;
* ``BatchedServer`` refuses the family as the JAX package's does.

f32: logits within rtol 2e-4 / atol 2e-5, states within 1e-5; bf16:
within 3e-2; tokens identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_config as jax_get_config
from repro.core import ForgeCompiler as JaxForgeCompiler
from repro.core import PipelineConfig as JaxPipelineConfig
from repro.launch import steps as jax_steps
from repro.models import encdec as jax_encdec
from repro.models import losses as jax_losses
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import ForgeCompiler
from repro_torch.launch import steps
from repro_torch.launch.serve import BatchedServer
from repro_torch.models import encdec, get_model, losses

from torch_port_support import TOL_BF16, TOL_F32, as_np, jax_params, port_params

ARCH = "seamless-m4t-large-v2"
B, T, S, MAX_LEN, N_STEPS = 2, 12, 7, 16, 6
TOL_STATE_F32 = dict(rtol=1e-5, atol=1e-5)
DTYPES = ["float32", "bfloat16"]


def _tol(dtype, state=False):
    if dtype == "bfloat16":
        return TOL_BF16
    return TOL_STATE_F32 if state else TOL_F32


def _frames(cfg, seed=1, n=T):
    return np.random.default_rng(seed).standard_normal((B, n, cfg.d_model)).astype(np.float32)


def _tokens(shape, seed=2):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


class Setup:
    def __init__(self, dtype):
        self.dtype = dtype
        self.cfg = get_config(ARCH, smoke=True).with_(dtype=dtype)
        self.jcfg = jax_get_config(ARCH, smoke=True).with_(dtype=dtype)
        self.jp = jax_params(self.jcfg)
        self.p = port_params(self.jp)
        frames = _frames(self.cfg)
        self.frames = torch.from_numpy(frames).to(getattr(torch, dtype))
        self.jframes = jnp.asarray(frames).astype(jnp.dtype(dtype))

    def caches(self):
        return (encdec.init_cache(self.p, self.frames, self.cfg, MAX_LEN),
                jax_encdec.init_cache(self.jp, self.jframes, self.jcfg, MAX_LEN))


@pytest.fixture(scope="module", params=DTYPES)
def setup(request):
    return Setup(request.param)


@pytest.fixture(scope="module")
def f32():
    return Setup("float32")


def _assert_tree_close(got, want, tol):
    for k in want:
        np.testing.assert_allclose(as_np(got[k]), as_np(want[k]), **tol, err_msg=k)


def test_config_registered():
    assert ARCH in ARCH_IDS
    for smoke in (False, True):
        cfg, jcfg = get_config(ARCH, smoke=smoke), jax_get_config(ARCH, smoke=smoke)
        assert cfg.family == "encdec" and cfg == type(cfg)(**{
            f: getattr(jcfg, f) for f in cfg.__dataclass_fields__})
    full = get_config(ARCH)
    assert (full.n_enc_layers, full.n_dec_layers, full.d_model, full.n_heads, full.d_ff,
            full.vocab) == (24, 24, 1024, 16, 8192, 256206)
    assert full.ffn == "gelu" and full.ffn_bias and full.tie_embeddings
    assert get_model(full).module is encdec and get_model(full).prefill_step is None


def test_bridge_unstacks_enc_dec_blocks(f32):
    p, jp = f32.p, f32.jp
    assert set(p) == {"enc_blocks", "enc_norm", "dec_blocks", "dec_norm", "embed"}
    assert len(p["enc_blocks"]) == 2 and len(p["dec_blocks"]) == 2
    for key in ("enc_blocks", "dec_blocks"):
        for i, layer in enumerate(p[key]):
            want = jax.tree_util.tree_map(lambda a: np.asarray(a[i]), jp[key])
            for path, leaf in pytree.tree_flatten_with_path(layer)[0]:
                w = want
                for k in path:
                    w = w[k.key]
                np.testing.assert_array_equal(leaf.numpy(), w)
                assert leaf.is_contiguous()
    # the tie: one embedding tensor, read by the head (no lm_head leaf)
    np.testing.assert_array_equal(p["embed"].numpy(), np.asarray(jp["embed"]))
    assert "lm_head" not in p


def test_init_matches_jax_structure(f32):
    cfg = f32.cfg
    q = encdec.init(cfg, torch.Generator().manual_seed(0), "cpu")
    flat_q = pytree.tree_flatten_with_path(q)[0]
    flat_p = pytree.tree_flatten_with_path(f32.p)[0]
    assert sorted((str(k), tuple(v.shape), v.dtype) for k, v in flat_q) == \
        sorted((str(k), tuple(v.shape), v.dtype) for k, v in flat_p)
    wq = q["dec_blocks"][0]["cross_attn"]["wq"]
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.02
    assert abs(float(q["embed"].std()) - 0.02) < 0.002


def test_encode_matches_jax(setup):
    got = encdec.encode(setup.p, setup.frames, setup.cfg)
    want = jax_encdec.encode(setup.jp, setup.jframes, setup.jcfg)
    assert tuple(got.shape) == (B, T, setup.cfg.d_model) and got.dtype == setup.frames.dtype
    np.testing.assert_allclose(as_np(got), as_np(want), **_tol(setup.dtype))


@pytest.mark.parametrize("fuse", ["forge", "none"])
def test_apply_matches_jax(setup, fuse):
    cfg = setup.cfg.with_(fuse=fuse)
    toks = _tokens((B, S))
    got = encdec.apply(setup.p, setup.frames, torch.from_numpy(toks).long(), cfg)
    want = jax_encdec.apply(setup.jp, setup.jframes, jnp.asarray(toks), setup.jcfg)
    assert tuple(got.shape) == (B, S, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(as_np(got), as_np(want), **_tol(setup.dtype))


def test_init_cache_matches_jax(setup):
    cache, jcache = setup.caches()
    n_dec, kvh, hd = 2, setup.cfg.n_kv_heads, setup.cfg.head_dim_
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        "self_k": (n_dec, B, kvh, MAX_LEN, hd), "self_v": (n_dec, B, kvh, MAX_LEN, hd),
        "cross_k": (n_dec, B, kvh, T, hd), "cross_v": (n_dec, B, kvh, T, hd)}
    assert not cache["self_k"].any() and not cache["self_v"].any()
    _assert_tree_close(cache, jcache, _tol(setup.dtype, state=True))


def test_decode_steps_match_jax(setup):
    cache, jcache = setup.caches()
    toks = _tokens((B, N_STEPS), 3)
    for i in range(N_STEPS):
        logits, cache = encdec.decode_step(setup.p, cache, torch.from_numpy(toks[:, i:i + 1]).long(),
                                           torch.tensor(i), setup.cfg)
        jlogits, jcache = jax_encdec.decode_step(setup.jp, jcache, jnp.asarray(toks[:, i:i + 1]),
                                                 jnp.asarray(i, jnp.int32), setup.jcfg)
        assert tuple(logits.shape) == (B, 1, setup.cfg.vocab)
        np.testing.assert_allclose(as_np(logits), as_np(jlogits), **_tol(setup.dtype))
        _assert_tree_close(cache, jcache, _tol(setup.dtype, state=True))
    assert cache["self_k"][:, :, :, N_STEPS:].abs().sum() == 0


def greedy(step, params, cache, prompt, n_new):
    """Greedy decode through a serve step: the prompt replays through the
    step (the family has no prefill step), then ``n_new`` tokens."""
    tok = prompt[:, :1]
    out = []
    for t in range(prompt.shape[1] + n_new - 1):
        nxt, cache = step(params, cache, tok, t)
        if t + 1 < prompt.shape[1]:
            tok = prompt[:, t + 1:t + 2]
        else:
            tok = nxt
            out.append(nxt)
    return out, cache


def test_greedy_tokens_match_jax(setup):
    """Greedy tokens through the serve step against the JAX package's
    (``decode_step`` and an argmax, its ``make_serve_step``): identical
    in f32.  In bf16 the two frameworks round the products differently,
    so a row may part only at a near-tie of the JAX logits (top two
    within the bf16 tolerance), where the port's pick must be within that
    tolerance of the JAX maximum; the tokens before it are identical."""
    cache, jcache = setup.caches()
    prompt = _tokens((B, 3), 4)
    got, _ = greedy(steps.make_serve_step(setup.cfg), setup.p, cache,
                    torch.from_numpy(prompt).long(), 5)
    got = np.concatenate([g.numpy() for g in got], 1)
    jdecode = jax.jit(lambda p, c, tk, t: jax_encdec.decode_step(p, c, tk, t, setup.jcfg))
    jlogits = []

    def jstep(p, c, tk, t):
        logits, c = jdecode(p, c, tk, jnp.asarray(t, jnp.int32))
        jlogits.append(np.asarray(logits[:, -1], np.float32))
        return jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None], c

    want, _ = greedy(jstep, setup.jp, jcache, jnp.asarray(prompt), 5)
    want = np.concatenate([np.asarray(w) for w in want], 1)
    if setup.dtype == "float32":
        np.testing.assert_array_equal(got, want)
        return
    tol = TOL_BF16
    for b in np.flatnonzero((got != want).any(axis=1)):
        j = int(np.flatnonzero(got[b] != want[b])[0])
        row = jlogits[prompt.shape[1] - 1 + j][b]
        top = row.max()
        slack = tol["atol"] + tol["rtol"] * abs(top)
        assert np.sort(row)[-2] >= top - slack, f"row {b} parts at token {j} without a near-tie"
        assert row[got[b, j]] >= top - slack


@pytest.mark.parametrize("backend", ["interpret", "segment_jit"])
def test_compiled_step_bitwise_equal_to_eager(setup, backend):
    """The serve step compiled whole (params static, pos a tensor: export
    freezes a Python int), over 6 steps, bitwise the eager step: tokens,
    logits and every cache leaf."""
    step = steps.make_serve_step(setup.cfg, logits=True)
    cache, _ = setup.caches()
    tok = torch.from_numpy(_tokens((B, 1), 5)).long()
    mod = ForgeCompiler(backend=backend).compile(step, setup.p, cache, tok, torch.tensor(0),
                                                 static_argnums=(0,))
    eager_cache, comp_cache = cache, cache
    for i in range(N_STEPS):
        pos = torch.tensor(i)
        want = step(setup.p, eager_cache, tok, pos)
        got = mod(setup.p, comp_cache, tok, pos)
        for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
            assert torch.equal(g, w)
        eager_cache, comp_cache, tok = want[1], got[1], want[0].long()


def _summary(nodes):
    out = []
    for n in nodes:
        q = n.params
        if n.op == "forge.linear_act":
            out.append((n.op, q["act"], q["has_bias"], q["has_residual"]))
        elif n.op == "forge.sdpa":
            out.append((n.op, q["causal"], q["mask_mode"], q["groups"]))
    return sorted(out, key=repr)


@pytest.mark.parametrize("mode", ["enc", "dec"])
def test_body_fusions_match_jax(f32, mode):
    cfg, jcfg, p, jp = f32.cfg, f32.jcfg, f32.p, f32.jp
    x = np.random.default_rng(6).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    cos, sin = encdec.L.rope_tables(torch.arange(S), cfg.head_dim_, cfg.rope_theta)
    jcos, jsin = (jnp.asarray(c.numpy()) for c in (cos, sin))
    one = jax.tree_util.tree_map(lambda a: a[0], jp[f"{mode}_blocks"])
    if mode == "enc":
        fn, jfn = encdec._enc_block, jax_encdec._enc_block
        args = (p["enc_blocks"][0], torch.from_numpy(x), cos, sin)
        jargs = (one, jnp.asarray(x), jcos, jsin)
    else:
        enc = _frames(cfg, 7)
        fn, jfn = encdec._dec_block, jax_encdec._dec_block
        args = (p["dec_blocks"][0], torch.from_numpy(x), torch.from_numpy(enc), cos, sin)
        jargs = (one, jnp.asarray(x), jnp.asarray(enc), jcos, jsin)
    mod = ForgeCompiler().compile(lambda *a: fn(*a, cfg=cfg), *args)
    jmod = JaxForgeCompiler(JaxPipelineConfig()).compile(lambda *a: jfn(*a, cfg=jcfg), *jargs)
    got = _summary([n for n in mod.graph.nodes.values() if n.is_fused])
    assert got == _summary([n for n in jmod.graph.nodes.values() if n.op.startswith("forge.")])
    sdpa = [g for g in got if g[0] == "forge.sdpa"]
    # one flash dispatch per attention, none masked: the encoder's and the
    # cross-attention non-causal, the decoder's self-attention causal
    assert sorted(sdpa) == sorted([("forge.sdpa", False, "none", 1)] + (
        [("forge.sdpa", True, "none", 1)] if mode == "dec" else []))
    # fc + bias + gelu, down + bias + residual, one output projection with
    # the residual per attention
    assert got.count(("forge.linear_act", "gelu", True, False)) == 1
    assert got.count(("forge.linear_act", None, True, True)) == 1
    assert got.count(("forge.linear_act", None, False, True)) == (1 if mode == "enc" else 2)
    np.testing.assert_allclose(mod(*args).numpy(), fn(*args, cfg=cfg).numpy(), **TOL_STATE_F32)


def test_compiled_step_fused_nodes(f32):
    """The whole decode step: per layer, the self-attention over the cache
    keeps its length mask (plain masked attention), the cross-attention
    against the cached K/V fuses unmasked and non-causal (flash at
    Sq = 1), and four fused linears; the cross K/V stay graph inputs and
    the tied head a plain product."""
    cfg = f32.cfg
    cache, _ = f32.caches()
    mod = ForgeCompiler().compile(steps.make_serve_step(cfg), f32.p, cache,
                                  torch.zeros((B, 1), dtype=torch.long), torch.tensor(0),
                                  static_argnums=(0,))
    got = _summary([n for n in mod.graph.nodes.values() if n.is_fused])
    n_dec = cfg.n_dec_layers
    assert got.count(("forge.sdpa", False, "none", 1)) == n_dec
    assert got.count(("forge.sdpa", False, "add", 1)) == n_dec
    assert got.count(("forge.linear_act", "gelu", True, False)) == n_dec
    assert got.count(("forge.linear_act", None, True, True)) == n_dec
    assert got.count(("forge.linear_act", None, False, True)) == 2 * n_dec
    assert len(got) == 6 * n_dec
    names = mod.input_names
    assert any("cross_k" in n for n in names) and any("cross_v" in n for n in names)


def test_forward_eval_prefill_steps_match_jax(setup):
    cfg, jcfg = setup.cfg, setup.jcfg
    toks = _tokens((B, S), 8)
    labels = _tokens((B, S), 9)
    labels[0, :3] = -1  # ignored positions
    batch = {"frames": setup.frames, "tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    jbatch = {"frames": setup.jframes, "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    logits = steps.make_forward(cfg)(setup.p, batch)
    jlogits = jax_steps.make_forward(jcfg)(setup.jp, jbatch)
    np.testing.assert_allclose(as_np(logits), as_np(jlogits), **_tol(setup.dtype))
    assert torch.equal(steps.make_prefill_step(cfg)(setup.p, batch), logits)
    ev, jev = steps.make_eval_step(cfg)(setup.p, batch), jax_steps.make_eval_step(jcfg)(
        setup.jp, jbatch)
    assert set(ev) == {"loss", "ppl"} and ev["loss"].dtype == torch.float32
    for k in ev:
        np.testing.assert_allclose(float(ev[k]), float(jev[k]), **_tol(setup.dtype))


@pytest.mark.parametrize("ignore_id", [-1, 7])
def test_cross_entropy_matches_jax(ignore_id):
    rng = np.random.default_rng(10)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    labels[0, :2] = ignore_id
    labels[2, 4] = -1  # out of range: a row of zeros in the one-hot, as in JAX
    got = losses.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels).long(),
                               ignore_id=ignore_id)
    want = jax_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), ignore_id=ignore_id)
    np.testing.assert_allclose(float(got), float(want), **TOL_F32)
    np.testing.assert_allclose(float(losses.perplexity(torch.from_numpy(logits),
                                                       torch.from_numpy(labels).long())),
                               float(jax_losses.perplexity(jnp.asarray(logits),
                                                           jnp.asarray(labels))), **TOL_F32)
    # every label ignored: the mean's denominator is clamped to 1
    none = torch.full((3, 5), ignore_id, dtype=torch.long)
    assert float(losses.cross_entropy(torch.from_numpy(logits), none, ignore_id=ignore_id)) == 0.0


def test_server_refuses_encdec(f32):
    srv = BatchedServer(f32.cfg, f32.p, max_len=MAX_LEN, mode="interpret")
    with pytest.raises(NotImplementedError, match="use examples/ for enc-dec serving"):
        srv.generate(_tokens((B, 4)), 2)
