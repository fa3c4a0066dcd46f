"""The port's dense forge-125m (smoke: 2 layers, d 64, vocab 512) against
the JAX package's, with the JAX parameters carried over by the bridge.

f32: logits within rtol 2e-4 / atol 2e-5; bf16: within 3e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro.models import layers as JL
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.models import layers as L

from torch_port_support import TOL_BF16, TOL_F32, as_np, jax_params, port_params


def _setup(dtype):
    cfg = get_config("forge-125m", smoke=True).with_(dtype=dtype)
    jcfg = jax_get_config("forge-125m", smoke=True).with_(dtype=dtype)
    jp = jax_params(jcfg)
    return cfg, jcfg, jp, port_params(jp)


@pytest.fixture(scope="module")
def f32():
    return _setup("float32")


@pytest.fixture(scope="module")
def bf16():
    return _setup("bfloat16")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def _apply_both(setup, B=2, S=12):
    cfg, jcfg, jp, p = setup
    toks = _tokens(cfg, B, S)
    got = get_model(cfg).apply(p, torch.from_numpy(toks).long(), cfg)
    want = jax_get_model(jcfg).apply(jp, jnp.asarray(toks), jcfg)
    return got, want


def _decode_both(setup, steps, per_row=False, slot_mask=None, B=3, max_len=16):
    """Run ``steps`` decode steps in both packages on the same tokens;
    returns the per-step (port, jax) logits and the final caches."""
    cfg, jcfg, jp, p = setup
    tm, jm = get_model(cfg), jax_get_model(jcfg)
    toks = _tokens(cfg, B, steps, seed=1)
    tc = tm.init_cache(cfg, B, max_len, device="cpu")
    jc = jm.init_cache(jcfg, B, max_len)
    out = []
    for i in range(steps):
        if per_row:
            pos = np.array([i, i + 2, i + 5][:B], np.int32)
        else:
            pos = np.asarray(i, np.int32)
        tl, tc = tm.decode_step(p, tc, torch.from_numpy(toks[:, i:i + 1]).long(),
                                torch.from_numpy(pos).long(), cfg,
                                slot_mask=None if slot_mask is None
                                else torch.from_numpy(slot_mask))
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, i:i + 1]), jnp.asarray(pos),
                                jcfg, slot_mask=None if slot_mask is None
                                else jnp.asarray(slot_mask))
        out.append((tl, jl))
    return out, tc, jc


class TestF32Parity:
    def test_apply_logits(self, f32):
        got, want = _apply_both(f32)
        assert got.dtype == torch.float32 and tuple(got.shape) == (2, 12, 512)
        np.testing.assert_allclose(as_np(got), as_np(want), **TOL_F32)

    def test_decode_logits_and_cache(self, f32):
        steps, tc, jc = _decode_both(f32, 4)
        for tl, jl in steps:
            np.testing.assert_allclose(as_np(tl), as_np(jl), **TOL_F32)
        np.testing.assert_allclose(as_np(tc["k"]), as_np(jc["k"]), **TOL_F32)
        np.testing.assert_allclose(as_np(tc["v"]), as_np(jc["v"]), **TOL_F32)

    def test_per_row_positions(self, f32):
        steps, tc, jc = _decode_both(f32, 3, per_row=True)
        for tl, jl in steps:
            np.testing.assert_allclose(as_np(tl), as_np(jl), **TOL_F32)
        np.testing.assert_allclose(as_np(tc["k"]), as_np(jc["k"]), **TOL_F32)

    def test_slot_mask_freezes_inactive_rows(self, f32):
        mask = np.array([True, False, True])
        steps, tc, jc = _decode_both(f32, 2, per_row=True, slot_mask=mask)
        assert float(tc["k"][:, 1].abs().max()) == 0.0  # never written
        np.testing.assert_allclose(as_np(tc["k"]), as_np(jc["k"]), **TOL_F32)
        for tl, jl in steps:
            np.testing.assert_allclose(as_np(tl)[mask], as_np(jl)[mask], **TOL_F32)

    def test_decode_replays_apply(self, f32):
        """Sequential decode reproduces the full-sequence forward's logits."""
        cfg, _, _, p = f32
        m = get_model(cfg)
        toks = torch.from_numpy(_tokens(cfg, 2, 6)).long()
        full = m.apply(p, toks, cfg)
        cache = m.init_cache(cfg, 2, 8, device="cpu")
        for i in range(6):
            lg, cache = m.decode_step(p, cache, toks[:, i:i + 1], i, cfg)
            np.testing.assert_allclose(lg[:, 0].numpy(), full[:, i].numpy(), rtol=1e-4,
                                       atol=1e-5)

    def test_configs_sharing_shapes_compile_apart(self, f32):
        """Same name and parameter shapes, different head split: two bodies."""
        cfg, _, _, p = f32
        one_head = cfg.with_(n_heads=1, n_kv_heads=1)
        toks = torch.from_numpy(_tokens(cfg, 2, 5)).long()
        a = get_model(cfg).apply(p, toks, cfg)
        b = get_model(one_head).apply(p, toks, one_head)
        raw = one_head.with_(fuse="none")
        np.testing.assert_allclose(b.numpy(), get_model(raw).apply(p, toks, raw).numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert not np.allclose(a.numpy(), b.numpy())

    def test_forward_and_eval_steps_match_jax(self, f32):
        """``steps.make_forward`` / ``make_eval_step`` on the dense branch
        against the JAX package's, labels with ignored positions."""
        from repro.launch import steps as jax_steps
        from repro_torch.launch import steps

        cfg, jcfg, jp, p = f32
        toks, labels = _tokens(cfg, 2, 12), _tokens(cfg, 2, 12, seed=5)
        labels[1, :4] = -1
        batch = {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long()}
        jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
        np.testing.assert_allclose(as_np(steps.make_forward(cfg)(p, batch)),
                                   as_np(jax_steps.make_forward(jcfg)(jp, jbatch)), **TOL_F32)
        got, want = steps.make_eval_step(cfg)(p, batch), jax_steps.make_eval_step(jcfg)(jp, jbatch)
        for k in ("loss", "ppl"):
            np.testing.assert_allclose(float(got[k]), float(want[k]), **TOL_F32)

    def test_unfused_config_matches(self, f32):
        cfg, _, _, p = f32
        toks = torch.from_numpy(_tokens(cfg, 2, 5)).long()
        fused = get_model(cfg).apply(p, toks, cfg)
        raw_cfg = cfg.with_(fuse="none")
        raw = get_model(raw_cfg).apply(p, toks, raw_cfg)
        np.testing.assert_allclose(fused.numpy(), raw.numpy(), rtol=1e-5, atol=1e-6)


class TestBf16Parity:
    def test_apply_logits(self, bf16):
        got, want = _apply_both(bf16)
        np.testing.assert_allclose(as_np(got), as_np(want), **TOL_BF16)

    def test_decode_logits(self, bf16):
        steps, tc, jc = _decode_both(bf16, 3)
        assert tc["k"].dtype == torch.bfloat16
        for tl, jl in steps:
            np.testing.assert_allclose(as_np(tl), as_np(jl), **TOL_BF16)


class TestLayers:
    def test_layer_norm(self):
        rng = np.random.default_rng(0)
        x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((3, 5, 16), (16,), (16,)))
        got = L.layer_norm(*(torch.from_numpy(a) for a in (x, w, b)))
        np.testing.assert_allclose(got.numpy(), as_np(JL.layer_norm(x, w, b)), **TOL_F32)

    def test_rope(self):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
        pos = np.arange(7, dtype=np.int32)
        cos, sin = L.rope_tables(torch.from_numpy(pos), 16)
        jcos, jsin = JL.rope_tables(jnp.asarray(pos), 16)
        np.testing.assert_allclose(cos.numpy(), as_np(jcos), **TOL_F32)
        got = L.apply_rope(torch.from_numpy(x), cos, sin)
        np.testing.assert_allclose(got.numpy(), as_np(JL.apply_rope(x, jcos, jsin)), **TOL_F32)

    @pytest.mark.parametrize("pos", [np.int32(5), np.array([0, 3, 7], np.int32)])
    def test_decode_length_mask(self, pos):
        got = L.decode_length_mask(torch.from_numpy(np.asarray(pos)).long(), 9)
        want = JL.decode_length_mask(jnp.asarray(pos), 9)
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_slot_gate_is_a_select(self):
        new = torch.full((2, 3), float("nan"))
        old = torch.zeros(2, 3)
        out = L.slot_gate(torch.tensor([False, True]), new, old)
        assert torch.equal(out[0], old[0]) and torch.isnan(out[1]).all()
        assert L.slot_gate(None, new, old) is new


class TestInitAndBridge:
    def test_bridge_layout(self, f32):
        cfg, _, jp, p = f32
        assert isinstance(p["blocks"], list) and len(p["blocks"]) == cfg.n_layers
        assert "lm_head" not in p  # tied: the LM head reads the embedding
        w = np.asarray(jp["blocks"]["attn"]["wq"][1])
        np.testing.assert_array_equal(p["blocks"][1]["attn"]["wq"].numpy(), w)

    def test_bridge_keeps_tie_as_one_tensor(self):
        emb = np.ones((4, 2), np.float32)
        tree = {"embed": emb, "lm_head": emb, "final_norm": {"scale": np.ones(2, np.float32)},
                "blocks": [{"w": np.zeros((2, 2), np.float32)}]}
        p = bridge.params_from_numpy(tree, device="cpu")
        assert p["embed"] is p["lm_head"]

    def test_bridge_bf16(self, bf16):
        _, _, jp, p = bf16
        assert p["embed"].dtype == torch.bfloat16
        np.testing.assert_array_equal(p["embed"].float().numpy(),
                                      np.asarray(jp["embed"], np.float32))

    def test_init_matches_jax_structure_and_scale(self, f32):
        cfg, _, _, p = f32
        g = torch.Generator().manual_seed(0)
        q = get_model(cfg).init(cfg, g, "cpu")
        flat_q = jax.tree_util.tree_flatten_with_path(q)[0]
        flat_p = jax.tree_util.tree_flatten_with_path(p)[0]
        assert [(k, tuple(v.shape), v.dtype) for k, v in flat_q] == \
            [(k, tuple(v.shape), v.dtype) for k, v in flat_p]
        wq = q["blocks"][0]["attn"]["wq"]
        assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.02
        assert abs(float(q["embed"].std()) - 0.02) < 0.002

    def test_init_deterministic(self):
        cfg = get_config("forge-125m", smoke=True)
        a = get_model(cfg).init(cfg, torch.Generator().manual_seed(3), "cpu")
        b = get_model(cfg).init(cfg, torch.Generator().manual_seed(3), "cpu")
        assert torch.equal(a["embed"], b["embed"])
        assert a["embed"].dtype == torch.bfloat16


class TestEntryPointsNeedCuda:
    """Entry points run on CUDA unless the caller asks for the CPU."""

    def _no_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")

    def test_init_raises_without_cuda(self):
        self._no_cuda()
        cfg = get_config("forge-125m", smoke=True)
        with pytest.raises(RuntimeError, match="CUDA"):
            get_model(cfg).init(cfg)

    def test_init_cache_raises_without_cuda(self):
        self._no_cuda()
        cfg = get_config("forge-125m", smoke=True)
        with pytest.raises(RuntimeError, match="CUDA"):
            get_model(cfg).init_cache(cfg, 1, 8)

    def test_bridge_raises_without_cuda(self):
        self._no_cuda()
        with pytest.raises(RuntimeError, match="CUDA"):
            bridge.params_from_numpy({"blocks": []})

    def test_unknown_family_raises(self):
        cfg = get_config("forge-125m", smoke=True).with_(family="rnn")
        with pytest.raises(ValueError, match="unknown family 'rnn'"):
            get_model(cfg)

    def test_serve_cli_refuses_encdec(self):
        from repro_torch.launch import serve

        with pytest.raises(SystemExit, match="use examples/ for enc-dec serving"):
            serve.main(["--arch", "seamless-m4t-large-v2", "--smoke", "--device", "cpu"])
