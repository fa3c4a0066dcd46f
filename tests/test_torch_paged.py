"""The port's paged KV path against the JAX package's.

* The paged-attention kernel's plain version against the JAX Pallas
  kernel in interpret mode and against ``paged_sdpa_ref`` on the JAX
  test sweep (f32 within 2e-5, bf16 within 2e-2, the JAX test's
  tolerances); ``gather_pages``; the fully masked row.
* ``paged_decode_step`` / ``paged_prefill_step`` against the JAX
  package's on the same numpy inputs and parameters, for ``kv_kernel``
  "ref" and "pallas" (forge-125m smoke, f32, rtol 2e-4 / atol 2e-5).
* Inside the port: paged decode equals the contiguous ``decode_step``
  bitwise, masked rows leave their pages untouched, and windowed decode
  attention equals the contiguous window path bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.paged_attention import paged_attention as jax_paged_attention
from repro.kernels.ref import gather_pages as jax_gather_pages
from repro.kernels.ref import paged_sdpa_ref as jax_paged_sdpa_ref
from repro.models import get_model as jax_get_model
from repro_torch.configs import get_config
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels.ref import gather_pages, paged_sdpa_ref
from repro_torch.models import get_model
from repro_torch.models.attention import attention, attn_init

from torch_port_support import TOL_F32, as_np, jax_params, port_params


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# the kernel's plain version
# --------------------------------------------------------------------------


def _kernel_case(seed, B, H, KVH, D, ps, MP, window, dtype):
    rng = np.random.default_rng(seed)
    NP = 1 + B * MP
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((NP, ps, KVH, D)).astype(np.float32)
    v = rng.standard_normal((NP, ps, KVH, D)).astype(np.float32)
    pt = np.zeros((B, MP), np.int32)
    for b in range(B):
        pt[b] = 1 + b * MP + rng.permutation(MP)  # non-contiguous
    pos = rng.integers(0, MP * ps, (B,)).astype(np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v)] + [jnp.asarray(pt), jnp.asarray(pos)]
    targs = [_t(a).to(tdt) for a in (q, k, v)] + [_t(pt), _t(pos)]
    return jargs, targs


SWEEP = [  # seed, B, H, KVH, D, ps, MP, window (the JAX kernel test's sweep)
    (0, 2, 4, 4, 8, 8, 4, None),
    (1, 2, 4, 2, 8, 8, 4, None),
    (2, 3, 6, 2, 16, 4, 6, None),
    (3, 2, 4, 2, 8, 8, 4, 8),
    (4, 1, 8, 8, 32, 16, 2, 16),
]


@pytest.mark.parametrize("seed,B,H,KVH,D,ps,MP,window", SWEEP)
def test_plain_matches_jax_kernel_f32(seed, B, H, KVH, D, ps, MP, window):
    jargs, targs = _kernel_case(seed, B, H, KVH, D, ps, MP, window, "float32")
    got = PA.paged_attention(*targs, window=window)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, D)
    want = jax_paged_attention(*jargs, window=window, interpret=True)
    np.testing.assert_allclose(as_np(got), np.asarray(want), atol=2e-5, rtol=2e-5)
    ref = jax_paged_sdpa_ref(*jargs, window=window)
    np.testing.assert_allclose(as_np(got), np.asarray(ref), atol=2e-5, rtol=2e-5)
    # impl="ref" runs the same plain version
    torch.testing.assert_close(PA.paged_attention(*targs, window=window, impl="ref"), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("seed,B,H,KVH,D,ps,MP,window", [SWEEP[1], SWEEP[3]])
def test_plain_matches_jax_kernel_bf16(seed, B, H, KVH, D, ps, MP, window):
    jargs, targs = _kernel_case(seed, B, H, KVH, D, ps, MP, window, "bfloat16")
    got = PA.paged_attention(*targs, window=window)
    assert got.dtype == torch.bfloat16
    want = jax_paged_attention(*jargs, window=window, interpret=True)
    np.testing.assert_allclose(as_np(got), np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


def test_port_paged_sdpa_ref_matches_jax():
    jargs, targs = _kernel_case(7, 3, 6, 2, 16, 4, 6, None, "float32")
    for window in (None, 5):
        np.testing.assert_allclose(as_np(paged_sdpa_ref(*targs, window=window)),
                                   np.asarray(jax_paged_sdpa_ref(*jargs, window=window)),
                                   **TOL_F32)


def test_gather_pages_reconstructs_contiguous_layout():
    rng = np.random.default_rng(6)
    B, KVH, D, ps, MP = 2, 2, 4, 4, 3
    NP = 1 + B * MP
    pages = rng.standard_normal((NP, ps, KVH, D)).astype(np.float32)
    pt = np.zeros((B, MP), np.int32)
    for b in range(B):
        pt[b] = 1 + b * MP + rng.permutation(MP)
    view = gather_pages(_t(pages), _t(pt)).numpy()
    assert view.shape == (B, KVH, MP * ps, D)
    for b in range(B):
        expect = pages[pt[b]].reshape(MP * ps, KVH, D)
        np.testing.assert_array_equal(view[b], expect.transpose(1, 0, 2))
    np.testing.assert_array_equal(view, np.asarray(jax_gather_pages(jnp.asarray(pages),
                                                                    jnp.asarray(pt))))


def test_fully_masked_row_yields_zeros_not_nan():
    """pos = -1 keeps every key masked: zeros (the kernel's l == 0 guard),
    as the JAX kernel gives in interpret mode."""
    B, H, KVH, D, ps, MP = 2, 2, 2, 8, 4, 2
    q = np.ones((B, H, D), np.float32)
    k = np.ones((1 + 2 * MP, ps, KVH, D), np.float32)
    v = np.ones((1 + 2 * MP, ps, KVH, D), np.float32)
    pt = np.asarray([[1, 2], [3, 4]], np.int32)
    pos = np.asarray([-1, 3], np.int32)
    got = PA.paged_attention(_t(q), _t(k), _t(v), _t(pt), _t(pos)).numpy()
    assert np.all(np.isfinite(got)) and np.all(got[0] == 0.0)
    np.testing.assert_allclose(got[1], 1.0)
    want = np.asarray(jax_paged_attention(*map(jnp.asarray, (q, k, v, pt, pos)),
                                          interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_cuda_wrapper_rejects_cpu_tensors():
    jargs, targs = _kernel_case(0, 2, 4, 4, 8, 8, 4, None, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        PA.paged_attention_cuda(*targs)
    with pytest.raises(ValueError):
        PA.paged_attention(*targs, impl="bogus")


# --------------------------------------------------------------------------
# model level: the port's paged steps against the JAX package's
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["mha", "gqa"])
def setup(request):
    """forge-125m smoke in f32; "gqa" halves the KV heads (4 -> 2)."""
    kw = dict(dtype="float32") if request.param == "mha" else dict(dtype="float32",
                                                                   n_kv_heads=2)
    cfg = get_config("forge-125m", smoke=True).with_(**kw)
    jcfg = jax_get_config("forge-125m", smoke=True).with_(**kw)
    jp = jax_params(jcfg)
    return cfg, jcfg, jp, port_params(jp)


B, MAX_LEN, PS = 2, 32, 8
MP = MAX_LEN // PS


def _tables(rng):
    """Non-contiguous, disjoint page runs per row (page 0 stays trash)."""
    perm = 1 + rng.permutation(B * MP)
    return perm.reshape(B, MP).astype(np.int32)


def _paged_caches(setup, cfg, jcfg, pt):
    tc = get_model(cfg).init_paged_cache(cfg, B, MAX_LEN, num_pages=1 + B * MP,
                                         page_size=PS, device="cpu")
    jc = jax_get_model(jcfg).init_paged_cache(jcfg, B, MAX_LEN, num_pages=1 + B * MP,
                                              page_size=PS)
    tc["page_table"] = _t(pt)
    jc["page_table"] = jnp.asarray(pt)
    return tc, jc


@pytest.mark.parametrize("kv_kernel", ["ref", "pallas"])
def test_paged_steps_match_jax(setup, kv_kernel):
    cfg0, jcfg0, jp, p = setup
    cfg, jcfg = cfg0.with_(kv_kernel=kv_kernel), jcfg0.with_(kv_kernel=kv_kernel)
    tm, jm = get_model(cfg), jax_get_model(jcfg)
    rng = np.random.default_rng(3)
    tc, jc = _paged_caches(setup, cfg, jcfg, _tables(rng))
    P = 12
    toks = rng.integers(0, cfg.vocab, (B, P)).astype(np.int32)
    # ragged starts: row 1 prefills at 4 (as a prefix-hit row would)
    pos0 = np.asarray([0, 4], np.int32)
    mask = np.asarray([True, True])
    lt, tc = tm.paged_prefill_step(p, tc, _t(toks), _t(pos0), cfg, slot_mask=_t(mask))
    lj, jc = jm.paged_prefill_step(jp, jc, jnp.asarray(toks), jnp.asarray(pos0), jcfg,
                                   slot_mask=jnp.asarray(mask))
    np.testing.assert_allclose(as_np(lt), np.asarray(lj), **TOL_F32)
    tok = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)[:, None]
    for t in range(3):
        pos = pos0 + P + t
        mask = np.asarray([True, t != 1])  # row 1 idles one step
        lt, tc = tm.paged_decode_step(p, tc, _t(tok), _t(pos), cfg, slot_mask=_t(mask))
        lj, jc = jm.paged_decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos), jcfg,
                                      slot_mask=jnp.asarray(mask))
        np.testing.assert_allclose(as_np(lt)[mask], np.asarray(lj)[mask], **TOL_F32)
        tok = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)[:, None]
    # live pages agree (the trash page is excluded: colliding masked
    # writes land there in an unspecified order)
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(as_np(tc[name])[:, 1:], np.asarray(jc[name])[:, 1:],
                                   **TOL_F32)


def _identity_paged_cache(cfg, batch):
    """Tables mapping row b to the disjoint run 1 + b*MP ...: the
    contiguous layout through the indirection."""
    cache = get_model(cfg).init_paged_cache(cfg, batch, MAX_LEN, num_pages=1 + batch * MP,
                                            page_size=PS, device="cpu")
    cache["page_table"] = (1 + torch.arange(batch * MP, dtype=torch.int32)).view(batch, MP)
    return cache


def test_paged_decode_bitwise_equals_contiguous(setup):
    """Token-at-a-time decode through the paged pool ("ref" attend) is
    bit-identical to the contiguous cache, dense and GQA alike."""
    cfg, _, _, p = setup
    m = get_model(cfg)
    cache = m.init_cache(cfg, B, MAX_LEN, device="cpu")
    pcache = _identity_paged_cache(cfg, B)
    rng = np.random.default_rng(7)
    toks = _t(rng.integers(0, cfg.vocab, (B, 9)).astype(np.int64))
    mask = torch.ones(B, dtype=torch.bool)
    for t in range(9):
        tok = toks[:, t:t + 1]
        pos = torch.full((B,), t, dtype=torch.int64)
        la, cache = m.decode_step(p, cache, tok, pos, cfg, slot_mask=mask)
        lb, pcache = m.paged_decode_step(p, pcache, tok, pos, cfg, slot_mask=mask)
        assert torch.equal(la, lb), f"step {t}"


def test_masked_rows_leave_pages_untouched(setup):
    """slot_mask=False rows write nothing: their writes land on the trash
    page, so every real page of theirs survives bitwise."""
    cfg, _, _, p = setup
    pcache = _identity_paged_cache(cfg, B)
    tok = torch.tensor([[3], [5]], dtype=torch.int32)
    pos = torch.tensor([0, 0], dtype=torch.int32)
    for kv_kernel in ("ref", "pallas"):
        c = cfg.with_(kv_kernel=kv_kernel)
        _, out = get_model(c).paged_decode_step(p, pcache, tok, pos, c,
                                                slot_mask=torch.tensor([True, False]))
        row0, row1 = pcache["page_table"][0].long(), pcache["page_table"][1].long()
        for name in ("k_pages", "v_pages"):
            assert torch.count_nonzero(out[name][:, row1]) == 0, \
                "masked row wrote into its own pages"
            assert torch.count_nonzero(out[name][:, row0[0]]) > 0


def test_window_attention_bitwise():
    """Sliding-window decode through the paged cache equals the contiguous
    window mask path bitwise (attention level), past the window edge."""
    H, KVH, D, ps, window, d_model = 4, 2, 8, 8, 8, 32
    g = torch.Generator().manual_seed(1)
    p = attn_init(g, d_model, H, KVH, D, dtype=torch.float32)
    cache = {"k": torch.zeros(B, KVH, MAX_LEN, D), "v": torch.zeros(B, KVH, MAX_LEN, D)}
    pt = (1 + torch.arange(B * MP, dtype=torch.int32)).view(B, MP)
    store = {"k_pages": torch.zeros(1 + B * MP, ps, KVH, D),
             "v_pages": torch.zeros(1 + B * MP, ps, KVH, D)}
    rng = np.random.default_rng(11)
    mask = torch.ones(B, dtype=torch.bool)
    for t in range(2 * window):
        x = _t(rng.standard_normal((B, 1, d_model)).astype(np.float32))
        pos = torch.full((B,), t, dtype=torch.int32)
        oa, cache = attention(x, p, n_heads=H, n_kv_heads=KVH, window=window, cache=cache,
                              cache_pos=pos)
        ob, store = attention(x, p, n_heads=H, n_kv_heads=KVH, window=window,
                              cache={**store, "page_table": pt}, cache_pos=pos,
                              write_mask=mask)
        assert torch.equal(oa, ob), f"step {t}"
        # the kernel route (plain version here) agrees within f32 tolerance
        oc, _ = attention(x, p, n_heads=H, n_kv_heads=KVH, window=window,
                          cache={**store, "page_table": pt}, cache_pos=pos,
                          write_mask=torch.zeros(B, dtype=torch.bool), kv_kernel="pallas")
        torch.testing.assert_close(oc, oa, **TOL_F32)
