"""The SwiGLU / GQA dense decoders (deepseek-7b, phi3-mini-3.8b,
qwen1.5-32b, qwen2.5-14b) in the port, against the JAX package, on their
smoke configs in f32 with the JAX package's parameters; both packages
compile through their default ``PipelineConfig`` (all seven passes).

For each config:

* ``apply`` logits within rtol 2e-4 / atol 2e-5 of the JAX ``apply``;
* the Forge-compiled block bodies (``apply`` and decode) fuse the same
  nodes as the JAX compiler's, ``forge.swiglu`` among them;
* greedy tokens equal to the JAX ``mode="jit"`` server's through the
  interpret server, and to the JAX ``mode="forge"`` (interpret) server's
  through the contiguous forge fronts (``segment_jit`` on the CPU);
* a served decode and prefill dispatch under ``segment_jit`` bitwise
  equal to the same lowered program under ``interpret``.

For qwen2.5-14b smoke (GQA 4/2, QKV bias, rope θ 1e6) also the
contiguous and the paged ``SlotScheduler``: every request's tokens, its
ticks and the scheduling metrics equal to the JAX schedulers'.
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
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import SlotScheduler as JaxSlotScheduler
from repro.models import get_model as jax_get_model
from repro.models import transformer as jax_T
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import ForgeCompiler
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.launch.serve import BatchedServer, Request, SlotScheduler
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

from torch_port_support import (
    PAGED_METRICS,
    TOL_F32,
    as_np,
    jax_paged_run,
    jax_params,
    port_paged_run,
    port_params,
)

ARCHS = ["deepseek-7b", "phi3-mini-3.8b", "qwen1.5-32b", "qwen2.5-14b"]
MAX_LEN = 32


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


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
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        assert cfg.ffn == "swiglu" and cfg == type(cfg)(**{
            f: getattr(jcfg, f) for f in cfg.__dataclass_fields__})
    q = get_config("qwen2.5-14b", smoke=True)
    assert (q.n_heads, q.n_kv_heads, q.qkv_bias, q.rope_theta) == (4, 2, True, 1e6)


def test_swiglu_dispatch_matches_plain():
    g = torch.Generator().manual_seed(0)
    x, wg, wu = (torch.randn(*s, generator=g) for s in ((2, 3, 8), (8, 16), (8, 16)))
    want = ref.swiglu_ref(x, wg, wu)
    assert torch.equal(ops.swiglu(x, wg, wu, impl="ref"), want)
    np.testing.assert_allclose(ops.swiglu(x, wg, wu).numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert tuple(want.shape) == (2, 3, 16)


def test_apply_logits_match_jax(setup):
    cfg, jcfg, jp, p = setup
    toks = _tokens((2, 8), 1)
    got = get_model(cfg).apply(p, torch.from_numpy(toks).long(), cfg)
    want = jax_get_model(jcfg).apply(jp, jnp.asarray(toks), jcfg)
    assert tuple(got.shape) == (2, 8, cfg.vocab)
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL_F32)


def _summary(nodes):
    out = []
    for n in nodes:
        p = n.params
        if n.op == "forge.linear_act":
            out.append((n.op, p["act"], p["has_bias"], p["has_residual"]))
        elif n.op == "forge.sdpa":
            out.append((n.op, p["causal"], p["mask_mode"], p["groups"]))
        elif n.op == "forge.swiglu":
            out.append((n.op,))
    return sorted(out, key=repr)


@pytest.mark.parametrize("mode", ["apply", "decode"])
def test_block_fusions_match_jax(setup, mode):
    cfg, jcfg, jp, p = setup
    B, S = 2, 8
    x = np.random.default_rng(2).standard_normal(
        (B, S if mode == "apply" else 1, cfg.d_model)).astype(np.float32)
    kc = np.random.default_rng(3).standard_normal(
        (B, cfg.n_kv_heads, 16, cfg.head_dim_)).astype(np.float32)
    one = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])
    if mode == "apply":
        cos, sin = T._rope_for(cfg, torch.arange(S))
        jcos, jsin = jax_T._rope_for(jcfg, jnp.arange(S, dtype=jnp.int32), None)
        fn, jfn = T.block_apply, jax_T.block_apply
        args = (p["blocks"][0], torch.from_numpy(x), cos, sin)
        jargs = (one, jnp.asarray(x), jcos, jsin)
    else:
        pos = torch.tensor(3)
        cos, sin = T._rope_for(cfg, L.decode_positions(pos))
        jcos, jsin = jax_T._rope_for(jcfg, jnp.asarray(3, jnp.int32)[None], None)
        fn, jfn = T.block_decode, jax_T.block_decode
        args = (p["blocks"][0], torch.from_numpy(x), torch.from_numpy(kc),
                torch.from_numpy(kc.copy()), pos, cos, sin)
        jargs = (one, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(kc),
                 jnp.asarray(3, jnp.int32), jcos, jsin)
    mod = ForgeCompiler().compile(lambda *a: fn(*a, cfg=cfg), *args)
    jmod = JaxForgeCompiler(JaxPipelineConfig()).compile(lambda *a: jfn(*a, cfg=jcfg), *jargs)
    got = _summary([n for n in mod.graph.nodes.values() if n.is_fused])
    assert got == _summary([n for n in jmod.graph.nodes.values()
                            if n.op.startswith("forge.")])
    assert ("forge.swiglu",) in got
    (sdpa,) = [g for g in got if g[0] == "forge.sdpa"]
    assert sdpa[3] == cfg.n_heads // cfg.n_kv_heads
    rows = {r["pass"]: r for r in mod.result.pass_table()}
    assert rows["operator_fusion"]["detail"]["swiglu"] == 1
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


def test_eager_server_tokens_equal_jax(setup, jax_tokens):
    cfg, _, _, p = setup
    r = BatchedServer(cfg, p, max_len=MAX_LEN, mode="interpret").generate(_tokens((3, 6), 0), 4)
    np.testing.assert_array_equal(r["tokens"], jax_tokens[0])


@pytest.fixture(scope="module")
def forge_server(setup):
    cfg, _, _, p = setup
    return BatchedServer(cfg, p, max_len=MAX_LEN, mode="forge")


def test_forge_fronts_tokens_equal_jax(forge_server, jax_tokens):
    r = forge_server.generate(_tokens((3, 6), 0), 4)
    assert r["prefill_mode"] == "batched"
    np.testing.assert_array_equal(r["tokens"], jax_tokens[1])
    np.testing.assert_array_equal(r["tokens"], jax_tokens[0])


def _leaves_equal(got, want):
    from torch.utils import _pytree as pytree

    g, w = pytree.tree_leaves(got), pytree.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_segment_jit_bitwise_interpret(setup, forge_server):
    cfg, _, _, p = setup
    srv = forge_server
    prompts = _tokens((4, 8), 5)
    srv.generate(prompts, 2)
    B = prompts.shape[0]
    (pkey,) = [k for k in srv.prefill_bucketed.programs if k.extents[0] == B]
    pmod = srv.prefill_bucketed.programs[pkey]
    assert pmod.result.backend == "segment_jit"
    toks = np.pad(prompts, ((0, 0), (0, pkey.extents[1] - prompts.shape[1])), mode="edge")
    args = (p, srv._build_cache(B)) + srv._prefill_args(B, torch.as_tensor(toks), 0)
    _leaves_equal(pmod(*args), pmod.with_backend("interpret")(*args))
    cache, tok, pos, _, dkey = srv.prefill(prompts)
    dmod = srv.bucketed.programs[dkey]
    dargs = (p, cache) + srv._decode_args(B, tok, pos)
    _leaves_equal(dmod(*dargs), dmod.with_backend("interpret")(*dargs))
    # the whole step traces the block bodies' executors: a layer's
    # forge.swiglu is two fused-linear kernel nodes, beside the output
    # projection's and the down projection's (each with its residual)
    ops_ = [n.op for n in pmod.graph.nodes.values()]
    assert ops_.count("repro_torch.fused_linear.default") == 4 * cfg.n_layers
    names = [r["pass"] for r in pmod.result.pass_table()]
    assert names == ["dce", "cse", "constant_folding", "device_constant", "attention_fusion",
                     "operator_fusion", "layout_optimization"]


# --------------------------------------------------------------------------
# qwen2.5-14b smoke: the contiguous and the paged SlotScheduler
# --------------------------------------------------------------------------

METRICS = ("decode_dispatches", "prefill_dispatches", "swaps", "resizes", "idle_ticks",
           "occupied_row_steps", "capacity_row_steps", "compiles", "real_tokens")
WORKLOAD = [(3, 6, 0), (5, 2, 0), (4, 3, 1), (20, 3, 2), (11, 4, 14), (7, 2, 14)]


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen2.5-14b", smoke=True).with_(dtype="float32")
    jcfg = jax_get_config("qwen2.5-14b", smoke=True).with_(dtype="float32")
    jp = jax_params(jcfg)
    return cfg, jcfg, jp, port_params(jp)


def _sched_run(server_cls, sched_cls, req_cls, cfg, params, **kw):
    srv = server_cls(cfg, params, max_len=MAX_LEN, mode="forge", bucket_policy="ladder:1,2",
                     seq_bucket_policy="ladder:8,16", **kw)
    sched = sched_cls(srv, max_slots=2)
    sched.warmup()
    reqs = [req_cls(rid=i, prompt=_tokens((n,), 30 + i), max_new=m, arrival=a)
            for i, (n, m, a) in enumerate(WORKLOAD)]
    return sched.run(reqs)


def _same_requests(got, want, fields):
    assert sorted(got["results"]) == sorted(want["results"])
    for rid, r in want["results"].items():
        g = got["results"][rid]
        assert "error" not in g, g.get("error")
        np.testing.assert_array_equal(g["tokens"], np.asarray(r["tokens"]),
                                      err_msg=f"request {rid}")
        assert [g[f] for f in fields] == [r[f] for f in fields], f"request {rid}"


def test_qwen_contiguous_scheduler_equals_jax(qwen):
    cfg, jcfg, jp, p = qwen
    got = _sched_run(BatchedServer, SlotScheduler, Request, cfg, p)
    want = _sched_run(JaxBatchedServer, JaxSlotScheduler, JaxRequest, jcfg, jp,
                      backend="interpret")
    _same_requests(got, want, ("admitted_tick", "finished_tick", "swapped_in"))
    assert {k: got[k] for k in METRICS} == {k: want[k] for k in METRICS}
    assert got["swaps"] >= 1 and got["resizes"] >= 2


def test_qwen_paged_scheduler_equals_jax(qwen):
    cfg, jcfg, jp, p = qwen
    got, srv = port_paged_run(cfg, p)
    want = jax_paged_run(jcfg, jp)
    _same_requests(got, want, ("admitted_tick", "finished_tick", "swapped_in"))
    assert {k: got[k] for k in PAGED_METRICS} == {k: want[k] for k in PAGED_METRICS}
    assert got["prefix_hits"] >= 1 and got["swaps"] >= 1


def test_cli_qwen_smoke_on_cpu(capsys):
    assert serve.main(["--arch", "qwen2.5-14b", "--smoke", "--device", "cpu", "--mode",
                       "forge", "--batch", "2", "--prompt-len", "5", "--gen", "3",
                       "--max-len", "32"]) == 0
    out = capsys.readouterr().out
    assert "qwen2.5-14b-smoke batch=2 prompt=5" in out and "(prefill=batched)" in out
