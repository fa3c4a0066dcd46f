"""Async compile, the persistent compile tier and the buffer pool on the
port's serve fronts, against the JAX package's (the JAX package's
``tests/test_compile_service.py::TestServeAsync`` contract).

On forge-125m smoke in f32 with the JAX package's parameters:

* with ``async_compile`` a group whose exact rung is cold never blocks:
  it pads into the warm rung, its tokens equal a sync server's, and once
  the background build lands the exact rung takes over;
* ``SlotScheduler`` warmed on rung 8 only falls back to it while lower
  rungs compile (``warm_fallbacks``), and every request's tokens equal
  the inline scheduler's and the JAX package's scheduler's;
* a second server on the same ``cache_dir``, after every memory tier is
  dropped, warms with zero full builds (block bodies included) and
  generates the same tokens; a second ``generate`` at one batch reuses
  the pooled cache;
* the CLI with ``--cache-dir`` and ``--assert-no-builds`` returns 0 on a
  populated directory and 1 on an empty one.
"""
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.launch.serve import BatchedServer as JaxBatchedServer
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import SlotScheduler as JaxSlotScheduler
from repro_torch.configs import get_config
from repro_torch.core import get_compile_cache
from repro_torch.launch import serve
from repro_torch.launch.serve import BatchedServer, Request, SlotScheduler
from repro_torch.models import _forge

from torch_port_support import jax_params, port_params

MAX_LEN = 32


@pytest.fixture(autouse=True)
def _isolate_global_cache():
    """``cache_dir`` attaches a disk store to the process-global cache:
    restore it so no test leaks a temporary store into another."""
    g = get_compile_cache()
    store0 = g.store
    yield
    g.store = store0


def _restart():
    """Drop every in-memory compile tier (what a process restart does)."""
    g = get_compile_cache()
    _forge.clear_cache()
    g.clear()
    g.store = None


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("forge-125m", smoke=True).with_(dtype="float32")
    jcfg = jax_get_config("forge-125m", smoke=True).with_(dtype="float32")
    jp = jax_params(jcfg)
    return cfg, jcfg, jp, port_params(jp)


def _prompts(cfg, B, P, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, P)).astype(np.int32)


def test_warm_fallback_never_blocks_and_switches(setup):
    cfg, _, _, p = setup
    prompts = _prompts(cfg, 3, 8)
    srv = BatchedServer(cfg, p, max_len=MAX_LEN, mode="forge", async_compile=True)
    try:
        srv.warmup([8], prompt_lens=[8])  # only the B8 rung is warm
        bs = srv.bucketed.stats
        r1 = srv.generate(prompts, 4)  # the exact rung B4 is cold
        assert bs.fallback_calls >= 1
        assert bs.compile_wait_s == 0.0  # the group never stalled
        sync = BatchedServer(cfg, p, max_len=MAX_LEN, mode="forge")
        sync.warmup([8], prompt_lens=[8])
        np.testing.assert_array_equal(r1["tokens"], sync.generate(prompts, 4)["tokens"])
        assert srv.compile_service.wait_idle(60.0)
        assert srv.bucketed.has_program(srv.bucketed.key_for_extents(4))
        r2 = srv.generate(prompts, 4)
        cold = BatchedServer(cfg, p, max_len=MAX_LEN, mode="forge")
        np.testing.assert_array_equal(r2["tokens"], cold.generate(prompts, 4)["tokens"])
        assert bs.compile_background_s > 0.0
    finally:
        srv.compile_service.shutdown()


def _workload(cls, vocab):
    """One admission wave, staggered budgets: the live count walks down
    through the cold lower rungs (the JAX package's async benchmark,
    shortened)."""
    rng = np.random.default_rng(1)
    return [cls(rid=i, prompt=rng.integers(0, vocab, (4 + i % 5,)).astype(np.int32),
                max_new=3 + i % 4, arrival=0) for i in range(10)]


def _tokens(res):
    return {rid: r["tokens"].tolist() for rid, r in res["results"].items()}


def test_scheduler_async_tokens_match_inline_and_jax(setup):
    cfg, jcfg, jp, p = setup
    lens = sorted({4 + i % 5 for i in range(10)})
    inline_srv = BatchedServer(cfg, p, max_len=MAX_LEN, mode="forge")
    inline_srv.warmup([8], prompt_lens=lens)
    inline = SlotScheduler(inline_srv, max_slots=8).run(_workload(Request, cfg.vocab))
    srv = BatchedServer(cfg, p, max_len=MAX_LEN, mode="forge", async_compile=True,
                        compile_workers=2)
    try:
        srv.warmup([8], prompt_lens=lens)
        sched = SlotScheduler(srv, max_slots=8)
        res = sched.run(_workload(Request, cfg.vocab))
        assert srv.compile_service.wait_idle(60.0)
        assert res["warm_fallbacks"] >= 1 and "warm_fallbacks=" in sched.report()
        assert srv.bucketed.stats.compile_wait_s <= 0.005
        assert srv.bucketed.stats.fallback_calls >= 1
    finally:
        srv.compile_service.shutdown()
    assert _tokens(res) == _tokens(inline)
    jsrv = JaxBatchedServer(jcfg, jp, max_len=MAX_LEN, mode="forge", backend="interpret")
    jsrv.warmup([8], prompt_lens=lens)
    jres = JaxSlotScheduler(jsrv, max_slots=8).run(_workload(JaxRequest, cfg.vocab))
    assert _tokens(res) == _tokens(jres)
    assert inline["warm_fallbacks"] == 0


def test_restart_replay_zero_builds_and_pool_reuse(setup, tmp_path):
    cfg, _, _, p = setup
    g = get_compile_cache()
    _restart()
    srv1 = BatchedServer(cfg, p, max_len=MAX_LEN, mode="forge", cache_dir=str(tmp_path))
    srv1.warmup([2], prompt_lens=[8])
    assert srv1.compile_cache.stats.misses > 0 and srv1.compile_cache.store.stats.writes > 0
    assert g.stats.misses > 0  # the block bodies, through the global cache
    _restart()
    srv2 = BatchedServer(cfg, p, max_len=MAX_LEN, mode="forge", cache_dir=str(tmp_path))
    srv2.warmup([2], prompt_lens=[8])
    assert srv2.compile_cache.stats.misses == 0 and srv2.compile_cache.stats.disk_hits > 0
    assert g.stats.misses == 0 and g.stats.disk_hits > 0  # bodies replayed too
    prompts = _prompts(cfg, 2, 8)
    t1 = srv1.generate(prompts, 4)["tokens"]
    bs = srv2.bucketed.stats
    hits0 = bs.pool_hits
    t2 = srv2.generate(prompts, 4)["tokens"]
    t3 = srv2.generate(prompts, 4)["tokens"]
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(t2, t3)
    assert bs.pool_hits >= hits0 + 2 and bs.pool_bytes_reused > 0


def _cli(cache_dir, *extra):
    return serve.main(["--smoke", "--device", "cpu", "--mode", "forge", "--sweep", "1,3",
                       "--prompt-sweep", "5", "--gen", "2", "--max-len", "16",
                       "--cache-dir", str(cache_dir), *extra])


def test_cli_assert_no_builds(tmp_path, capsys):
    _restart()
    assert _cli(tmp_path / "d") == 0
    out = capsys.readouterr().out
    assert "[serve] disk cache: builds=" in out and "batch=3 prompt=5" in out
    _restart()
    assert _cli(tmp_path / "d", "--assert-no-builds") == 0
    assert "[serve] disk cache: builds=0 " in capsys.readouterr().out
    _restart()
    assert _cli(tmp_path / "empty", "--assert-no-builds") == 1
    assert "ASSERT FAILED" in capsys.readouterr().out


def test_cli_async_sweep(capsys):
    assert serve.main(["--smoke", "--device", "cpu", "--mode", "forge", "--sweep", "1,3",
                       "--prompt-sweep", "5,17", "--gen", "2", "--max-len", "32",
                       "--async-compile", "--compile-workers", "2"]) == 0
    out = capsys.readouterr().out
    assert "[serve] compile service: submitted=" in out
    assert "compile_s_after_warmup=0.00" in out and "batch=1 prompt=17" in out


@pytest.mark.parametrize("argv", [
    ["--async-compile"], ["--cache-dir", "x"], ["--mode", "forge", "--assert-no-builds"],
    ["--mode", "forge", "--sweep", "1,a"],
    ["--mode", "forge", "--bucket-policy", "ladder:2,4", "--sweep", "1,8"],
])
def test_cli_argument_errors(argv):
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", *argv])
