"""Pad-and-mask ``BucketedModule.__call__``, the warm-bucket fallback,
``evict_cold``, ``BufferPool``, ``bucket_report`` and the bucketed,
prefill and ragged-decode fidelity checks of the port, against the JAX
package.

* ``PadPlan`` / ``pad_args`` pad and slice the same numpy inputs to the
  same values as the JAX package's (1-D and 2-D, edge and zero pads);
  ``nearest_warm`` picks the same bucket on the same warm sets.
* ``__call__`` at ragged batches is bitwise equal to exact-shape
  compiles, and within f32 rtol 2e-4 / atol 2e-5 of the JAX package's
  ``BucketedModule`` on the ``interpret`` backend (tests/conftest.py's
  GQA block).
* The async dispatch scenarios of the JAX package's
  ``TestAsyncDispatch`` and ``TestEvictionCoherence``.
* ``BufferPool`` counters; ``bucket_report`` prints the JAX package's
  line from equal stats; the three fidelity checks hold their bounds.
"""
import math
import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import shapekey as jsk
from repro.core import forge_compile_bucketed as jax_forge_compile_bucketed
from repro.core.metrics import bucket_report as jax_bucket_report
from repro_torch.configs import get_config
from repro_torch.core import (BufferPool, CompileCache, CompileService, DiskCacheStore,
                              ForgeCompiler, PipelineConfig, forge_compile_bucketed)
from repro_torch.core import metrics
from repro_torch.core import shapekey as sk
from repro_torch.models import get_model

from torch_port_support import TOL_F32, as_np

from conftest import make_block_args, make_block_fn

BLOCK_IN_AXES = (0,) + (None,) * 7


def torch_block(x, wq, wk, wv, wo, w1, b1, w2):
    """tests/conftest.py's GQA block, written with torch ops."""
    B, S, E = x.shape
    H, D, KVH = 4, E // 4, 2
    q = (x @ wq).reshape(B, S, H, D).transpose(1, 2)
    k = (x @ wk).reshape(B, S, KVH, D).transpose(1, 2)
    v = (x @ wv).reshape(B, S, KVH, D).transpose(1, 2)
    g = H // KVH
    k = k.unsqueeze(2).expand(B, KVH, g, S, D).reshape(B, H, S, D)
    v = v.unsqueeze(2).expand(B, KVH, g, S, D).reshape(B, H, S, D)
    s = torch.matmul(q, k.transpose(-2, -1)) * (1.0 / math.sqrt(D))
    row = torch.arange(S).view(S, 1)
    col = torch.arange(S).view(1, S)
    s = torch.where(row >= col, s, torch.finfo(s.dtype).min)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p, v).transpose(1, 2).reshape(B, S, E)
    x = x + o @ wo
    h = F.silu(x @ w1 + b1)
    return x + h @ w2


def _block_args(B, seed=0):
    return make_block_args(np.random.default_rng(seed), B=B)


# --------------------------------------------------------------------------
# PadPlan / pad_args / nearest_warm against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["edge", "zero"])
def test_pad_plan_matches_jax_1d(mode):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    w = rng.standard_normal((5, 2)).astype(np.float32)
    m = np.asarray([True, False, True])
    kw = dict(n_valid=3, extent=8, in_axes=(0, None, 0), out_axes=(0, None), mode=mode)
    jp, tp = jsk.PadPlan(**kw), sk.PadPlan(**kw)
    assert (tp.n_valid_cells, tp.n_padded) == (jp.n_valid_cells, jp.n_padded) == (3, 5)
    jin, tin = jp.pad([x, w, m]), tp.pad([torch.from_numpy(a) for a in (x, w, m)])
    for a, b in zip(jin, tin):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    y = rng.standard_normal((8, 4)).astype(np.float32)
    for a, b in zip(jp.unpad([y, w]), tp.unpad([torch.from_numpy(y), torch.from_numpy(w)])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("mode", ["edge", "zero"])
def test_pad_plan_and_pad_args_match_jax_2d(mode):
    rng = np.random.default_rng(1)
    tok = rng.integers(0, 50, (3, 5)).astype(np.int32)
    mask = np.asarray([True, True, False])
    cache = {"k": rng.standard_normal((2, 3, 7)).astype(np.float32)}
    args = (cache, tok, mask)
    specs_b, specs_s = ({"k": 1}, 0, 0), (None, 1, None)
    jargs = jsk.pad_args(args, (specs_b, specs_s), (4, 8), mode=mode)
    targs = sk.pad_args(({"k": torch.from_numpy(cache["k"])}, torch.from_numpy(tok),
                         torch.from_numpy(mask)), (specs_b, specs_s), (4, 8), mode=mode)
    np.testing.assert_array_equal(np.asarray(jargs[0]["k"]), targs[0]["k"].numpy())
    np.testing.assert_array_equal(np.asarray(jargs[1]), targs[1].numpy())
    np.testing.assert_array_equal(np.asarray(jargs[2]), targs[2].numpy())
    assert targs[1].dtype == torch.int32 and targs[2].dtype == torch.bool
    nd = sk.flatten_axes_nd([specs_b, specs_s], args)
    assert nd == jsk.flatten_axes_nd([specs_b, specs_s], ({"k": cache["k"]}, tok, mask))
    assert sk.infer_extents([cache["k"], tok, mask], nd, 2) == (3, 5)
    plan = sk.PadPlan(n_valid=(3, 5), extent=(4, 8), in_axes=tuple(nd),
                      out_axes=((0, 1),), mode=mode)
    assert (plan.n_valid_cells, plan.n_padded) == (15, 17)
    out = plan.unpad([torch.zeros(4, 8)])[0]
    assert tuple(out.shape) == (3, 5)


def _warm_module(pkg_bucketed, extents_list, n_axes):
    axes = [pkg_bucketed[1](in_axes=0, policy="pow2", label="B")]
    if n_axes == 2:
        axes.append(pkg_bucketed[1](in_axes=1, policy="ladder:8,16,32,64", label="S"))
    mod = pkg_bucketed[0](lambda x: x, axes=tuple(axes))
    for ext in extents_list:
        mod.programs[mod.key_for_extents(ext)] = None  # a warm-table probe only
    return mod


@pytest.mark.parametrize("seed", range(6))
def test_nearest_warm_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pkgs = {"jax": (jax_forge_compile_bucketed, jsk.PolyAxis),
            "port": (forge_compile_bucketed, sk.PolyAxis)}
    for n_axes in (1, 2):
        pool = ([(e,) for e in (2, 4, 8, 16)] if n_axes == 1
                else [(b, s) for b in (2, 4, 8) for s in (8, 16, 32, 64)])
        warm = [pool[i] for i in rng.choice(len(pool), size=int(rng.integers(1, len(pool))),
                                            replace=False)]
        jmod = _warm_module(pkgs["jax"], warm, n_axes)
        tmod = _warm_module(pkgs["port"], warm, n_axes)
        for _ in range(20):
            ns = tuple(int(rng.integers(1, 70)) for _ in range(n_axes))
            want, got = jmod.nearest_warm(ns), tmod.nearest_warm(ns)
            assert (None if want is None else str(want)) == (None if got is None else str(got))


# --------------------------------------------------------------------------
# __call__
# --------------------------------------------------------------------------


def test_call_ragged_bitwise_exact_and_matches_jax():
    port = forge_compile_bucketed(torch_block, in_axes=BLOCK_IN_AXES, policy="pow2",
                                  cache=CompileCache())
    jmod = jax_forge_compile_bucketed(make_block_fn(), in_axes=BLOCK_IN_AXES, policy="pow2",
                                      backend="interpret")
    for B in (1, 3, 5, 3):
        args = _block_args(B, seed=B)
        targs = [torch.from_numpy(a) for a in args]
        with torch.no_grad():
            got = port(*targs)
            exact = ForgeCompiler(cache=CompileCache()).compile(torch_block, *targs)(*targs)
        assert tuple(got.shape) == args[0].shape
        assert torch.equal(got, exact)  # the padded rows are inert
        np.testing.assert_allclose(as_np(got), as_np(jmod(*args)), **TOL_F32)
    assert sorted(map(str, port.programs)) == ["pow2:B2", "pow2:B4", "pow2:B8"]
    assert (port.stats.compiles, port.stats.bucket_hits) == (3, 1)
    assert (port.stats.rows_real, port.stats.rows_padded) == (12, 6)
    assert (port.stats.rows_real, port.stats.rows_padded) == (jmod.stats.rows_real,
                                                              jmod.stats.rows_padded)
    assert port.bucket_table()["pow2:B4"].padded_calls == 2
    assert port.bucket_table()["pow2:B4"].rows_padded_total == 2
    assert port.last_result.shape_key == "pow2:B8"


def test_call_two_axes_slices_each_axis():
    def fn(t, s):
        return t * 3.0, s + 1.0

    front = forge_compile_bucketed(fn, axes=(
        sk.PolyAxis(in_axes=(0, 0), out_axes=(0, 0), policy="pow2", label="B"),
        sk.PolyAxis(in_axes=(1, None), out_axes=(1, None), policy="ladder:8,16", label="S")),
        cache=CompileCache())
    t = torch.randn(3, 11)
    a, b = front(t, torch.ones(3))
    assert torch.equal(a, t * 3.0) and torch.equal(b, torch.full((3,), 2.0))
    assert [str(k) for k in front.programs] == ["pow2:B4xladder:S16"]
    assert (front.stats.rows_real, front.stats.rows_padded) == (33, 31)


def test_pad_with_zero_mode():
    front = forge_compile_bucketed(lambda x: x.sum(0, keepdim=True).expand_as(x) + x,
                                   in_axes=0, out_axes=0, pad_mode="zero", cache=CompileCache())
    x = torch.ones(3, 2)
    assert torch.equal(front(x), torch.full((3, 2), 4.0))  # the zero row adds nothing


# --------------------------------------------------------------------------
# async dispatch (the JAX package's TestAsyncDispatch)
# --------------------------------------------------------------------------


def _fn(x):
    return torch.cumsum(x, dim=-1) * 2.0 + 1.0


def _x(b, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(b, 4)).astype(np.float32))


def test_thundering_herd_compiles_once():
    svc = CompileService(workers=2)
    mod = forge_compile_bucketed(_fn, in_axes=0, policy="pow2", async_compile=True,
                                 service=svc, cache=CompileCache())
    x = _x(5)
    outs, errs = [None] * 8, []

    def call(i):
        try:
            outs[i] = mod(x)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    assert not errs and all(o is not None for o in outs)
    assert mod.stats.compiles == 1 and svc.stats.submitted == 1
    for o in outs[1:]:
        assert torch.equal(outs[0], o)
    svc.shutdown()


def test_fallback_bitwise_then_exact_switch():
    svc = CompileService(workers=1)
    mod = forge_compile_bucketed(_fn, torch.ones(8, 4), in_axes=0, policy="pow2",
                                 async_compile=True, service=svc, cache=CompileCache())
    assert mod.has_program(mod.key_for_extents(8))
    wait0 = mod.stats.compile_wait_s
    x = _x(3)
    y_fb = mod(x)  # the exact B4 is cold: the warm B8 serves it
    assert mod.stats.fallback_calls == 1 and mod.stats.fallback_cells_padded == 4
    assert mod.stats.compile_wait_s == wait0  # never blocked
    y_warm = mod(torch.cat([x, x[-1:].expand(5, 4)]))
    assert torch.equal(y_fb, y_warm[:3])
    assert svc.wait_idle(60.0)
    assert mod.has_program(mod.key_for_extents(4))
    assert mod.warm_keys() and mod.nearest_warm(3) == mod.key_for_extents(4)
    y_exact = mod(x)
    assert mod.stats.fallback_calls == 1 and mod.stats.compile_background_s > 0.0
    sync = forge_compile_bucketed(_fn, in_axes=0, policy="pow2", cache=CompileCache())
    assert torch.equal(y_exact, sync(x))
    svc.shutdown()


def test_first_dispatch_blocks_without_warm():
    svc = CompileService(workers=1)
    mod = forge_compile_bucketed(_fn, in_axes=0, policy="pow2", async_compile=True,
                                 service=svc, cache=CompileCache())
    y = mod(_x(3))
    assert mod.stats.compiles == 1 and mod.stats.compile_wait_s > 0.0
    assert mod.stats.fallback_calls == 0
    assert torch.equal(y, forge_compile_bucketed(_fn, in_axes=0, cache=CompileCache())(_x(3)))
    svc.shutdown()


# --------------------------------------------------------------------------
# eviction coherence (the JAX package's TestEvictionCoherence)
# --------------------------------------------------------------------------


def test_evict_cold_drops_cache_entry(tmp_path):
    store = DiskCacheStore(str(tmp_path))
    cache = CompileCache(store=store)
    mod = ForgeCompiler(PipelineConfig(backend="segment_jit"), cache=cache).compile_bucketed(
        _fn, in_axes=0, policy="pow2")
    for b in (2, 4, 8):
        mod(_x(b))
    mod.pool.release(2, {"buf": torch.zeros(2)})
    assert len(cache) == 3
    n_disk = len(store)
    victims = mod.evict_cold(1)
    assert sorted(map(str, victims)) == ["pow2:B2", "pow2:B4"]
    assert cache.stats.coherence_drops == 2 and len(cache) == 1
    assert len(store) == n_disk  # the disk tier keeps them
    assert mod.pool.pooled(2) == 0 and mod.stats.evictions == 2
    y = mod(_x(2))  # an evicted bucket replays from disk
    assert cache.stats.disk_hits == 1
    assert torch.equal(y, forge_compile_bucketed(_fn, in_axes=0, cache=CompileCache())(_x(2)))


def test_evict_without_store_only_counts():
    cache = CompileCache()
    mod = ForgeCompiler(PipelineConfig(backend="segment_jit"), cache=cache).compile_bucketed(
        _fn, in_axes=0, policy="pow2")
    mod(_x(2))
    mod(_x(4))
    assert mod.evict_cold(1) == [mod.key_for_extents(2)]
    assert cache.stats.coherence_drops == 1 and len(cache) == 1
    with pytest.raises(ValueError):
        mod.evict_cold(-1)


# --------------------------------------------------------------------------
# BufferPool, bucket_report
# --------------------------------------------------------------------------


def test_buffer_pool_counters():
    stats = sk.BucketStats()
    pool = BufferPool(stats, max_per_key=2)
    built = []

    def build():
        built.append(1)
        return {"k": torch.ones(4, 2)}

    a = pool.acquire(4, build)
    assert (stats.pool_hits, stats.pool_misses) == (0, 1)
    pool.release(4, a)
    reset = lambda t: {k: v.zero_() for k, v in t.items()}  # noqa: E731
    b = pool.acquire(4, build, reset=reset)
    assert b["k"] is a["k"] and float(b["k"].sum()) == 0.0  # reused in place
    assert (stats.pool_hits, stats.pool_misses, stats.pool_bytes_reused) == (1, 1, 32)
    assert stats.pool_hit_rate == 0.5

    def bad_reset(_):
        raise RuntimeError("unresettable")

    pool.release(4, b)
    pool.acquire(4, build, reset=bad_reset)  # falls back to a build
    assert len(built) == 2 and stats.pool_misses == 2
    for _ in range(3):
        pool.release(8, build())
    assert pool.pooled(8) == 2  # max_per_key
    assert pool.drop(8) == 2 and pool.pooled(8) == 0 and pool.drop(8) == 0
    from repro_torch.core.compiler import bucket_pool_key

    assert bucket_pool_key(sk.ShapeKey((sk.AxisKey("pow2", 4),))) == 4
    assert bucket_pool_key(sk.ShapeKey((sk.AxisKey("pow2", 4), sk.AxisKey("ladder", 16, "S")))
                           ) == (4, 16)


def _fill_stats(stats, key_cls, axis_cls):
    k4 = key_cls((axis_cls("pow2", 4, "B"),))
    k8 = key_cls((axis_cls("pow2", 8, "B"),))
    stats.note_lookup(hit=False, compile_s=1.25)
    stats.note_lookup(hit=False, compile_s=0.5, background=True)
    stats.note_lookup(hit=True)
    stats.note_wait(0.125)
    stats.note_fallback(4)
    stats.note_pool(hit=False)
    stats.note_pool(hit=True, nbytes=3_000_000)
    for key, n, e in ((k4, 3, 4), (k8, 5, 8), (k4, 4, 4)):
        stats.note_dispatch(key, n, e)
    stats.note_eviction(k8)
    return stats


def test_bucket_report_matches_jax():
    port = _fill_stats(sk.BucketStats(), sk.ShapeKey, sk.AxisKey)
    ref = _fill_stats(jsk.BucketStats(), jsk.ShapeKey, jsk.AxisKey)
    assert metrics.bucket_report(port) == jax_bucket_report(ref)
    assert metrics.bucket_report(sk.BucketStats()) == jax_bucket_report(jsk.BucketStats())
    assert port.per_bucket_last_dispatch == {"pow2:B4": 3}
    assert (port.hit_rate, port.pad_waste) == (ref.hit_rate, ref.pad_waste)


# --------------------------------------------------------------------------
# fidelity checks
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense():
    cfg = get_config("forge-125m", smoke=True).with_(dtype="float32")
    return cfg, get_model(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")


def test_check_bucketed_fidelity():
    for B in (1, 3):
        r = metrics.check_bucketed_fidelity(torch_block, *map(torch.from_numpy, _block_args(B)),
                                            in_axes=BLOCK_IN_AXES)
        assert r.max_abs_diff == 0.0 and r.ok()


def test_check_prefill_fidelity(dense):
    cfg, params = dense
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (2, 6))
    r = metrics.check_prefill_fidelity(cfg, params, prompts, max_len=16)
    assert r.max_abs_diff <= 1e-5 and r.n_elements > 0


def test_check_ragged_decode_fidelity(dense):
    cfg, params = dense
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, (n,)) for n in (3, 5, 2)]
    r = metrics.check_ragged_decode_fidelity(cfg, params, prompts, n_new=2, max_len=16)
    assert r.max_abs_diff <= 1e-5 and r.n_elements == 3 * 2 * cfg.vocab


# --------------------------------------------------------------------------
# counters shared between the serving thread and compile workers
# --------------------------------------------------------------------------


def test_shared_counters_lose_no_update_under_threads():
    """More threads than cores bump one BucketStats, one launch counter and
    their own capture recorders with a short switch interval: no update is
    lost, and a thread's recorder sees only its own launches."""
    import os
    import sys

    from repro_torch.kernels import _build

    stats, counter = sk.BucketStats(), _build.LaunchCount()
    key = sk.ShapeKey((sk.AxisKey("pow2", 4),))
    n_threads, n_iter = 2 * (os.cpu_count() or 2) + 2, 2000
    recorded = [None] * n_threads
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(n_iter):
                stats.note_dispatch(key, 3, 4)
                stats.note_pool(hit=True, nbytes=2)
                counter.count("v")
            with _build.recording() as rec:
                for _ in range(i + 1):
                    counter.count("v")
            recorded[i] = rec.delta()

        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    total = n_threads * n_iter
    assert (stats.calls, stats.rows_real, stats.rows_padded) == (total, 3 * total, total)
    assert stats.per_bucket_calls == {"pow2:B4": total} and stats.dispatch_seq == total
    assert (stats.pool_hits, stats.pool_bytes_reused) == (total, 2 * total)
    assert counter.n == total and counter.variants == {"v": total}
    for i, delta in enumerate(recorded):
        assert delta == ((counter.index, i + 1, (("v", i + 1),)),)
    _build.add_launches(recorded[0])
    assert counter.n == total + 1 and counter.variants == {"v": total + 1}
