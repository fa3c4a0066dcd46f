"""The port's compile cache (``repro_torch.core.cache``): RGIR
fingerprints, cache keys in the JAX package's format, the disk tier, and
restart replay.

* The fingerprint of forge-125m smoke's block body is stable over two
  captures, equal for two layers with different weights (weights are
  program inputs), and changes with a baked constant's value; a traced
  (fake) compile is uncacheable.
* ``make_cache_key`` gives the JAX package's string for the same
  backend, reorder flag, fingerprint and ShapeKey.
* The disk tier's scenarios of the JAX package's
  ``tests/test_compile_service.py::TestDiskCache``: restart replay with
  zero builds, the interpret round trip, a truncated entry and a garbage
  entry detected and rebuilt, the salt invalidating by address, a
  foreign file missing on its embedded key.
* Restart replay of the block body with zero full builds, bitwise equal
  to a fresh build, on the ``interpret``, ``reference`` and
  ``segment_jit`` backends.
"""
import functools
import os
import shutil

import numpy as np
import pytest
import torch

from repro.core import cache as jax_cache
from repro.core.shapekey import AxisKey as JaxAxisKey
from repro.core.shapekey import ShapeKey as JaxShapeKey
from repro_torch.configs import get_config
from repro_torch.core import CompileCache, DiskCacheStore, ForgeCompiler, PipelineConfig
from repro_torch.core import cache as port_cache
from repro_torch.core.shapekey import AxisKey, ShapeKey
from repro_torch.models import get_model
from repro_torch.models import transformer as T

BACKENDS = ("interpret", "reference", "segment_jit")


@pytest.fixture(scope="module")
def body():
    """forge-125m smoke's block body with layers 0 and 1 and an input."""
    cfg = get_config("forge-125m", smoke=True).with_(dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = get_model(cfg).init(cfg, gen, "cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    cos, sin = T._rope_for(cfg, torch.arange(8))
    fn = functools.partial(T.block_apply, cfg=cfg)
    return fn, params["blocks"], (x, cos, sin)


def _compile(fn, *args, backend="interpret", cache=None):
    return ForgeCompiler(PipelineConfig(backend=backend),
                         cache=cache if cache is not None else CompileCache()).compile(fn, *args)


def test_fingerprint_stable_over_two_captures(body):
    fn, blocks, rest = body
    a = _compile(fn, blocks[0], *rest)
    b = _compile(fn, blocks[0], *rest)
    assert a.program is not b.program
    assert port_cache.fingerprint_program(a.program) == port_cache.fingerprint_program(b.program)
    assert a.result.cache_key == b.result.cache_key
    assert not a.result.cache_hit and not b.result.cache_hit  # private caches


def test_fingerprint_equal_for_two_layers(body):
    """Layer weights are program inputs: layers 0 and 1 share one key, and
    the second compile is a memory hit whose outputs are layer 1's."""
    fn, blocks, rest = body
    cache = CompileCache()
    m0 = _compile(fn, blocks[0], *rest, cache=cache)
    m1 = _compile(fn, blocks[1], *rest, cache=cache)
    assert m0.result.cache_key == m1.result.cache_key
    assert m1.result.cache_hit and not m1.result.cache_disk_hit
    assert cache.stats.hits == 1 and cache.stats.misses == 1
    assert m1.result.executor_stats.total_calls == 0  # a fresh snapshot
    fresh = _compile(fn, blocks[1], *rest)
    with torch.no_grad():
        assert torch.equal(m1(blocks[1], *rest), fresh(blocks[1], *rest))
        assert not torch.equal(m1(blocks[1], *rest), m0(blocks[0], *rest))


@pytest.mark.parametrize("n", [4, 512])  # below and above the digest memo's size
def test_fingerprint_changes_with_constant(n):
    def make(value):
        c = torch.full((n,), value)
        return lambda x: x * c + 1.0

    x = torch.ones(3, n)
    k1 = _compile(make(2.0), x).result.cache_key
    k2 = _compile(make(2.0), x).result.cache_key
    k3 = _compile(make(3.0), x).result.cache_key
    assert k1 == k2 and k1 != k3


def test_fingerprint_memo_hits_on_refingerprint():
    c = torch.arange(1024, dtype=torch.float32)
    mod = _compile(lambda x: x + c, torch.zeros(1024))
    port_cache.fingerprint_program(mod.program)
    hits = port_cache.fp_memo_stats.hits
    port_cache.fingerprint_program(mod.program)
    assert port_cache.fp_memo_stats.hits == hits + 1


def test_traced_compile_is_uncacheable():
    from torch._subclasses.fake_tensor import FakeTensorMode

    mod = _compile(lambda x: x * 2.0, torch.ones(2, 2))
    with FakeTensorMode():
        with pytest.raises(port_cache.UncacheableProgram):
            port_cache.fingerprint_program(mod.program)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("reorder", [True, False])
def test_cache_keys_match_jax_format(backend, reorder):
    fp = "ab" * 32
    shape_keys = [
        (None, None),
        (ShapeKey((AxisKey("pow2", 4, "B"),)), JaxShapeKey((JaxAxisKey("pow2", 4, "B"),))),
        (ShapeKey((AxisKey("pow2", 4, "B"), AxisKey("ladder", 64, "S"))),
         JaxShapeKey((JaxAxisKey("pow2", 4, "B"), JaxAxisKey("ladder", 64, "S")))),
    ]
    for port_key, jax_key in shape_keys:
        want = jax_cache.make_cache_key(backend, reorder, fp, jax_key)
        assert port_cache.make_cache_key(backend, reorder, fp, port_key) == want
    assert want == f"{backend}|reorder={int(reorder)}|bucket=pow2:B4xladder:S64|{fp}"


def test_cache_salt_names_the_environment():
    salt = port_cache.cache_salt()
    for part in (f"schema={port_cache.DISK_SCHEMA}", f"torch={torch.__version__}",
                 f"cuda={torch.version.cuda}", "platform=", "py="):
        assert part in salt


# --------------------------------------------------------------------------
# the disk tier (the JAX package's TestDiskCache scenarios)
# --------------------------------------------------------------------------


def _fn(x):
    return torch.cumsum(x, dim=-1) * 2.0 + 1.0


def _x(b, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(b, 4)).astype(np.float32))


def _compile_once(cache, backend="segment_jit"):
    return ForgeCompiler(PipelineConfig(backend=backend), cache=cache).compile(
        _fn, torch.ones(4, 4))


def _entry_files(root):
    return [os.path.join(r, f) for r, _d, fs in os.walk(root) for f in fs
            if f.endswith(".forgec")]


class TestDiskCache:
    def test_restart_replays_with_zero_builds(self, tmp_path):
        store = DiskCacheStore(str(tmp_path))
        c1 = CompileCache(store=store)
        m1 = _compile_once(c1)
        assert c1.stats.misses == 1 and store.stats.writes == 1 and len(store) == 1
        # a restart: a fresh memory tier over the same directory
        c2 = CompileCache(store=DiskCacheStore(str(tmp_path)))
        m2 = _compile_once(c2)
        assert c2.stats.misses == 0 and c2.stats.disk_hits == 1
        assert m2.result.cache_disk_hit
        assert torch.equal(m1(_x(4)), m2(_x(4)))

    def test_interpret_backend_roundtrip(self, tmp_path):
        c1 = CompileCache(store=DiskCacheStore(str(tmp_path)))
        m1 = _compile_once(c1, backend="interpret")
        c2 = CompileCache(store=DiskCacheStore(str(tmp_path)))
        m2 = _compile_once(c2, backend="interpret")
        assert c2.stats.disk_hits == 1 and c2.stats.misses == 0
        assert torch.equal(m1(_x(4)), m2(_x(4)))

    def test_corrupt_entry_detected_and_recompiled(self, tmp_path):
        _compile_once(CompileCache(store=DiskCacheStore(str(tmp_path))))
        files = _entry_files(tmp_path)
        assert files
        for p in files:  # truncate: the checksum must catch it
            blob = open(p, "rb").read()
            open(p, "wb").write(blob[: len(blob) // 2])
        store2 = DiskCacheStore(str(tmp_path))
        c2 = CompileCache(store=store2)
        m2 = _compile_once(c2)
        assert store2.stats.corrupt == 1
        assert c2.stats.misses == 1  # rebuilt, not crashed
        assert store2.stats.writes == 1  # the entry healed on disk
        assert torch.equal(m2(_x(4)), _compile_once(CompileCache())(_x(4)))

    def test_garbage_entry_detected(self, tmp_path):
        _compile_once(CompileCache(store=DiskCacheStore(str(tmp_path))))
        for p in _entry_files(tmp_path):
            open(p, "wb").write(os.urandom(256))
        store2 = DiskCacheStore(str(tmp_path))
        c2 = CompileCache(store=store2)
        _compile_once(c2)
        assert store2.stats.corrupt == 1 and c2.stats.misses == 1
        assert len(store2) == 1  # the corrupt file was unlinked and rewritten

    def test_salt_invalidates_by_address(self, tmp_path):
        a = DiskCacheStore(str(tmp_path), salt="torch=1")
        assert a.store_entry("k", {"v": 1})
        b = DiskCacheStore(str(tmp_path), salt="torch=2")
        assert b.load_entry("k") is None  # another address: a clean miss
        assert b.stats.misses == 1
        assert a.load_entry("k") == {"v": 1}

    def test_foreign_file_key_mismatch(self, tmp_path):
        s = DiskCacheStore(str(tmp_path))
        s.store_entry("k1", {"v": 1})
        p2 = s.path_for("k2")
        os.makedirs(os.path.dirname(p2), exist_ok=True)
        shutil.copy(s.path_for("k1"), p2)
        assert s.load_entry("k2") is None
        assert s.stats.corrupt == 1
        assert not os.path.exists(p2)  # the poisoned file was unlinked

    def test_disk_format(self, tmp_path):
        """``FORGEC01`` magic, sha256 of the payload, two-level fan-out."""
        import hashlib

        s = DiskCacheStore(str(tmp_path))
        s.store_entry("k", {"v": 1})
        path = s.path_for("k")
        digest = os.path.basename(path)[:-len(".forgec")]
        assert os.path.basename(os.path.dirname(path)) == digest[:2]
        blob = open(path, "rb").read()
        assert blob.startswith(b"FORGEC01\n")
        assert hashlib.sha256(blob[9 + 32:]).digest() == blob[9:9 + 32]
        assert s.stats.bytes_written == len(blob)


@pytest.mark.parametrize("backend", BACKENDS)
def test_restart_replay_block_body(body, backend, tmp_path):
    """A restarted process (fresh memory tier, same directory) rebuilds the
    block body's Phase 4 from disk with no full build, and runs it
    bitwise equal to a fresh build."""
    fn, blocks, rest = body
    c1 = CompileCache(store=DiskCacheStore(str(tmp_path)))
    _compile(fn, blocks[0], *rest, backend=backend, cache=c1)
    assert c1.stats.misses == 1 and c1.store.stats.writes == 1
    c2 = CompileCache(store=DiskCacheStore(str(tmp_path)))
    replay = _compile(fn, blocks[1], *rest, backend=backend, cache=c2)
    assert c2.stats.misses == 0 and c2.stats.disk_hits == 1
    assert replay.result.cache_disk_hit
    fresh = _compile(fn, blocks[1], *rest, backend=backend)
    with torch.no_grad():
        assert torch.equal(replay(blocks[1], *rest), fresh(blocks[1], *rest))
    assert replay.stats.n_buffers == fresh.stats.n_buffers
    assert replay.stats.n_segments == fresh.stats.n_segments


def test_uncached_config_builds_every_time(body):
    fn, blocks, rest = body
    comp = ForgeCompiler(PipelineConfig(compile_cache=False))
    assert comp.cache is None
    assert comp.compile(fn, blocks[0], *rest).result.cache_key is None
