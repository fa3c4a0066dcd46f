"""The port's token data pipeline, checkpoints and training runtime:

* ``TokenDataset`` bitwise against the JAX package's: the synthetic Zipf
  stream, a memmap corpus written by ``write_synthetic_corpus`` (both
  packages' writers write the same bytes), host shards;
* ``CheckpointManager``: a round trip with bf16, int and bool leaves and
  a 0-d step, the on-disk layout (``step_*/leaf_*.npy`` and a manifest
  with numpy dtype names, bf16 as raw bytes, as the JAX package writes
  them), async saves with ``keep_last``, a stray ``.tmp`` or torn
  directory ignored, a write error raised at ``wait()``, ``restore`` onto
  the example's device or ``device_fn``'s, and a checkpoint the JAX
  package wrote read back by the port;
* ``Supervisor`` and ``StragglerMonitor``: the JAX package's cases
  (``tests/test_substrate.py``, ``tests/test_runtime.py``) on the port's
  classes.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.data import DataConfig as JaxDataConfig
from repro.data import TokenDataset as JaxTokenDataset
from repro.data import write_synthetic_corpus as jax_write_corpus
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, TokenDataset, write_synthetic_corpus
from repro_torch.runtime import SimulatedFault, StragglerMonitor, Supervisor

# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

DATA_CASES = [
    dict(seq_len=16, global_batch=4, vocab=100, seed=7),
    dict(seq_len=128, global_batch=8, vocab=50257, seed=0),
    dict(seq_len=8, global_batch=8, vocab=50, n_hosts=2, host_id=1),
    dict(seq_len=8, global_batch=8, vocab=70000, seed=3, n_hosts=4, host_id=3),
]


def _equal_batches(port, ref, steps):
    for step in steps:
        a, b = port.batch(step), ref.batch(step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kw", DATA_CASES, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_synthetic_stream_bitwise(kw):
    _equal_batches(TokenDataset(DataConfig(**kw)), JaxTokenDataset(JaxDataConfig(**kw)),
                   [0, 1, 5, 1000])


@pytest.mark.parametrize("vocab", [100, 70000])
def test_memmap_corpus_bitwise(tmp_path, vocab):
    port_path = write_synthetic_corpus(str(tmp_path / "p.bin"), 10_000, vocab, seed=4)
    ref_path = jax_write_corpus(str(tmp_path / "r.bin"), 10_000, vocab, seed=4)
    assert open(port_path, "rb").read() == open(ref_path, "rb").read()
    for n_hosts, host_id in ((1, 0), (2, 1)):
        kw = dict(seq_len=32, global_batch=4, vocab=vocab, corpus_path=port_path,
                  n_hosts=n_hosts, host_id=host_id, seed=2)
        _equal_batches(TokenDataset(DataConfig(**kw)), JaxTokenDataset(JaxDataConfig(**kw)),
                       [0, 3, 77])


class TestData:
    def test_deterministic_replay(self):
        ds = TokenDataset(DataConfig(seq_len=16, global_batch=4, vocab=100, seed=7))
        np.testing.assert_array_equal(ds.batch(3)["tokens"], ds.batch(3)["tokens"])
        assert not np.array_equal(ds.batch(3)["tokens"], ds.batch(4)["tokens"])
        it = ds.iterate(3)
        np.testing.assert_array_equal(next(it)["tokens"], ds.batch(3)["tokens"])
        np.testing.assert_array_equal(next(it)["labels"], ds.batch(4)["labels"])

    def test_labels_shifted(self):
        b = TokenDataset(DataConfig(seq_len=16, global_batch=2, vocab=100)).batch(0)
        assert b["tokens"].shape == b["labels"].shape == (2, 16)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_host_sharding(self):
        h0 = TokenDataset(DataConfig(seq_len=8, global_batch=8, vocab=50, n_hosts=2, host_id=0))
        h1 = TokenDataset(DataConfig(seq_len=8, global_batch=8, vocab=50, n_hosts=2, host_id=1))
        assert h0.cfg.host_batch == 4
        assert not np.array_equal(h0.batch(0)["tokens"], h1.batch(0)["tokens"])

    def test_corpus_too_small(self, tmp_path):
        path = write_synthetic_corpus(str(tmp_path / "c.bin"), 10, 100)
        with pytest.raises(ValueError, match="too small"):
            TokenDataset(DataConfig(seq_len=32, global_batch=2, vocab=100, corpus_path=path))


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------


def _state():
    return {
        "params": {"w": torch.arange(6.0).reshape(2, 3),
                   "b16": (torch.arange(8.0).reshape(2, 4) / 3).to(torch.bfloat16)},
        "ids": torch.arange(5, dtype=torch.int32),
        "mask": torch.tensor([True, False]),
        "step": torch.tensor(5, dtype=torch.int32),
    }


def _assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        state = _state()
        mgr.save(10, state, extra_meta={"arch": "forge-125m"})
        restored, step = mgr.restore(state)
        assert step == 10
        for k in ("ids", "mask", "step"):
            _assert_same(restored[k], state[k])
        for k in ("w", "b16"):
            _assert_same(restored["params"][k], state["params"][k])

    def test_layout_is_the_references(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(7, _state())
        step_dir = tmp_path / "step_0000000007"
        assert sorted(os.listdir(step_dir)) == ["MANIFEST.json"] + [
            f"leaf_{i:05d}.npy" for i in range(5)]
        meta = json.loads((step_dir / "MANIFEST.json").read_text())
        assert meta["step"] == 7 and meta["n_leaves"] == 5
        # the JAX package's leaf order (dict keys sorted): ids, mask,
        # params.b16, params.w, step
        assert [leaf["dtype"] for leaf in meta["leaves"]] == [
            "int32", "bool", "bfloat16", "float32", "int32"]
        assert meta["leaves"][2]["shape"] == [2, 4]
        # bf16 as its raw bytes along the last axis, as the JAX package stores it
        raw = np.load(step_dir / "leaf_00002.npy")
        assert raw.dtype == np.uint8 and raw.shape == (2, 8)

    def test_reads_a_reference_checkpoint(self, tmp_path):
        """A checkpoint written by the JAX package's manager restores in the
        port, bf16 leaf included (one leaf order: sorted keys)."""
        ref = {"a": jnp.arange(6.0).reshape(2, 3), "b": jnp.ones((4,), jnp.bfloat16) / 3,
               "c": jnp.asarray(5)}
        JaxCheckpointManager(str(tmp_path), async_save=False).save(3, ref)
        example = {"a": torch.zeros(2, 3), "b": torch.zeros(4, dtype=torch.bfloat16),
                   "c": torch.zeros((), dtype=torch.int32)}
        got, step = CheckpointManager(str(tmp_path)).restore(example)
        assert step == 3
        np.testing.assert_array_equal(got["a"].numpy(), np.arange(6.0).reshape(2, 3))
        assert got["b"].dtype == torch.bfloat16
        np.testing.assert_array_equal(got["b"].float().numpy(),
                                      np.asarray(ref["b"].astype(jnp.float32)))
        assert int(got["c"]) == 5

    def test_async_and_keep_last(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last=2, async_save=True)
        state = _state()
        for s in (1, 2, 3, 4):
            mgr.save(s, state)
        mgr.wait()
        assert mgr.all_steps() == [3, 4]
        assert len(mgr.timings["snapshot_s"]) == len(mgr.timings["write_s"]) == 4

    def test_snapshot_taken_at_save(self, tmp_path):
        """A leaf written after ``save`` returns does not reach the file."""
        mgr = CheckpointManager(str(tmp_path), async_save=True)
        state = _state()
        mgr.save(1, state)
        state["params"]["w"].add_(100.0)
        mgr.wait()
        restored, _ = mgr.restore(state)
        np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                      np.arange(6.0).reshape(2, 3))

    def test_atomic_visibility(self, tmp_path):
        """A torn directory (no manifest) and a stray ``.tmp`` are invisible."""
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(1, _state())
        os.makedirs(tmp_path / "step_0000000002")  # torn: no MANIFEST
        os.makedirs(tmp_path / "step_0000000003.tmp")
        (tmp_path / "step_0000000003.tmp" / "MANIFEST.json").write_text("{}")
        assert mgr.all_steps() == [1]
        assert mgr.latest_step() == 1
        _, step = mgr.restore(_state())
        assert step == 1

    def test_write_error_raised_at_wait(self, tmp_path):
        """A write that fails on its thread (here the manifest's metadata
        cannot be serialised) surfaces once, at ``wait()``; the torn
        ``.tmp`` it leaves stays invisible."""
        mgr = CheckpointManager(str(tmp_path), async_save=True)
        mgr.save(1, {"x": torch.ones(2)})
        mgr.wait()
        mgr.save(2, {"x": torch.ones(2)}, extra_meta={"bad": object()})  # returns
        with pytest.raises(RuntimeError, match="async checkpoint save failed"):
            mgr.wait()
        mgr.wait()  # raised once
        assert os.path.isdir(tmp_path / "step_0000000002.tmp")
        assert mgr.all_steps() == [1]
        with pytest.raises(RuntimeError, match="async checkpoint save failed"):
            CheckpointManager(str(tmp_path), async_save=False).save(
                3, {"x": torch.ones(2)}, extra_meta={"bad": object()})

    def test_leaf_order_independent_of_key_order(self, tmp_path):
        """A state saved from a dict built in one key order restores into
        an example built in another (the port's inits and the bridge
        order keys differently)."""
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        state = {"b": torch.ones(3), "a": {"y": torch.zeros(2), "x": torch.arange(4)}}
        mgr.save(1, state)
        example = {"a": {"x": torch.zeros(4, dtype=torch.int64), "y": torch.ones(2)},
                   "b": torch.zeros(3)}
        restored, _ = mgr.restore(example)
        assert list(restored) == ["a", "b"] and list(restored["a"]) == ["x", "y"]
        assert torch.equal(restored["a"]["x"], torch.arange(4))
        assert torch.equal(restored["b"], torch.ones(3))

    def test_restore_waits_for_the_save_in_flight(self, tmp_path, monkeypatch):
        """A restore right after an async save (the supervisor's restore
        after a fault) finds that save's step, however slow the write."""
        import threading

        gate = threading.Event()
        save = np.save

        def slow_save(*a, **kw):
            gate.wait(timeout=10)
            return save(*a, **kw)

        mgr = CheckpointManager(str(tmp_path), async_save=True)
        mgr.save(1, {"x": torch.ones(2)})
        mgr.wait()
        monkeypatch.setattr(np, "save", slow_save)
        mgr.save(2, {"x": torch.full((2,), 2.0)})
        assert mgr.latest_step() == 1  # still writing
        threading.Timer(0.2, gate.set).start()
        restored, step = mgr.restore({"x": torch.zeros(2)})
        assert step == 2 and torch.equal(restored["x"], torch.full((2,), 2.0))

    def test_leaf_count_mismatch(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(1, {"x": torch.ones(2)})
        with pytest.raises(ValueError, match="leaf count"):
            mgr.restore({"x": torch.ones(2), "y": torch.ones(2)})

    def test_no_checkpoint(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            CheckpointManager(str(tmp_path)).restore({"x": torch.ones(1)})

    def test_restore_device(self, tmp_path):
        """Each leaf goes to its example's device, or to ``device_fn``'s."""
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        state = _state()
        mgr.save(1, state)
        restored, _ = mgr.restore(state)
        assert {t.device.type for t in torch.utils._pytree.tree_leaves(restored)} == {"cpu"}
        seen = []

        def device_fn(path, ex):
            seen.append(path)
            return torch.device("meta")

        restored, _ = mgr.restore(state, device_fn=device_fn)
        assert len(seen) == 5 and "['params']['b16']" in seen
        assert all(t.device.type == "meta" for t in torch.utils._pytree.tree_leaves(restored))
        assert len(mgr.timings["restore_s"]) == 2


# --------------------------------------------------------------------------
# the supervisor and the straggler monitor
# --------------------------------------------------------------------------


def _counting_harness(checkpoint_every=2):
    """A tiny deterministic 'training' loop: state is the running sum of
    step indices, so any replay divergence shows in the final sum."""
    saved = {"step": 0, "state": 0}

    def save_fn(step, state):
        saved["step"], saved["state"] = step, state

    return saved, dict(step_fn=lambda state, batch: (state + batch, {"loss": float(batch)}),
                       data_fn=lambda step: step, save_fn=save_fn,
                       restore_fn=lambda: (saved["state"], saved["step"]),
                       checkpoint_every=checkpoint_every)


class TestSupervisor:
    def test_clean_run(self):
        _, kw = _counting_harness()
        state, rep = Supervisor(**kw).run(0, 0, 10)
        assert state == sum(range(10))
        assert rep.steps_run == 10 and rep.failures == 0 and rep.restores == 0
        assert [h["step"] for h in rep.history] == list(range(10))

    def test_transient_fault_restores_and_replays(self):
        _, kw = _counting_harness(checkpoint_every=2)
        fired = []

        def hook(step):
            if step == 5 and not fired:
                fired.append(step)
                raise SimulatedFault("node lost")

        state, rep = Supervisor(**kw, fault_hook=hook).run(0, 0, 10)
        assert state == sum(range(10))
        assert rep.failures == 1 and rep.restores == 1 and rep.steps_run == 11
        replayed = [h["step"] for h in rep.history]
        assert replayed.count(4) == 2 and replayed.count(5) == 1

    def test_repeated_fault_escalates(self):
        _, kw = _counting_harness()

        def hook(step):
            if step == 3:
                raise SimulatedFault("persistent fault")

        with pytest.raises(RuntimeError, match="escalating"):
            Supervisor(**kw, max_retries=2, fault_hook=hook).run(0, 0, 10)

    def test_retry_budget_is_per_step(self):
        _, kw = _counting_harness(checkpoint_every=1)
        seen = set()

        def hook(step):
            if step in (2, 6) and step not in seen:
                seen.add(step)
                raise SimulatedFault(f"blip at {step}")

        state, rep = Supervisor(**kw, max_retries=1, fault_hook=hook).run(0, 0, 8)
        assert state == sum(range(8))
        assert rep.failures == 2 and rep.restores == 2

    def test_recovers_from_fault_through_checkpoints(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        state0 = {"x": torch.zeros(())}
        mgr.save(0, state0)
        fired = {"done": False}

        def fault(step):
            if step == 7 and not fired["done"]:
                fired["done"] = True
                raise SimulatedFault("boom")

        sup = Supervisor(step_fn=lambda s, b: ({"x": s["x"] + b}, {"v": float(s["x"])}),
                         data_fn=lambda s: torch.tensor(1.0), save_fn=mgr.save,
                         restore_fn=lambda: mgr.restore(state0), checkpoint_every=5,
                         fault_hook=fault)
        state, report = sup.run(state0, 0, 12)
        assert report.failures == 1 and report.restores == 1
        assert float(state["x"]) == 12.0  # steps 5/6 replayed from the step-5 checkpoint

    def test_escalates_after_retries(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        state0 = {"x": torch.zeros(())}
        mgr.save(0, state0)
        sup = Supervisor(step_fn=lambda s, b: (_ for _ in ()).throw(RuntimeError("dead")),
                         data_fn=lambda s: 1.0, save_fn=mgr.save,
                         restore_fn=lambda: mgr.restore(state0), max_retries=2)
        with pytest.raises(RuntimeError, match="escalating"):
            sup.run(state0, 0, 3)


class TestStragglerMonitor:
    def test_no_flag_before_min_samples(self):
        mon = StragglerMonitor(n_hosts=4, min_samples=5)
        for _ in range(4):
            mon.observe([1.0, 1.0, 1.0, 3.0])
        assert mon.stragglers() == []

    def test_flags_slow_host(self):
        mon = StragglerMonitor(n_hosts=4, min_samples=5, threshold=1.5)
        for _ in range(10):
            mon.observe([1.0, 1.0, 1.0, 2.0])
        assert mon.stragglers() == [3]

    def test_detects_straggler_of_eight(self):
        mon = StragglerMonitor(n_hosts=8, threshold=1.4)
        for _ in range(6):
            times = [1.0] * 8
            times[3] = 2.0
            mon.observe(times)
        assert mon.stragglers() == [3]

    def test_ewma_recovers_after_transient(self):
        mon = StragglerMonitor(n_hosts=2, alpha=0.5, min_samples=2, threshold=1.5)
        mon.observe([1.0, 5.0])
        for _ in range(12):
            mon.observe([1.0, 1.0])
        assert mon.stragglers() == []

    def test_observe_accepts_dict(self):
        mon = StragglerMonitor(n_hosts=3, min_samples=1)
        mon.observe({0: 1.0, 1: 1.0, 2: 4.0})
        assert mon.work_ratios().shape == (3,)

    def test_rebalanced_batches_sum_and_favor_fast_hosts(self):
        mon = StragglerMonitor(n_hosts=4, min_samples=1)
        for _ in range(6):
            mon.observe([1.0, 1.0, 1.0, 2.0])
        sizes = mon.rebalanced_host_batches(64)
        assert sum(sizes) == 64
        assert min(sizes[:3]) > sizes[3]

    def test_uniform_hosts_get_uniform_batches(self):
        mon = StragglerMonitor(n_hosts=4, min_samples=1)
        mon.observe([1.0, 1.0, 1.0, 1.0])
        assert mon.rebalanced_host_batches(32) == [8, 8, 8, 8]
        np.testing.assert_allclose(mon.work_ratios(), np.ones(4))
