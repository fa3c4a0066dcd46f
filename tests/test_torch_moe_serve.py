"""Serving the MoE family (phi3.5-moe-42b-a6.6b, kimi-k2-1t-a32b smoke,
f32, the JAX package's parameters) in the port, against the JAX
package's servers:

* greedy tokens of the interpret and the jit server equal to the JAX
  ``mode="jit"`` server's, and of the contiguous forge fronts equal to
  the JAX ``mode="forge"`` (interpret) server's; every front prefills
  sequentially (capacity routing couples the tokens of a block);
* a served decode dispatch under ``segment_jit`` bitwise equal to the
  same lowered program under ``interpret``;
* the contiguous and the paged ``SlotScheduler``: every request's tokens
  and ticks and the scheduling metrics equal to the JAX schedulers' (both
  on ``interpret``).  Capacity is shared by every row of a dispatch, so
  the comparison is schedule against schedule, never per request.

The JAX package's schedulers run with every host array copied as it is
uploaded (:func:`_snapshot_uploads`): on the CPU ``jnp.asarray`` may share
a numpy array's memory, and the scheduler edits its host arrays (a
retired row's page table) while a dispatch that read them may still be
pending, so what the device sees depends on timing.  Inactive rows take
expert capacity from live ones, so for MoE that moves live rows' tokens:
kimi-k2's paged schedule came out two ways in six concurrent processes,
and the same in twelve with the copies.  The copies give the snapshot a
device upload has on the card, which the port's scheduler implements.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import BatchedServer as JaxBatchedServer
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import SlotScheduler as JaxSlotScheduler
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch.serve import BatchedServer, Request, SlotScheduler

from torch_port_support import (PAGED_METRICS, jax_paged_run, jax_params, port_paged_run,
                                port_params)

ARCHS = ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"]
MAX_LEN = 32
METRICS = ("decode_dispatches", "prefill_dispatches", "swaps", "resizes", "idle_ticks",
           "occupied_row_steps", "capacity_row_steps", "compiles", "real_tokens")
WORKLOAD = [(3, 6, 0), (5, 2, 0), (4, 3, 1), (20, 3, 2), (11, 4, 14), (7, 2, 14)]
FIELDS = ("admitted_tick", "finished_tick", "swapped_in")


@contextlib.contextmanager
def _snapshot_uploads():
    """The JAX package's serve loop with ``jnp.asarray`` copying numpy
    arrays (see the module's note)."""
    import jax.numpy as jnp
    from repro.launch import serve as jax_serve

    class CopyingJnp:
        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def asarray(a, *args, **kw):
            return jnp.asarray(np.array(a) if isinstance(a, np.ndarray) else a, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_serve, "jnp", CopyingJnp())
        yield


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    cfg = get_config(arch, smoke=True).with_(dtype="float32")
    jcfg = jax_get_config(arch, smoke=True).with_(dtype="float32")
    jp = jax_params(jcfg)
    return cfg, jcfg, jp, port_params(jp)


@pytest.fixture(scope="module")
def jax_tokens(setup):
    _, jcfg, jp, _ = setup
    prompts = _tokens((3, 6), 0)
    jit = JaxBatchedServer(jcfg, jp, max_len=MAX_LEN, mode="jit").generate(prompts, 4)
    forge = JaxBatchedServer(jcfg, jp, max_len=MAX_LEN, mode="forge",
                             backend="interpret").generate(prompts, 4)
    assert forge["prefill_mode"] == "sequential"
    return np.asarray(jit["tokens"]), np.asarray(forge["tokens"])


@pytest.mark.parametrize("mode", ["interpret", "jit"])
def test_unbucketed_servers_equal_jax_jit(setup, jax_tokens, mode):
    cfg, _, _, p = setup
    r = BatchedServer(cfg, p, max_len=MAX_LEN, mode=mode).generate(_tokens((3, 6), 0), 4)
    assert r["prefill_mode"] == "sequential"
    np.testing.assert_array_equal(r["tokens"], jax_tokens[0])


@pytest.fixture(scope="module")
def forge_server(setup):
    cfg, _, _, p = setup
    return BatchedServer(cfg, p, max_len=MAX_LEN, mode="forge")


def test_forge_fronts_equal_jax_forge(forge_server, jax_tokens):
    r = forge_server.generate(_tokens((3, 6), 0), 4)
    assert r["prefill_mode"] == "sequential" and forge_server.prefill_bucketed is None
    np.testing.assert_array_equal(r["tokens"], jax_tokens[1])


def test_segment_jit_bitwise_interpret(setup, forge_server):
    from torch.utils import _pytree as pytree

    cfg, _, _, p = setup
    srv = forge_server
    prompts = _tokens((4, 5), 5)
    cache, tok, pos, _, dkey = srv.prefill(prompts)
    dmod = srv.bucketed.programs[dkey]
    assert dmod.result.backend == "segment_jit"
    dargs = (p, cache) + srv._decode_args(4, tok, pos)
    got, want = dmod(*dargs), dmod.with_backend("interpret")(*dargs)
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    srv._release_cache(dkey.extent, cache)


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


def test_contiguous_scheduler_equals_jax(setup):
    cfg, jcfg, jp, p = setup
    got = _sched_run(BatchedServer, SlotScheduler, Request, cfg, p)
    with _snapshot_uploads():
        want = _sched_run(JaxBatchedServer, JaxSlotScheduler, JaxRequest, jcfg, jp,
                          backend="interpret")
    _same_requests(got, want, FIELDS)
    assert {k: got[k] for k in METRICS} == {k: want[k] for k in METRICS}
    assert got["prefill_dispatches"] == 0 and got["swaps"] >= 1


def test_paged_scheduler_equals_jax(setup):
    cfg, jcfg, jp, p = setup
    got, srv = port_paged_run(cfg, p)
    with _snapshot_uploads():
        want = jax_paged_run(jcfg, jp)
    _same_requests(got, want, FIELDS)
    assert {k: got[k] for k in PAGED_METRICS} == {k: want[k] for k in PAGED_METRICS}
    assert got["prefill_dispatches"] == 0 and srv.prefill_bucketed is None
    # no page leaked: beside the trash page only the prefix tree holds any
    srv.page_pool.check()
    assert srv.page_pool.pages_in_use == 1 + srv.prefix_tree.cached_pages


def test_cli_moe_smoke_on_cpu(capsys):
    assert serve.main(["--arch", "phi3.5-moe-42b-a6.6b", "--smoke", "--device", "cpu",
                       "--mode", "forge", "--continuous", "6", "--max-slots", "4",
                       "--paged", "--kv-kernel", "pallas", "--prompt-len", "8", "--gen", "4",
                       "--max-len", "32"]) == 0
    out = capsys.readouterr().out
    assert "continuous n=6" in out and "prefill programs=0" in out
