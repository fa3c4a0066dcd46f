"""The ``segment_jit`` backend on the CPU, against the ``interpret``
backend and the JAX package's segment-aware allocation.

For each family's smoke decode and prefill programs (the contiguous
forge fronts; forge-125m's paged fronts too), built once through
Phases 1-3:

* ``segment_jit`` outputs are bitwise equal to ``interpret``'s on the
  same inputs (the interpret executor is built from the same lowered
  program, :meth:`CompiledModule.with_backend`);
* a call makes exactly ``n_segments`` (= δ_after + 1) segment dispatches;
* registers whose whole life lies inside one segment hold no slot in the
  buffer file, and the segment-aware linear scan equals the JAX
  package's ``repro.core.bufalloc.allocate`` on the same lifetimes and
  pins;
* every segment's live-ins come from the program inputs, its constants
  or an earlier segment's live-outs.

The JAX ``segment_jit`` backend itself fails on jax 0.9.0 (ROADMAP queue
3), so its outputs are never the reference here.
"""
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.core.bufalloc import allocate as jax_allocate
from repro_torch.configs import get_config
from repro_torch.core import ForgeCompiler
from repro_torch.core.backends import SegmentExecutor, available_backends
from repro_torch.core.compiler import _static_inputs
from repro_torch.launch.serve import BatchedServer
from repro_torch.models import get_model

ARCHS = ["forge-125m", "recurrentgemma-2b", "xlstm-350m"]


def _server(arch, paged=False):
    cfg = get_config(arch, smoke=True).with_(dtype="float32")
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")
    kw = dict(paged=True, kv_page_size=8, seq_bucket_policy="ladder:8,16") if paged else {}
    srv = BatchedServer(cfg, params, max_len=32, mode="forge", **kw)
    srv.warmup([2], prompt_lens=[6])
    return srv


def _inputs(srv, kind, seed):
    """A program's arguments with random tokens and state (B 2; prefill
    S 8 paged, S 16 contiguous)."""
    g = torch.Generator().manual_seed(seed)
    vocab = srv.cfg.vocab
    if srv.paged:
        store = {k: torch.randn(v.shape, generator=g) for k, v in srv.page_store.items()}
        S = 1 if kind == "decode" else 8
        pt = torch.tensor([[1, 2, 3, 0], [4, 5, 6, 0]], dtype=torch.int32)
        return (store, pt, torch.randint(0, vocab, (2, S), generator=g, dtype=torch.int32),
                torch.tensor([3, 9], dtype=torch.int32), torch.tensor([True, True]))
    cache = pytree.tree_map(lambda v: torch.randn(v.shape, generator=g).to(v.dtype)
                            if v.is_floating_point() else v, srv._build_cache(2))
    if kind == "decode":
        tok = torch.randint(0, vocab, (2, 1), generator=g, dtype=torch.int32)
        return (cache,) + srv._decode_args(2, tok, 5)
    toks = torch.randint(0, vocab, (2, 16), generator=g, dtype=torch.int32)
    return (cache,) + srv._prefill_args(2, toks, 0, lengths=np.asarray([16, 9], np.int32))


CASES = [(a, k, False) for a in ARCHS for k in ("decode", "prefill")] + [
    ("forge-125m", "decode", True), ("forge-125m", "prefill", True)]


@pytest.fixture(scope="module")
def servers():
    return {}


@pytest.fixture(params=CASES, ids=lambda c: f"{c[0]}-{c[1]}" + ("-paged" if c[2] else ""))
def program(request, servers):
    arch, kind, paged = request.param
    srv = servers.get((arch, paged))
    if srv is None:
        srv = servers[(arch, paged)] = _server(arch, paged)
    front = srv.bucketed if kind == "decode" else srv.prefill_bucketed
    (mod,) = front.programs.values()
    return srv, kind, mod


def test_segment_jit_bitwise_equals_interpret(program):
    srv, kind, mod = program
    assert isinstance(mod.executor, SegmentExecutor) and mod.result.backend == "segment_jit"
    ref = mod.with_backend("interpret")
    assert ref.capture is mod.capture and ref.result.backend == "interpret"
    for seed in (1, 2):
        args = _inputs(srv, kind, seed)
        got = pytree.tree_leaves(mod(srv.params, *args))
        want = pytree.tree_leaves(ref(srv.params, *args))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_one_dispatch_per_segment(program):
    srv, kind, mod = program
    s = mod.stats
    assert s.n_segments == s.delta_after + 1 == len(mod.executor.segments)
    assert s.n_compiled_segments == s.n_segments
    assert s.n_segments < s.n_instructions
    calls, total = s.total_calls, s.total_segments_executed
    mod(srv.params, *_inputs(srv, kind, 3))
    assert s.total_calls == calls + 1
    assert s.last_segments_executed == s.n_segments
    assert s.total_segments_executed == total + s.n_segments


def test_internal_registers_hold_no_slot(program):
    _, _, mod = program
    ex = mod.executor
    assert ex._internal and ex.stats.n_internal_regs == len(ex._internal)
    r2b = ex.alloc.reg_to_buf
    assert not ex._internal & set(r2b)
    n = len(ex.prog.ops)
    seg_of = {i: s.index for s in ex.segments for i in range(s.start, s.stop)}
    for r, (s, e) in ex.live.intervals.items():
        if r in ex._internal:
            assert 0 <= s and e < n and seg_of[s] == seg_of[e]
        else:
            assert r in r2b
    # no two buffer-file registers live at once share a slot
    by_buf = {}
    for r, b in r2b.items():
        by_buf.setdefault(b, []).append(ex.live.intervals[r])
    for ivs in by_buf.values():
        ivs.sort()
        assert all(a[1] < b[0] for a, b in zip(ivs, ivs[1:]))


def test_allocation_equals_jax_bufalloc(program):
    _, _, mod = program
    ex = mod.executor
    lifetimes = {r: iv for r, iv in ex.live.intervals.items() if r not in ex._internal}
    pinned = set(ex.live.pinned) | {r for r, (s, _) in lifetimes.items() if s < 0}
    want = jax_allocate(lifetimes, pinned)
    assert ex.alloc.reg_to_buf == want.reg_to_buf
    assert ex.alloc.n_buffers == want.n_buffers < len(lifetimes)


def test_live_ins_come_from_inputs_or_earlier_segments(program):
    _, _, mod = program
    ex = mod.executor
    available = set(ex.prog.input_regs) | set(ex.prog.constants)
    for seg in ex.segments:
        assert set(seg.live_in) <= available, f"segment {seg.index}"
        available |= set(seg.live_out)
        assert not set(seg.live_out) & ex._internal
    assert set(ex.prog.output_regs) <= available


def test_params_are_the_static_inputs(program):
    srv, _, mod = program
    names = mod.input_names
    n_params = len({id(t) for t in pytree.tree_leaves(srv.params)})
    assert len(mod.static_inputs) == n_params
    assert mod.static_inputs == tuple(range(n_params))  # params come first
    assert all(names[i].startswith("args[0]") for i in mod.static_inputs)
    assert not any(names[i].startswith("args[0]") for i in range(n_params, len(names)))


def test_static_inputs_skip_tied_duplicates():
    w, x = torch.ones(3), torch.zeros(3)
    params = {"a": w, "b": w, "c": torch.ones(2)}
    prog = ForgeCompiler(backend="segment_jit").compile(
        lambda p, x_: p["a"] * x_ + p["b"] + p["c"].sum(), params, x, static_argnums=(0,))
    static, names = _static_inputs(prog.capture, (params, x), (0,))
    assert static == (0, 1) and names == ["args[0]['a']", "args[0]['c']", "args[1]"]
    assert prog.static_inputs == static
    assert torch.equal(prog(params, x), w * x + w + 2)


def test_backend_registered_and_cpu_call_needs_no_capture():
    assert "segment_jit" in available_backends()
    mod = ForgeCompiler(backend="segment_jit").compile(lambda a, b: torch.relu(a @ b) + 1,
                                                       torch.ones(2, 3), torch.ones(3, 2))
    assert not mod.executor.captured and mod.result.capture_s == 0.0
    assert torch.equal(mod(torch.ones(2, 3), torch.ones(3, 2)), torch.full((2, 2), 4.0))
    with pytest.raises(TypeError):
        mod.executor.execute(torch.ones(2, 3))
