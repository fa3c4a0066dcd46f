"""``BatchedServer(mode="jit")`` — the serve step compiled whole with
``torch.compile(fullgraph=True, dynamic=False)`` — against the JAX
package's ``mode="jit"`` server and the port's ``mode="interpret"``.

On the f32 smoke configs of forge-125m, qwen2.5-14b, recurrentgemma-2b
and xlstm-350m (parameters from the JAX package's ``init``, prompts from
numpy seed 0):

* greedy tokens equal to the JAX jit server's and to the port's
  interpret server's;
* every compiled step's logits (Forge-compiled block bodies traced into
  the one graph) within rtol 2e-4 / atol 2e-5 of the jitted JAX decode
  step's, position by position;
* one graph per batch size, with the kernels' custom ops inside it (the
  dense decoders), and no recompile across generations;
* the cache updated in place: its storage pointers stay the same across
  steps and generations, as the JAX server donates it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_config as jax_get_config
from repro.launch.serve import BatchedServer as JaxBatchedServer
from repro.models import get_model as jax_get_model
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch.serve import BatchedServer, JitServeStep
from repro_torch.models import transformer as T

from torch_port_support import TOL_F32, as_np, jax_params, port_params

ARCHS = ["forge-125m", "qwen2.5-14b", "recurrentgemma-2b", "xlstm-350m"]
MAX_LEN = 32
N_NEW = 4


def _prompts(shape=(3, 6), seed=0):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    cfg = get_config(arch, smoke=True).with_(dtype="float32")
    jcfg = jax_get_config(arch, smoke=True).with_(dtype="float32")
    jp = jax_params(jcfg)
    return cfg, jcfg, jp, port_params(jp)


@pytest.fixture(scope="module")
def jit_run(setup):
    """A jit server's first generation, with the cache's storage read
    before the prefill and after every step, and every step's logits."""
    cfg, _, _, p = setup
    server = BatchedServer(cfg, p, max_len=MAX_LEN, mode="jit")
    step = server.jit_step(3)
    ptrs = [[t.untyped_storage().data_ptr() for t in pytree.tree_leaves(step.cache)]]
    logits = []
    real_call = JitServeStep.__call__

    def watched(self, *a):
        out = real_call(self, *a)
        ptrs.append([t.untyped_storage().data_ptr() for t in pytree.tree_leaves(self.cache)])
        logits.append(self.last_logits())
        return out

    JitServeStep.__call__ = watched
    try:
        res = server.generate(_prompts(), N_NEW)
    finally:
        JitServeStep.__call__ = real_call
    return server, res, ptrs, logits


def test_tokens_equal_jax_jit_and_interpret(setup, jit_run):
    cfg, jcfg, jp, p = setup
    _, res, _, _ = jit_run
    want = JaxBatchedServer(jcfg, jp, max_len=MAX_LEN, mode="jit").generate(_prompts(), N_NEW)
    interp = BatchedServer(cfg, p, max_len=MAX_LEN, mode="interpret").generate(_prompts(), N_NEW)
    np.testing.assert_array_equal(res["tokens"], np.asarray(want["tokens"]))
    np.testing.assert_array_equal(res["tokens"], interp["tokens"])
    assert res["tokens"].shape == (3, N_NEW) and res["prefill_mode"] == "sequential"


def test_cache_updated_in_place(jit_run):
    server, _, ptrs, _ = jit_run
    step = server.jit_steps[3]
    assert len(ptrs) == 6 + N_NEW  # before, then after each of P + N_NEW - 1 steps
    assert all(p == ptrs[0] for p in ptrs)
    k = pytree.tree_leaves(step.cache)[0]
    assert bool(k.abs().sum() > 0)  # the steps wrote K/V into it
    server.generate(_prompts(seed=1), 2)
    assert [t.untyped_storage().data_ptr() for t in pytree.tree_leaves(step.cache)] == ptrs[0]


def test_one_graph_with_the_kernels(setup, jit_run):
    cfg, _, _, _ = setup
    server, res, _, _ = jit_run
    step = server.jit_steps[3]
    assert step.graphs == 1 and step.graph_nodes > 0
    if cfg.family == "dense":
        # forge-125m: q/k/v/o and the FFN's two products fuse; qwen's
        # swiglu bodies add the gate/up pair (one node) and its biased q,
        # k, v stay matmul + add, as in the reference
        assert step.kernel_nodes.get("fused_linear", 0) >= 2 * cfg.n_layers
    else:
        # the recurrent families' decode step calls no compiled block
        # body, in the reference as here: the graph holds no kernel node
        assert step.kernel_nodes == {}
    assert step.compile_s > 0 and res["compile_s"] == pytest.approx(step.compile_s)
    again = server.generate(_prompts(), N_NEW)
    np.testing.assert_array_equal(again["tokens"], res["tokens"])
    assert step.graphs == 1 and again["compile_s"] == 0.0


def test_step_logits_equal_jax(setup, jit_run):
    """Each jit step's last-position logits against the jitted JAX decode
    step fed the same tokens (the prompt, then the generated ones)."""
    cfg, jcfg, jp, p = setup
    _, res, _, logits = jit_run
    prompts = _prompts()
    feed = np.concatenate([prompts, res["tokens"][:, :-1]], axis=1)
    jm = jax_get_model(jcfg)
    jstep = jax.jit(lambda c, t, pos: jm.decode_step(jp, c, t, pos, jcfg))
    jcache = jm.init_cache(jcfg, 3, MAX_LEN)
    assert len(logits) == feed.shape[1]
    for i in range(feed.shape[1]):
        jlogits, jcache = jstep(jcache, jnp.asarray(feed[:, i:i + 1]), jnp.int32(i))
        np.testing.assert_allclose(as_np(logits[i]), as_np(jlogits[:, -1]), **TOL_F32)


def test_modes_and_defaults(setup):
    cfg, _, _, p = setup
    assert BatchedServer.MODES == ("jit", "interpret", "forge")
    assert BatchedServer(cfg, p, max_len=MAX_LEN).mode == "jit"
    with pytest.raises(ValueError):
        BatchedServer(cfg, p, max_len=MAX_LEN, mode="eager")
    for kw in (dict(paged=True), dict(async_compile=True), dict(cache_dir="unused")):
        with pytest.raises(ValueError, match="forge"):
            BatchedServer(cfg, p, max_len=MAX_LEN, mode="jit", **kw)
    step = BatchedServer(cfg, p, max_len=MAX_LEN, mode="jit").jit_step(2)
    with pytest.raises(ValueError, match="owns"):
        step(p, T.init_cache(cfg, 2, MAX_LEN, device="cpu"), torch.zeros((2, 1)), 0)


def test_cli_defaults_to_jit(capsys, monkeypatch):
    seen = []
    real = serve.BatchedServer.__init__

    def spy(self, *a, **k):
        real(self, *a, **k)
        seen.append(self.mode)

    monkeypatch.setattr(serve.BatchedServer, "__init__", spy)
    assert serve.main(["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "3",
                       "--gen", "2", "--max-len", "16"]) == 0
    out = capsys.readouterr().out
    assert seen == ["jit"] and "jit batch=2: graphs=1" in out
