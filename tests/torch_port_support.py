"""Shared helpers for the PyTorch-port parity tests (``test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages;
parameters come from the JAX package's ``init`` and reach the port
through ``repro_torch.bridge`` as numpy.  JAX is imported only inside
the helpers that need it, so the card-only tests run where JAX is absent.
"""
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

#: the JAX package's kernel tolerances (tests/test_kernels.py)
TOL_F32 = dict(rtol=2e-4, atol=2e-5)
TOL_BF16 = dict(rtol=3e-2, atol=3e-2)


def to_numpy(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def as_np(x):
    """A torch tensor or jax array as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def jax_params(cfg_jax, seed: int = 0):
    import jax
    from repro.models import get_model

    return get_model(cfg_jax).init(jax.random.PRNGKey(seed), cfg_jax)


def port_params(jparams):
    from repro_torch import bridge

    return bridge.params_from_numpy(to_numpy(jparams), device="cpu")


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`PYTHONPATH=src python -m pytest -q --noconftest -m cuda "
                    "tests/test_torch_cuda.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# --------------------------------------------------------------------------
# the paged slot-scheduler fidelity workload (the JAX package's
# tests/test_paged_kv.py::TestPagedSchedulerFidelity)
# --------------------------------------------------------------------------

PAGED_MAX_LEN, PAGED_PS = 32, 8
#: scheduler metrics that must be equal between the port and the JAX package
PAGED_METRICS = ("swaps", "resizes", "prefix_hits", "tokens_reused", "deferrals",
                 "decode_dispatches", "prefill_dispatches", "kv_pages_in_use",
                 "kv_peak_pages_in_use", "occupied_row_steps", "capacity_row_steps")


def _paged_tokens(n, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (n,)).astype(np.int32)


def paged_workload(request_cls, vocab):
    """8 requests arriving 3 per tick: every third shares a 16-token
    (2-page) prefix, so the prefix tree hits; ragged budgets force
    mid-generation swap-ins and a rung resize."""
    shared = _paged_tokens(16, 20, vocab)
    reqs = []
    for i in range(8):
        if i % 3 == 0:
            p = np.concatenate([shared, _paged_tokens(4, 30 + i, vocab)])
        else:
            p = _paged_tokens(3 + 2 * (i % 5), 40 + i, vocab)
        reqs.append(request_cls(rid=i, prompt=p, max_new=2 + (3 * i) % 5, arrival=i // 3))
    return reqs


def run_paged_scheduler(server_cls, sched_cls, request_cls, cfg, params, *, warmup=True,
                        **server_kw):
    """One paged SlotScheduler run on the workload (max_slots 4, page 8,
    max_len 32, sequence ladder 8/16/32); returns (result, server)."""
    srv = server_cls(cfg, params, max_len=PAGED_MAX_LEN, mode="forge", backend="interpret",
                     seq_bucket_policy="ladder:8,16,32", paged=True, kv_page_size=PAGED_PS,
                     **server_kw)
    sched = sched_cls(srv, max_slots=4)
    if warmup:
        sched.warmup(prompt_lens=[4, 8, 16, 24])
    return sched.run(paged_workload(request_cls, cfg.vocab)), srv


def jax_paged_run(jcfg, jparams, **server_kw):
    """The JAX package's paged scheduler (kv_kernel "ref", interpret
    backend) on the workload."""
    from repro.launch.serve import BatchedServer, Request, SlotScheduler

    res, _ = run_paged_scheduler(BatchedServer, SlotScheduler, Request, jcfg, jparams,
                                 **server_kw)
    return res


def port_paged_run(cfg, params, **kw):
    from repro_torch.launch.serve import BatchedServer, Request, SlotScheduler

    return run_paged_scheduler(BatchedServer, SlotScheduler, Request, cfg, params, **kw)


# --------------------------------------------------------------------------
# the training path (tests/test_torch_train*.py)
# --------------------------------------------------------------------------

#: one smoke config of each family the train step is held on
TRAIN_ARCHS = ["forge-125m", "qwen2.5-14b", "recurrentgemma-2b", "xlstm-350m",
               "phi3.5-moe-42b-a6.6b", "seamless-m4t-large-v2", "qwen2-vl-72b"]
TRAIN_B, TRAIN_S, TRAIN_FRAMES, TRAIN_PATCHES = 2, 8, 6, 4


def train_batch_np(cfg, seed=0, step=0):
    """A training batch from ``TokenDataset`` (plus N(0, 1) frames for the
    encoder-decoder family; patches ahead of the text for the VLM, whose
    positions carry no label)."""
    from repro_torch.data import DataConfig, TokenDataset

    B = TRAIN_B
    b = TokenDataset(DataConfig(seq_len=TRAIN_S, global_batch=B, vocab=cfg.vocab,
                                seed=seed)).batch(step)
    rng = np.random.default_rng(100 + step)
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal((B, TRAIN_FRAMES, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["patches"] = rng.standard_normal((B, TRAIN_PATCHES, cfg.d_model)).astype(np.float32)
        b["labels"] = np.concatenate([np.full((B, TRAIN_PATCHES), -1, np.int32), b["labels"]], 1)
    return b


def train_batch_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def train_batch_jax(b):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in b.items()}


class TrainSetup:
    """``arch``'s smoke config in f32 in both packages, the JAX package's
    parameters and the port's (bridged)."""

    def __init__(self, arch):
        from repro.configs import get_config as jax_get_config
        from repro_torch.configs import get_config

        self.arch = arch
        self.cfg = get_config(arch, smoke=True).with_(dtype="float32")
        self.jcfg = jax_get_config(arch, smoke=True).with_(dtype="float32")
        self.jp = jax_params(self.jcfg)
        self.p = port_params(self.jp)

    def to_port(self, jtree):
        return port_params(jtree)


# --------------------------------------------------------------------------
# the train step compiled whole (tests/test_torch_train_jit*.py)
# --------------------------------------------------------------------------


def jax_jit_losses(setup, jax_opt, batches):
    """Each step's loss of the JAX package's ``jax.jit(make_train_step(...),
    donate_argnums=(0, 1))`` from ``setup``'s parameters (copied first:
    the step donates them) over the numpy ``batches``."""
    import warnings

    import jax
    from repro.launch import steps as jax_steps

    step = jax.jit(jax_steps.make_train_step(setup.jcfg, jax_opt), donate_argnums=(0, 1))
    params = jax_steps.dealias_tree(setup.jp)
    state = jax_steps.dealias_tree(jax_opt.init(params))
    out = []
    with warnings.catch_warnings():
        # a backend that cannot donate says so, and copies
        warnings.filterwarnings("ignore", message="Some donated buffers were not usable")
        for b in batches:
            params, state, m = step(params, state, train_batch_jax(b))
            out.append(float(m["loss"]))
    return out


def leaf_ptrs(tree):
    return [t.data_ptr() for t in pytree.tree_leaves(tree)]


def jit_train_run(setup, step, optimizer, n=3):
    """``n`` steps of the compiled ``step`` from ``setup``'s parameters:
    the losses, every step's leaf storage pointers, the Dynamo graphs
    the run compiled, and whether the caller's trees were left as they
    were."""
    from torch._dynamo.utils import counters

    batches = [train_batch_np(setup.cfg, step=i) for i in range(n)]
    params, state = setup.p, optimizer.init(setup.p)
    before = [t.clone() for t in pytree.tree_leaves((params, state))]
    graphs0 = counters["stats"]["unique_graphs"]
    losses, ptrs = [], []
    p, s = params, state
    for b in batches:
        p, s, m = step(p, s, train_batch_torch(b))
        losses.append(float(m["loss"]))
        ptrs.append(leaf_ptrs((p, s)))
    untouched = all(torch.equal(a, b) for a, b in zip(before, pytree.tree_leaves((params, state))))
    return {"batches": batches, "losses": losses, "ptrs": ptrs, "untouched": untouched,
            "unique_graphs": counters["stats"]["unique_graphs"] - graphs0}


def assert_one_graph(step, run):
    """The run compiled the loss and the update once each (Dynamo's
    counters), Inductor the forward, the backward and the update once
    each, and the storage of every leaf never moved."""
    assert run["unique_graphs"] == 2 and step.graphs == 2, (run["unique_graphs"], step.graphs)
    assert step.programs == {"forward": 1, "backward": 1, "update": 1}, step.programs
    assert all(p == run["ptrs"][0] for p in run["ptrs"])
    assert run["ptrs"][0] == leaf_ptrs(step.state)
