"""Shared helpers for the PyTorch-port parity tests (``test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages;
parameters come from the JAX package's ``init`` and reach the port
through ``repro_torch.bridge`` as numpy.  JAX is imported only inside
the helpers that need it, so the card-only tests run where JAX is absent.
"""
import numpy as np
import pytest
import torch

#: the JAX package's kernel tolerances (tests/test_kernels.py)
TOL_F32 = dict(rtol=2e-4, atol=2e-5)
TOL_BF16 = dict(rtol=3e-2, atol=3e-2)
#: the passes disabled in the JAX runs: the port's pipeline has no
#: constant folding, device constants or layout pass yet
JAX_PORTED_PASSES = {"constant_folding": False, "device_constant": False,
                     "layout_optimization": False}


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
