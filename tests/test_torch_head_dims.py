"""The head dims the JAX package's attention kernels serve beyond 64 (96
for phi3, 112 for kimi-k2, 128, 256 for recurrentgemma), through the
port's fronts against the JAX kernels in interpret mode.

``ops.sdpa`` (the flash route: unmasked, several query rows) and
``paged_attention`` take the same numpy inputs as
``repro.kernels.ops.sdpa(impl="interpret")`` and
``repro.kernels.paged_attention.paged_attention(interpret=True)``; f32
within rtol 2e-4 / atol 2e-5.  On the CPU the port's fronts take their
plain versions; the CUDA kernels at these dims are held against those
plain versions on the card (``test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.paged_attention import paged_attention as jax_paged_attention
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA

from torch_port_support import TOL_F32, as_np

#: the JAX flash kernel's head dims past 64 (src/repro/kernels/flash_attention.py)
NEW_DIMS = [96, 112, 128, 256]


def test_the_wrappers_take_every_head_dim_of_the_jax_kernels():
    for D in (64, 96, 112, 128, 256):
        assert D in FA.HEAD_DIMS and D in PA.HEAD_DIMS


@pytest.mark.parametrize("D", NEW_DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,KVH,Sq,Sk", [(1, 8, 2, 24, 24),  # GQA 4
                                           (2, 4, 1, 16, 40)])  # MQA, Sq < Sk
def test_sdpa_flash_route_matches_jax_kernel(D, causal, B, H, KVH, Sq, Sk):
    rng = np.random.default_rng(D + Sq + int(causal))
    q = (rng.standard_normal((B, H, Sq, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, KVH, Sk, D)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, KVH, Sk, D)) * 0.5).astype(np.float32)
    got = ops.sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                   causal=causal, groups=H // KVH)
    want = jops.sdpa(q, k, v, causal=causal, groups=H // KVH, impl="interpret")
    assert tuple(got.shape) == (B, H, Sq, D)
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL_F32)


@pytest.mark.parametrize("D", NEW_DIMS)
@pytest.mark.parametrize("window", [None, 12])
def test_paged_attention_matches_jax_kernel(D, window):
    """GQA 8/2 over non-contiguous tables; positions at a page edge, mid
    page and the table's last slot, and one row that sees no key."""
    B, H, KVH, ps, MP = 4, 8, 2, 8, 4
    rng = np.random.default_rng(D + (window or 0))
    NP = 1 + B * MP
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((NP, ps, KVH, D)).astype(np.float32)
    v = rng.standard_normal((NP, ps, KVH, D)).astype(np.float32)
    pt = np.stack([1 + b * MP + rng.permutation(MP) for b in range(B)]).astype(np.int32)
    pos = np.asarray([ps - 1, 13, MP * ps - 1, -1], np.int32)
    got = PA.paged_attention(*(torch.from_numpy(a) for a in (q, k, v, pt, pos)),
                             window=window)
    want = jax_paged_attention(*(jnp.asarray(a) for a in (q, k, v, pt, pos)),
                               window=window, interpret=True)
    assert tuple(got.shape) == (B, H, D)
    np.testing.assert_allclose(as_np(got), np.asarray(want), **TOL_F32)
    assert not bool(got[3].any())  # pos = -1: no key, zeros
