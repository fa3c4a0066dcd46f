"""The port's kernel dispatch (``repro_torch.kernels.ops``) against the JAX
package's (``repro.kernels.ops`` with ``impl="interpret"``: the Pallas
kernels in interpret mode), on the same numpy inputs.

On the CPU the port's wrappers take their plain versions; the CUDA
kernels are held against those plain versions on the card by
``test_torch_cuda.py``.
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_linear as FL
from repro_torch.kernels import ops, ref

from torch_port_support import TOL_BF16, TOL_F32, as_np

ROOT = Path(__file__).resolve().parents[1]
ACTS = [None, "relu", "silu", "gelu", "gelu_exact", "tanh"]


def _qkv(seed, B, H, KVH, Sq, Sk, D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, Sq, D)) * 0.5).astype(dtype)
    k = (rng.standard_normal((B, KVH, Sk, D)) * 0.5).astype(dtype)
    v = (rng.standard_normal((B, KVH, Sk, D)) * 0.5).astype(dtype)
    return q, k, v


class TestSdpaParity:
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize(
        "B,H,KVH,Sq,Sk,D",
        [
            (1, 4, 4, 32, 32, 16),  # MHA square
            (2, 4, 2, 32, 32, 8),  # GQA
            (1, 8, 1, 64, 64, 32),  # MQA
            (1, 2, 2, 16, 64, 16),  # Sq < Sk: causal offset Sk - Sq
            (1, 2, 2, 1, 64, 16),  # single-query decode (plain path on both sides)
        ],
    )
    def test_sweep_f32(self, causal, B, H, KVH, Sq, Sk, D):
        q, k, v = _qkv(0, B, H, KVH, Sq, Sk, D)
        got = ops.sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                       causal=causal, groups=H // KVH)
        want = jops.sdpa(q, k, v, causal=causal, groups=H // KVH, impl="interpret")
        np.testing.assert_allclose(as_np(got), as_np(want), **TOL_F32)

    def test_bf16(self):
        q, k, v = _qkv(1, 1, 2, 2, 32, 32, 16)
        tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
        got = ops.sdpa(tq, tk, tv, causal=True)
        want = jops.sdpa(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True,
                         impl="interpret")
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(as_np(got), as_np(want), **TOL_BF16)

    @pytest.mark.parametrize("scale_mode", ["mul", "div"])
    def test_scale_modes(self, scale_mode):
        q, k, v = _qkv(2, 1, 2, 2, 16, 16, 8)
        got = ops.sdpa(*(torch.from_numpy(a) for a in (q, k, v)), scale=2.5,
                       scale_mode=scale_mode)
        want = jops.sdpa(q, k, v, scale=2.5, scale_mode=scale_mode, impl="interpret")
        np.testing.assert_allclose(as_np(got), as_np(want), **TOL_F32)

    def test_additive_mask_takes_plain_path(self):
        """A masked call never reaches flash (``ops.py:171`` routing)."""
        q, k, v = _qkv(3, 2, 2, 2, 1, 16, 8)
        idx = np.arange(16)[None, None, None, :]
        mask = np.where(idx <= np.array([5, 11])[:, None, None, None], 0.0,
                        np.finfo(np.float32).min).astype(np.float32)
        FA.LAUNCHES.reset()
        got = ops.sdpa(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask))
        want = jops.sdpa(q, k, v, mask, impl="interpret")
        np.testing.assert_allclose(as_np(got), as_np(want), **TOL_F32)
        assert FA.LAUNCHES.n == 0

    def test_out_dtype_cast_after(self):
        q, k, v = _qkv(4, 1, 2, 2, 8, 8, 8)
        got = ops.sdpa(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                       out_dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16

    def test_impl_ref_matches_default_on_cpu(self):
        q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 4, 2, 16, 16, 8))
        a = ops.sdpa(q, k, v, causal=True, groups=2)
        b = ops.sdpa(q, k, v, causal=True, groups=2, impl="ref")
        np.testing.assert_allclose(as_np(a), as_np(b), **TOL_F32)

    def test_chunked_plain_path_matches_direct(self, monkeypatch):
        """Masked long-sequence attention runs in query chunks; the causal
        alignment and the mask rows must follow each chunk."""
        q, k, v = (torch.from_numpy(a) for a in _qkv(12, 1, 2, 2, 16, 24, 8))
        mask = torch.from_numpy(np.random.default_rng(13).standard_normal(
            (1, 1, 16, 24)).astype(np.float32))
        direct = ops.sdpa(q, k, v, mask, causal=True)
        monkeypatch.setattr(ops, "_CHUNK_THRESHOLD", 0)
        chunked = ops.sdpa(q, k, v, mask, causal=True, q_chunk=4)
        np.testing.assert_allclose(chunked.numpy(), direct.numpy(), rtol=1e-6, atol=1e-6)

    def test_bad_impl_raises(self):
        q, k, v = (torch.from_numpy(a) for a in _qkv(6, 1, 2, 2, 4, 4, 8))
        with pytest.raises(ValueError):
            ops.sdpa(q, k, v, impl="pallas")


class TestFusedLinearParity:
    @pytest.mark.parametrize("act", ACTS)
    @pytest.mark.parametrize("bias", [True, False])
    def test_acts(self, act, bias):
        rng = np.random.default_rng(7)
        x = (rng.standard_normal((32, 16)) * 0.5).astype(np.float32)
        w = (rng.standard_normal((16, 24)) * 0.5).astype(np.float32)
        b = rng.standard_normal((24,)).astype(np.float32) if bias else None
        got = ops.fused_linear(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b) if bias else None, act=act)
        want = jops.fused_linear(x, w, b, act=act, impl="interpret")
        np.testing.assert_allclose(as_np(got), as_np(want), **TOL_F32)

    def test_residual_and_leading_dims(self):
        rng = np.random.default_rng(8)
        x = rng.standard_normal((2, 3, 16)).astype(np.float32)
        w = rng.standard_normal((16, 8)).astype(np.float32)
        b = rng.standard_normal((8,)).astype(np.float32)
        r = rng.standard_normal((2, 3, 8)).astype(np.float32)
        got = ops.fused_linear(*(torch.from_numpy(a) for a in (x, w, b)), act="gelu",
                               residual=torch.from_numpy(r))
        want = jops.fused_linear(x, w, b, act="gelu", residual=r, impl="interpret")
        assert tuple(got.shape) == (2, 3, 8)
        np.testing.assert_allclose(as_np(got), as_np(want), **TOL_F32)

    def test_vector_input(self):
        """A 1-D x goes through the kernel front as one row (JAX: plain path)."""
        rng = np.random.default_rng(11)
        x = rng.standard_normal((16,)).astype(np.float32)
        w = rng.standard_normal((16, 8)).astype(np.float32)
        got = ops.fused_linear(torch.from_numpy(x), torch.from_numpy(w), act="tanh")
        want = jops.fused_linear(x, w, act="tanh", impl="interpret")
        assert tuple(got.shape) == (8,)
        np.testing.assert_allclose(as_np(got), as_np(want), **TOL_F32)

    def test_ragged_decode_rows_bf16(self):
        """M = 4 rows, as at decode (the Pallas divisor tiling's weak spot)."""
        rng = np.random.default_rng(9)
        x = rng.standard_normal((4, 64)).astype(np.float32)
        w = (rng.standard_normal((64, 48)) / 8).astype(np.float32)
        b = rng.standard_normal((48,)).astype(np.float32)
        got = ops.fused_linear(*(torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, b)),
                               act="gelu")
        want = jops.fused_linear(*(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)),
                                 act="gelu", impl="interpret")
        np.testing.assert_allclose(as_np(got), as_np(want), **TOL_BF16)

    def test_two_gelus_differ(self):
        """``gelu`` is the tanh approximation, ``gelu_exact`` the erf form."""
        y = torch.linspace(-3, 3, 101)
        a, b = ref.apply_act(y, "gelu"), ref.apply_act(y, "gelu_exact")
        assert not torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), torch.nn.functional.gelu(
            y, approximate="tanh").numpy())

    def test_unknown_activation_raises(self):
        with pytest.raises(ValueError):
            ref.apply_act(torch.ones(2), "swish")

    def test_backward_through_plain_version(self):
        rng = np.random.default_rng(10)
        x = torch.from_numpy(rng.standard_normal((5, 6)).astype(np.float32)).requires_grad_()
        w = torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32)).requires_grad_()
        b = torch.zeros(4, requires_grad=True)
        FL.fused_linear(x, w, b, act="silu").sum().backward()
        x2, w2, b2 = (t.detach().clone().requires_grad_() for t in (x, w, b))
        ref.fused_linear_ref(x2, w2, b2, act="silu").sum().backward()
        for t, t2 in ((x, x2), (w, w2), (b, b2)):
            np.testing.assert_allclose(t.grad.numpy(), t2.grad.numpy(), rtol=1e-6)


class TestDeviceSelection:
    def test_cpu_tensor_takes_plain_version(self):
        FL.LAUNCHES.reset()
        FA.LAUNCHES.reset()
        ops.fused_linear(torch.ones(4, 8), torch.ones(8, 8), act="relu")
        ops.sdpa(torch.ones(1, 2, 4, 8), torch.ones(1, 2, 4, 8), torch.ones(1, 2, 4, 8),
                 causal=True)
        assert FL.LAUNCHES.n == 0 and FA.LAUNCHES.n == 0

    def test_cuda_wrappers_refuse_cpu_tensors(self):
        with pytest.raises(ValueError):
            FL.fused_linear_cuda(torch.ones(4, 8), torch.ones(8, 8))
        with pytest.raises(ValueError):
            FA.flash_attention_cuda(torch.ones(1, 2, 4, 64), torch.ones(1, 2, 4, 64),
                                    torch.ones(1, 2, 4, 64), scale=0.125)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
                         + [ROOT / "chip_smoke.py"], ids=lambda p: p.name)
def test_port_imports_no_jax_and_no_reference_package(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {name}"
