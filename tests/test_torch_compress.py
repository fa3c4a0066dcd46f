"""Parity of the port's int8 gradient compression (``repro_torch.runtime.
compress``) with the JAX package's ``runtime/compress.py``: ``q``, the
block scales, the dequantized values, the error-feedback residuals and
``compression_ratio`` are bitwise the reference's (both round half to
even); ``compressed_all_reduce`` over two gloo ranks sums the ranks'
dequantized blocks, as the reference's ``compressed_psum`` does."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import compress as jc
from repro_torch.runtime import compress as tc

from torch_dist_workers import compress_rank, spawn

SHAPES = [(256,), (1000,), (3, 7, 11), (64, 256), (1,), (4, 300)]


def _inputs(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.choice([1e-3, 1.0, 40.0], size=shape)).astype(np.float32)
    if x.size >= 512:
        x.reshape(-1)[256:512] = 0.0  # an all-zero block: scale floors at 1e-12
    # values exactly half a quantization step apart: the round-half-even cases
    x.reshape(-1)[:4] = [127.0, 63.5, -0.5, 0.5] if x.size >= 4 else x.reshape(-1)[:4]
    t = torch.from_numpy(x)
    j = jnp.asarray(x)
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16)
        j = jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return t, j


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_bitwise(shape, dtype):
    t, j = _inputs(shape, sum(shape), dtype)
    q, s, n = tc.quantize_int8(t)
    jq, js, jn = jc.quantize_int8(j)
    assert n == jn and q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    d = tc.dequantize_int8(q, s, n, t.shape, t.dtype)
    jd = jc.dequantize_int8(jq, js, jn, j.shape, j.dtype)
    assert d.dtype == t.dtype and tuple(d.shape) == tuple(shape)
    np.testing.assert_array_equal(_np(d), np.asarray(jd, np.float32))


def test_compress_tree_and_ratio():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((33, 17)).astype(np.float32),
            "b": [rng.standard_normal(700).astype(np.float32),
                  rng.standard_normal((2, 2)).astype(np.float32)]}
    t_tree = {"a": torch.from_numpy(tree["a"]), "b": [torch.from_numpy(x) for x in tree["b"]]}
    j_tree = {"a": jnp.asarray(tree["a"]), "b": [jnp.asarray(x) for x in tree["b"]]}
    (t_reprs, t_res), (j_reprs, j_res) = tc.compress_tree(t_tree), jc.compress_tree(j_tree)
    for (tq, ts), (jq, js) in zip([t_reprs["a"]] + t_reprs["b"], [j_reprs["a"]] + j_reprs["b"]):
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for tr, jr in zip([t_res["a"]] + t_res["b"], [j_res["a"]] + j_res["b"]):
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert tc.compression_ratio(t_tree) == jc.compression_ratio(j_tree)
    assert tc.BLOCK == jc.BLOCK == 256


def test_compressed_all_reduce_two_ranks(tmp_path):
    out = spawn(compress_rank, 2, tmp_path)
    got = [torch.load(f"{out}/r{r}.pt") for r in range(2)]
    xs = [torch.from_numpy(np.random.default_rng(r).standard_normal(1000).astype(np.float32))
          for r in range(2)]
    # the sum of each rank's dequantized blocks (what compressed_psum sums)
    want = sum(tc.dequantize_int8(*tc.quantize_int8(x), x.shape, x.dtype) for x in xs)
    torch.testing.assert_close(got[0], got[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want, rtol=1e-6, atol=1e-6)
    # against the plain sum: within half a quantization step a rank
    bound = sum(x.abs().max() / 254 for x in xs)
    assert float((got[0] - sum(xs)).abs().max()) <= float(bound)
