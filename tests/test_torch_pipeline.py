"""Pipeline parallelism of the port (``repro_torch.distrib.pipeline``)
against the JAX package's: ``split_stages`` and ``reference_apply`` on
the same numpy data, ``gpipe_apply`` over two and three gloo ranks
against ``reference_apply`` (rtol 1e-5, atol 1e-6), and the demo
(``python -m repro_torch.launch.pipeline_demo``) as a subprocess."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distrib import pipeline as jpipe
from repro_torch.distrib import pipeline as tpipe

from torch_dist_workers import gpipe_rank, mlp_stage, spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestSplitStages:
    def test_shapes(self):
        blocks = {"w": torch.zeros(8, 4, 4), "b": torch.zeros(8, 4)}
        st = tpipe.split_stages(blocks, 2)
        assert st["w"].shape == (2, 4, 4, 4)
        assert st["b"].shape == (2, 4, 4)
        jst = jpipe.split_stages({"w": jnp.zeros((8, 4, 4)), "b": jnp.zeros((8, 4))}, 2)
        assert tuple(jst["w"].shape) == tuple(st["w"].shape)

    def test_indivisible_raises(self):
        with pytest.raises(AssertionError):
            tpipe.split_stages({"w": torch.zeros(7, 4, 4)}, 2)


def _blocks(seed, L, d):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((L, d, d)) / np.sqrt(d)).astype(np.float32),
            "b": (rng.standard_normal((L, d)) * 0.1).astype(np.float32)}


def test_reference_apply_matches_jax():
    blocks = _blocks(0, 6, 8)
    x = np.random.default_rng(1).standard_normal((3, 2, 4, 8)).astype(np.float32)

    def jstage(p, x):
        for i in range(p["w"].shape[0]):
            x = jnp.tanh(x @ p["w"][i] + p["b"][i])
        return x

    for n_stages in (1, 2, 3):
        got = tpipe.reference_apply(
            tpipe.split_stages({k: torch.from_numpy(v) for k, v in blocks.items()}, n_stages),
            torch.from_numpy(x), mlp_stage)
        want = jpipe.reference_apply(
            jpipe.split_stages({k: jnp.asarray(v) for k, v in blocks.items()}, n_stages),
            jnp.asarray(x), jstage)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world,M", [(2, 4), (3, 5), (2, 1)])
def test_gpipe_matches_reference(tmp_path, world, M):
    blocks = _blocks(world, 2 * world, 16)
    stages = tpipe.split_stages({k: torch.from_numpy(v) for k, v in blocks.items()}, world)
    x = torch.from_numpy(np.random.default_rng(M).standard_normal((M, 3, 5, 16)).astype(np.float32))
    out = spawn(gpipe_rank, world, tmp_path, stages, x)
    want = tpipe.reference_apply(stages, x, mlp_stage)
    for r in range(world):  # every rank holds the last stage's results
        torch.testing.assert_close(torch.load(f"{out}/r{r}.pt"), want, rtol=1e-5, atol=1e-6)


def test_demo_subprocess():
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.pipeline_demo"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("matches sequential reference exactly — OK"), res.stdout
