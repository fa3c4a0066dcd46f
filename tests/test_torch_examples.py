"""The four examples on the port (``examples/torch_*.py``) against their
JAX twins (``examples/*.py``), each run through its ``main`` on the CPU
at smoke size (``--device cpu``):

* ``torch_quickstart``: the unfused GQA block's output, eager and
  compiled, within rtol 2e-4 / atol 2e-5 of the JAX block's on the same
  numpy inputs, and the same fused ops as the JAX compile's;
* ``torch_inspect_compile``: per architecture, the fused ops and the
  attention fusions the JAX example prints, with node reduction above 0;
  seamless-m4t-large-v2 apart: the reference's config scans its layers
  (``scan_layers``), its capture keeps the scan whole and fuses nothing
  inside (0 and 0), the port's layer lists fuse;
* ``torch_serve_batch``: greedy tokens equal between ``jit`` and
  ``interpret`` and to the JAX ``BatchedServer(mode="interpret")``'s, on
  the JAX package's weights;
* ``torch_train_lm``: 3 steps, every loss within rtol 2e-4 / atol 2e-5 of
  the JAX train CLI's on the same arguments and weights (both configs in
  f32).
"""
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.core import ForgeCompiler as JaxForgeCompiler
from repro.core import PipelineConfig as JaxPipelineConfig
from repro.launch import train as jax_train
from repro.launch.serve import BatchedServer as JaxBatchedServer
from repro_torch.launch import train as port_train

from torch_port_support import TOL_F32, jax_params, port_params

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _example(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_jax_block(capsys):
    out = {}
    assert _example("torch_quickstart").main(["--device", "cpu"], out=out) == 0
    printed = capsys.readouterr().out
    assert "fidelity: max-abs=" in printed and "FGR (Eq. 22)" in printed
    jq = _example("quickstart")
    rng = np.random.default_rng(0)
    B, S, E, F = 2, 64, 64, 128
    args = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in
            [(B, S, E), (E, E), (E, E // 4), (E, E // 4), (E, E), (E, F), (E, F), (F, E)]]
    want = np.asarray(jq.gqa_block(*args))
    for key in ("pre", "post"):
        np.testing.assert_allclose(out[key].numpy(), want, err_msg=key, **TOL_F32)
    jmod = JaxForgeCompiler(JaxPipelineConfig()).compile(jq.gqa_block, *args)
    jfused = sorted(n.op for n in jmod.graph.nodes.values() if n.op.startswith("forge."))
    tfused = sorted(n.op for n in out["module"].graph.nodes.values() if n.is_fused)
    assert tfused == jfused == ["forge.linear_act"] * 2 + ["forge.sdpa", "forge.swiglu"]
    r = out["module"].result
    assert r.fused_ops == 4 and r.attention_fused == 1 and out["fgr"]["fgr"] > 1


_ROW = re.compile(r"^(\S+)\s+(\d+)->\s*(\d+)\s+(-?[\d.]+)%\s+(\d+)\s+(\d+)\s")


def _table(text):
    return {m[1]: (int(m[5]), int(m[6])) for m in map(_ROW.match, text.splitlines()) if m}


def test_inspect_compile_fusions_match_jax(capsys):
    out = {}
    assert _example("torch_inspect_compile").main(["--device", "cpu"], out=out) == 0
    port = _table(capsys.readouterr().out)
    _example("inspect_compile").main()
    ref = _table(capsys.readouterr().out)
    assert set(ref) == set(JAX_ARCH_IDS) and set(ref) <= set(port)
    for arch, r in out.items():
        assert r.node_reduction > 0 and (r.fused_ops, r.attention_fused) == port[arch], arch
    for arch in ref:
        jcfg = jax_get_config(arch, smoke=True)
        if jcfg.family not in ("dense", "moe", "vlm") and jcfg.scan_layers:  # a whole model
            assert arch == "seamless-m4t-large-v2" and ref[arch] == (0, 0)
            assert port[arch][0] > 0 and port[arch][1] > 0
        else:
            assert port[arch] == ref[arch], arch


@pytest.mark.parametrize("arch", ["forge-125m", "qwen2.5-14b"])
def test_serve_batch_tokens(arch, capsys):
    jcfg = jax_get_config(arch, smoke=True)
    jp = jax_params(jcfg)
    out = {}
    assert _example("torch_serve_batch").main(
        ["--arch", arch, "--device", "cpu", "--gen", "6"], params=port_params(jp), out=out) == 0
    assert "greedy tokens jit == interpret: True" in capsys.readouterr().out
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, jcfg.vocab, (4, 16)).astype(np.int32)
    want = JaxBatchedServer(jcfg, jp, max_len=64, mode="interpret").generate(prompts, 6)["tokens"]
    np.testing.assert_array_equal(out["jit"]["tokens"], out["interpret"]["tokens"])
    np.testing.assert_array_equal(out["interpret"]["tokens"], np.asarray(want))


def test_serve_batch_refuses_encdec():
    with pytest.raises(SystemExit, match="see repro_torch/models/encdec.py decode"):
        _example("torch_serve_batch").main(["--arch", "seamless-m4t-large-v2", "--device", "cpu"])


def test_train_lm_losses_match_jax_cli(tmp_path, monkeypatch):
    """Both CLIs on f32 configs (each module's ``get_config`` wrapped) and
    the JAX package's initial weights, the JAX one's losses read off its
    supervisor's report."""
    def f32(get):
        return lambda *a, **k: get(*a, **k).with_(dtype="float32")

    monkeypatch.setattr(jax_train, "get_config", f32(jax_train.get_config))
    monkeypatch.setattr(port_train, "get_config", f32(port_train.get_config))
    reports = []

    class Recording(jax_train.Supervisor):
        def run(self, *a, **kw):
            state, report = super().run(*a, **kw)
            reports.append(report)
            return state, report

    monkeypatch.setattr(jax_train, "Supervisor", Recording)
    assert jax_train.main(["--arch", "forge-125m", "--smoke", "--steps", "3", "--batch", "8",
                           "--seq", "128", "--ckpt-every", "50",
                           "--ckpt-dir", str(tmp_path / "ref")]) == 0
    jcfg = jax_get_config("forge-125m", smoke=True).with_(dtype="float32")
    out = {}
    assert _example("torch_train_lm").main(
        ["--steps", "3", "--device", "cpu", "--ckpt-dir", str(tmp_path / "port")],
        params=port_params(jax_params(jcfg)), out=out) == 0
    got = [h["loss"] for h in out["report"].history]
    want = [h["loss"] for h in reports[0].history]
    assert len(got) == 3 and [h["step"] for h in out["report"].history] == [0, 1, 2]
    np.testing.assert_allclose(got, want, **TOL_F32)
    params, _ = out["state"]
    assert params["blocks"][0]["attn"]["wq"].dtype == torch.float32
