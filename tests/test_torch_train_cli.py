"""The port's train CLI (``launch.train.main``) on the CPU (``--smoke
--device cpu``, bf16) against the JAX package's: with a fault injected at
step 4 and the step-3 checkpoint restored, one failure, one restore, the
replayed step's loss bitwise the first pass's, the checkpoints on disk,
a restart resuming from the last step, and every step's loss within the
bf16 tolerance 3e-2 of the JAX package's ``train.main`` on the same
arguments and initial weights; the CLI refuses the encoder-decoder and
VLM families and a missing device, parses ``--compress-grads`` and reads
it nowhere (as the JAX package), and ``build_trainer`` picks the
optimizer by size.
"""
import numpy as np
import pytest
import torch

from repro.launch import train as jax_train
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.optim import Adafactor, AdamW

from torch_port_support import TOL_BF16, jax_params, port_params


CLI_ARGS = ["--arch", "forge-125m", "--smoke", "--steps", "6", "--ckpt-every", "3",
            "--simulate-fault", "4", "--seed", "0"]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The port's CLI and the JAX package's on the same arguments and the
    same initial weights (the JAX package's init from ``--seed``)."""
    from repro.configs import get_config as jax_get_config

    ref_reports = []

    class Recording(jax_train.Supervisor):
        def run(self, *a, **kw):
            state, report = super().run(*a, **kw)
            ref_reports.append(report)
            return state, report

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_train, "Supervisor", Recording)
    try:
        assert jax_train.main(CLI_ARGS + ["--ckpt-dir", str(tmp_path_factory.mktemp("ref"))]) == 0
    finally:
        mp.undo()
    ckpt_dir = tmp_path_factory.mktemp("port")
    out = {}
    params = port_params(jax_params(jax_get_config("forge-125m", smoke=True)))
    assert train.main(CLI_ARGS + ["--device", "cpu", "--ckpt-dir", str(ckpt_dir)],
                      params=params, out=out) == 0
    return out, ref_reports[0], ckpt_dir


def test_cli_fault_restore_replay(cli_runs):
    out, _, ckpt_dir = cli_runs
    rep = out["report"]
    assert rep.failures == 1 and rep.restores == 1 and rep.steps_run == 7
    steps_run = [h["step"] for h in rep.history]
    assert steps_run == [0, 1, 2, 3, 3, 4, 5]
    first, replay = rep.history[3], rep.history[4]
    assert first["loss"] == replay["loss"]  # restored state, same batch: bitwise
    assert out["ckpt"].all_steps() == [0, 3, 6]
    assert len(out["ckpt"].timings["restore_s"]) == 1
    params, opt_state = out["state"]
    assert int(opt_state.step) == 6
    assert params["blocks"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert str(ckpt_dir) == out["ckpt"].directory


def test_cli_losses_match_reference(cli_runs):
    out, ref, _ = cli_runs
    got = [h["loss"] for h in out["report"].history]
    want = [h["loss"] for h in ref.history]
    assert [h["step"] for h in ref.history] == [h["step"] for h in out["report"].history]
    np.testing.assert_allclose(got, want, **TOL_BF16)


def test_cli_restarts_from_its_checkpoint(cli_runs, tmp_path, capsys):
    """A second run on the same directory resumes from the last step."""
    out, _, ckpt_dir = cli_runs
    again = {}
    assert train.main(["--smoke", "--device", "cpu", "--steps", "2", "--ckpt-every", "100",
                       "--ckpt-dir", str(ckpt_dir)], out=again) == 0
    assert "[train] restored from step 6" in capsys.readouterr().out
    assert [h["step"] for h in again["report"].history] == [6, 7]
    assert again["ckpt"].latest_step() == 8


def test_cli_refuses(tmp_path):
    for arch in ("seamless-m4t-large-v2", "qwen2-vl-72b"):
        with pytest.raises(SystemExit, match="LM families"):
            train.main(["--arch", arch, "--smoke", "--device", "cpu", "--ckpt-dir",
                        str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.main(["--smoke", "--ckpt-dir", str(tmp_path)])


def test_compress_grads_parsed_and_unread(tmp_path):
    """``--compress-grads`` parses, as in the JAX package, and changes
    nothing."""
    runs = []
    for extra in ([], ["--compress-grads"]):
        out = {}
        train.main(["--smoke", "--device", "cpu", "--steps", "2", "--ckpt-dir",
                    str(tmp_path / str(len(extra)))] + extra, out=out)
        runs.append([h["loss"] for h in out["report"].history])
    assert runs[0] == runs[1]


def test_build_trainer_optimizer():
    _, opt, _ = train.build_trainer(get_config("forge-125m"), lr=1e-3)
    assert isinstance(opt, AdamW) and opt.lr == 1e-3
    _, opt, _ = train.build_trainer(get_config("kimi-k2-1t-a32b"))
    assert isinstance(opt, Adafactor)
