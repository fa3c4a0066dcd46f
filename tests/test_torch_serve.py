"""The port's serve front against the JAX package's ``BatchedServer``.

Greedy tokens must be identical to the JAX server's ``mode="jit"`` run,
in f32, on forge-125m smoke with 3 prompts x 6 tokens (numpy seed 0)
and 3 new tokens; the JAX side is computed live here.
"""
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import BatchedServer as JaxBatchedServer
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch.serve import BatchedServer
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import get_model

from torch_port_support import jax_params, port_params


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("forge-125m", smoke=True).with_(dtype="float32")
    jcfg = jax_get_config("forge-125m", smoke=True).with_(dtype="float32")
    jp = jax_params(jcfg)
    return cfg, jcfg, jp, port_params(jp)


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(0).integers(0, 512, (3, 6)).astype(np.int32)


@pytest.fixture(scope="module")
def port_result(setup, prompts):
    cfg, _, _, p = setup
    return BatchedServer(cfg, p, max_len=64, mode="interpret").generate(prompts, 3)


def test_tokens_identical_to_jax_jit_server(setup, prompts, port_result):
    _, jcfg, jp, _ = setup
    want = JaxBatchedServer(jcfg, jp, max_len=64, mode="jit").generate(prompts, 3)
    np.testing.assert_array_equal(port_result["tokens"], np.asarray(want["tokens"]))


def test_generate_result_fields(port_result):
    r = port_result
    assert r["tokens"].shape == (3, 3) and r["tokens"].dtype == np.int32
    assert r["prefill_mode"] == "sequential"
    assert r["ttft_s"] > 0 and r["tok_per_s"] > 0
    assert r["decode_ms_p50"] <= r["decode_ms_p99"]


def test_impl_ref_server_same_tokens(setup, prompts, port_result):
    cfg, _, _, p = setup
    r = BatchedServer(cfg, p, max_len=64, mode="interpret", impl="ref").generate(prompts, 3)
    np.testing.assert_array_equal(r["tokens"], port_result["tokens"])


def test_serve_step_matches_decode_argmax(setup, prompts):
    cfg, _, _, p = setup
    step = make_serve_step(cfg)
    m = get_model(cfg)
    tok = torch.from_numpy(prompts[:, :1]).long()
    nxt, _ = step(p, m.init_cache(cfg, 3, 16, device="cpu"), tok, 0)
    logits, _ = m.decode_step(p, m.init_cache(cfg, 3, 16, device="cpu"), tok, 0, cfg)
    assert torch.equal(nxt[:, 0], logits[:, -1].argmax(-1))


def test_run_workload_isolates_bad_groups(setup, prompts):
    cfg, _, _, p = setup
    server = BatchedServer(cfg, p, max_len=64, mode="interpret")
    bad = np.full((2, 4), cfg.vocab + 7, np.int32)
    out = server.run_workload([prompts, bad, prompts[:1]], 2)
    assert [("error" in o) for o in out] == [False, True, False]
    assert out[1]["error_type"] == "RequestError"
    assert out[2]["tokens"].shape == (1, 2)


def test_max_len_guard(setup, prompts):
    cfg, _, _, p = setup
    with pytest.raises(serve.RequestError):
        BatchedServer(cfg, p, max_len=8, mode="interpret").generate(prompts, 4)


def test_unknown_mode_rejected(setup):
    cfg, _, _, p = setup
    with pytest.raises(ValueError):
        BatchedServer(cfg, p, mode="bogus")


def test_forge_mode_needs_paged(setup, prompts, port_result):
    """mode="forge" no longer needs paged=True: the dense decoder serves
    on the contiguous forge fronts (its whole-prompt prefill is ported),
    with the interpret server's greedy tokens."""
    cfg, _, _, p = setup
    srv = BatchedServer(cfg, p, max_len=64, mode="forge")
    assert not srv.paged
    r = srv.generate(prompts, 3)
    assert r["prefill_mode"] == "batched"
    np.testing.assert_array_equal(r["tokens"], port_result["tokens"])


def test_cli_paged_continuous_on_cpu(capsys):
    assert serve.main(["--mode", "forge", "--continuous", "6", "--paged", "--smoke",
                       "--device", "cpu", "--max-slots", "2", "--prompt-len", "8",
                       "--gen", "4", "--max-len", "32", "--kv-page-size", "8"]) == 0
    out = capsys.readouterr().out
    assert "forge-125m-smoke continuous n=6" in out
    assert "compiles_post_warmup=0" in out
    assert "[serve] pages: in_use=" in out


def test_cli_forge_needs_paged_continuous(capsys):
    """--mode forge serves forge-125m on the contiguous fronts without
    --paged --continuous now; --paged alone still needs --continuous."""
    assert serve.main(["--mode", "forge", "--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "3", "--gen", "2", "--max-len", "16"]) == 0
    assert "(prefill=batched)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--mode", "forge", "--paged", "--smoke", "--device", "cpu"])


def test_cli_on_cpu(capsys):
    assert serve.main(["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "3",
                       "--gen", "2", "--max-len", "8"]) == 0
    assert "forge-125m-smoke batch=2 prompt=3" in capsys.readouterr().out


def test_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke", "--gen", "2", "--prompt-len", "2"])
