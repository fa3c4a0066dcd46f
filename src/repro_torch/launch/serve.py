"""Batched greedy serving — the port of ``repro.launch.serve``.

``BatchedServer(mode="eager")`` is the counterpart of the JAX server's
``--mode jit``: the serve step runs directly (PyTorch executes eagerly),
and when ``cfg.fuse == "forge"`` every transformer block body inside it
is Forge-compiled once per shape through all four phases — so the fused
``forge.linear_act`` and ``forge.sdpa`` nodes reach the CUDA kernels.
The prompt is prefilled token by token through the decode step, as the
JAX server does in jit mode.

CLI (runs on the CUDA device unless ``--device cpu``)::

    python -m repro_torch.launch.serve --arch forge-125m [--smoke]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..device import resolve_device
from ..models import get_model
from .steps import make_serve_step


class RequestError(ValueError):
    """A request-level failure (malformed prompt array)."""


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class BatchedServer:
    """Group-admission batch server with greedy decoding.

    ``impl`` is forwarded into the compiled block bodies' fused nodes:
    None dispatches by device (the CUDA kernels on the card), ``"ref"``
    runs the kernels' plain versions — the oracle a kernel run is held
    against.
    """

    MODES = ("eager",)

    def __init__(self, cfg, params, max_len: int = 256, mode: str = "eager",
                 impl: Optional[str] = None):
        if mode not in self.MODES:
            raise ValueError(f"mode {mode!r} not supported; the port serves {self.MODES}")
        self.cfg = cfg
        self.params = params
        self.model = get_model(cfg)
        self.max_len = max_len
        self.mode = mode
        self.impl = impl
        self.device = params["embed"].device
        self.serve_step = make_serve_step(cfg, impl=impl)
        #: how the most recent prefill ran (the port prefills sequentially)
        self.last_prefill_mode = None

    def _build_cache(self, batch: int):
        return self.model.init_cache(self.cfg, batch, self.max_len, device=self.device)

    def _check_prompts(self, prompts: np.ndarray) -> None:
        if prompts.ndim != 2 or prompts.shape[0] == 0 or prompts.shape[1] == 0:
            raise RequestError(f"prompts must be a non-empty (B, P) array, got "
                               f"shape {prompts.shape}")
        if prompts.min() < 0 or prompts.max() >= self.cfg.vocab:
            raise RequestError("prompt token ids out of vocabulary range")

    @torch.no_grad()
    def prefill(self, prompts: np.ndarray):
        """Token-at-a-time prefill through the decode step.

        Returns ``(cache, next_tok, pos, step_fn)``."""
        self._check_prompts(prompts)
        B, P = prompts.shape
        tokens = torch.as_tensor(prompts, dtype=torch.int64, device=self.device)
        cache = self._build_cache(B)
        next_tok = None
        for i in range(P):
            next_tok, cache = self.serve_step(self.params, cache, tokens[:, i:i + 1], i)
        self.last_prefill_mode = "sequential"
        return cache, next_tok, P, self.serve_step

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, n_new: int) -> Dict[str, Any]:
        B, P = prompts.shape
        if P + n_new - 1 > self.max_len:
            raise RequestError(f"prompt {P} + {n_new} new tokens exceed max_len "
                               f"{self.max_len}")
        t0 = time.perf_counter()
        cache, tok, pos0, step = self.prefill(prompts)
        _sync(self.device)  # TTFT: the first token is real here
        t_prefill = time.perf_counter() - t0
        out: List[torch.Tensor] = [tok]
        lat: List[float] = []
        for i in range(n_new - 1):
            t1 = time.perf_counter()
            tok, cache = step(self.params, cache, tok, pos0 + i)
            _sync(self.device)
            lat.append(time.perf_counter() - t1)
            out.append(tok)
        toks = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
        lat_ms = np.asarray(lat) * 1e3
        return {
            "tokens": toks,
            "prefill_s": t_prefill,
            "ttft_s": t_prefill,  # time to first token (prefill wall)
            "prefill_mode": self.last_prefill_mode,
            "decode_ms_mean": float(lat_ms.mean()) if len(lat_ms) else 0.0,
            "decode_ms_p50": float(np.percentile(lat_ms, 50)) if len(lat_ms) else 0.0,
            "decode_ms_p99": float(np.percentile(lat_ms, 99)) if len(lat_ms) else 0.0,
            "tok_per_s": B * max(len(lat), 1) / max(sum(lat), 1e-9),
        }

    def run_workload(self, groups: Sequence[np.ndarray], n_new: int
                     ) -> List[Dict[str, Any]]:
        """Serve a FIFO stream of request groups, one group at a time.

        Error isolation: a group that fails completes with a typed error
        outcome (``{"error", "error_type"}``) instead of killing the
        stream; the remaining groups are still served.
        """
        out: List[Dict[str, Any]] = []
        for g in groups:
            try:
                out.append(self.generate(np.asarray(g), n_new))
            except Exception as e:  # noqa: BLE001 — isolation boundary
                kind = ("RequestError" if isinstance(e, (RequestError, ValueError,
                                                         TypeError))
                        else "SystemError")
                out.append({"tokens": np.zeros((0, 0), np.int32), "error": str(e),
                            "error_type": kind})
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="forge-125m", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--mode", choices=list(BatchedServer.MODES), default="eager")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a CUDA device) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(cfg, gen, device)
    rng = np.random.default_rng(args.seed)

    server = BatchedServer(cfg, params, max_len=args.max_len, mode=args.mode)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
    res = server.generate(prompts, args.gen)
    print(f"[serve] {cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"ttft={res['ttft_s'] * 1e3:.1f}ms (prefill={res['prefill_mode']}) "
          f"decode mean={res['decode_ms_mean']:.1f}ms p50={res['decode_ms_p50']:.1f} "
          f"p99={res['decode_ms_p99']:.1f} ({res['tok_per_s']:.0f} tok/s steady-state) "
          f"device={device}")
    if res["tokens"].shape != (args.batch, args.gen):
        raise SystemExit(f"unexpected token shape {res['tokens'].shape}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
