"""Step-function builders shared by the serve front.

``make_serve_step(cfg)`` -> one-token greedy decode against the KV cache.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..configs.base import ModelConfig
from ..models import get_model


def make_serve_step(cfg: ModelConfig, impl: Optional[str] = None) -> Callable:
    """``(params, cache, token(B, 1), pos) -> (next_tok(B, 1), new_cache)``.

    ``impl`` is forwarded into the Forge-compiled block bodies: None runs
    the kernels on the card (their plain versions on the CPU), ``"ref"``
    runs the plain versions everywhere."""
    model = get_model(cfg)

    def serve_step(params, cache, token, pos):
        logits, new_cache = model.decode_step(params, cache, token, pos, cfg, impl=impl)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1)
        return next_tok[:, None], new_cache

    return serve_step
