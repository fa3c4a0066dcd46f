"""Model zoo: one module per architecture family, uniform API.

``get_model(cfg)`` returns a :class:`ModelAPI` with

* ``init(cfg, generator, device)``              parameter dict
* ``apply(params, tokens, cfg)``                full-sequence logits
* ``init_cache(cfg, batch, max_len, device)``   decode state
* ``decode_step(params, cache, tok, pos, cfg)`` one-token serve step

The port carries the dense family so far.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from ..configs.base import ModelConfig
from . import attention, layers, transformer


@dataclass(frozen=True)
class ModelAPI:
    family: str
    init: Callable
    apply: Callable
    decode_step: Callable
    init_cache: Callable
    module: Any


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r}: the port carries the dense "
                                  f"decoder so far")
    m = transformer
    return ModelAPI(family=cfg.family, init=m.init, apply=m.apply,
                    decode_step=m.decode_step, init_cache=m.init_cache, module=m)


__all__ = ["ModelAPI", "get_model", "attention", "layers", "transformer"]
