"""Optimizers of the port: AdamW (default) and Adafactor (the
trillion-parameter MoE), ports of the JAX package's ``optim/``."""
from .adafactor import Adafactor, AdafactorState, stacked_keys
from .adamw import AdamW, AdamWState, global_norm


def get_optimizer(name: str, **kw):
    if name == "adamw":
        return AdamW(**kw)
    if name == "adafactor":
        return Adafactor(**kw)
    raise KeyError(f"unknown optimizer {name!r}")


__all__ = [
    "AdamW", "AdamWState", "Adafactor", "AdafactorState",
    "get_optimizer", "global_norm", "stacked_keys",
]
