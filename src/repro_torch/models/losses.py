"""Training losses: a port of the JAX package's ``models/losses.py``."""
from __future__ import annotations

import torch

from ..distrib.actsharding import settled


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean next-token cross-entropy in fp32.  logits: (..., V).

    The reference's formulation: ``lse - Σ logits·onehot``, with the max
    subtracted for the log-sum-exp (outside the gradient); labels equal
    to ``ignore_id`` count neither in the sum nor in the mean.
    """
    logits = logits.float()
    # a plan's vocab-sharded logits leave each reduction over the vocab
    # a pending max or sum: reduced where it is made (as GSPMD
    # all-reduces them), never scattered over the sequence
    m = settled(torch.amax(logits, dim=-1, keepdim=True).detach())
    lse = torch.log(settled(torch.sum(torch.exp(logits - m), dim=-1))) + m[..., 0]
    # one_hot of an out-of-range id (ignore_id) is a row of zeros, as
    # jax.nn.one_hot gives it
    valid = (labels >= 0) & (labels < logits.shape[-1])
    onehot = _one_hot(torch.where(valid, labels, 0).long(), logits).to(logits.dtype)
    onehot = onehot * valid[..., None].to(logits.dtype)
    label_logit = settled(torch.sum(logits * onehot, dim=-1))
    ll = label_logit - lse
    mask = (labels != ignore_id).to(torch.float32)
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _one_hot(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``one_hot(labels, V)``.  Against a sharding plan's DTensor logits
    it is ``labels == arange(V)`` with the ``arange`` placed as the
    logits' vocab dim is (the same values): ``one_hot`` would build the
    full (B, S, V) table on every device."""
    V = logits.shape[-1]
    if type(logits) is torch.Tensor:
        return torch.nn.functional.one_hot(labels, V)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(logits, DTensor):
        return torch.nn.functional.one_hot(labels, V)
    mesh, last = logits.device_mesh, logits.ndim - 1
    pl = [Shard(0) if isinstance(p, Shard) and p.dim == last else Replicate()
          for p in logits.placements]
    local = DTensor.from_local(torch.arange(V, device=logits.to_local().device), mesh,
                               [Replicate()] * mesh.ndim, run_check=False)
    vocab = local.redistribute(mesh, pl)
    return (labels[..., None] == vocab).long()


def perplexity(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.exp(cross_entropy(logits, labels))
