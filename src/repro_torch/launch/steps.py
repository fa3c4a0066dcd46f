"""Step-function factories shared by the train CLI, the serve fronts and
the eval path.

* ``make_train_step(cfg, optimizer=None)`` -> ``(params, opt_state,
  batch) -> (params, opt_state, metrics)``: forward, cross-entropy loss,
  ``torch.autograd`` backward and the optimizer update
  (``default_optimizer(cfg)``: AdamW, Adafactor above
  ``ADAFACTOR_THRESHOLD`` parameters).
* ``make_forward(cfg)`` / ``make_loss_fn(cfg)`` / ``make_eval_step(cfg)`` /
  ``make_prefill_step(cfg)`` -> the full-sequence forward over a batch
  dict (``tokens``; ``frames`` for the encoder-decoder family,
  ``patches`` for the VLM), its cross-entropy against ``labels``, the
  eval metrics ``{loss, ppl}`` and the forward as a prefill step.
* ``make_serve_step(cfg)`` -> one-token greedy decode against the KV cache.
* ``make_slot_serve_step(cfg)`` / ``make_slot_prefill_step(cfg)`` /
  ``make_batched_prefill_step(cfg)`` -> slot-level decode and whole-prompt
  prefill against the contiguous cache (the contiguous forge fronts).
* ``make_paged_serve_step(cfg)`` / ``make_paged_prefill_step(cfg)`` ->
  slot-level decode and slot-masked whole-prompt prefill against the
  paged KV pool (the continuous-batching fronts).
* ``gather_cache_rows`` / ``blend_cache_rows`` -> park and resume a
  contiguous cache row (the slot scheduler's preemption).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from ..configs.base import ModelConfig
from ..distrib.actsharding import gathered
from ..models import get_model, losses
from ..optim import Adafactor, AdamW, stacked_keys

#: params above this use Adafactor (factored states; the JAX package's
#: DESIGN §7)
ADAFACTOR_THRESHOLD = 100e9


def dealias_tree(tree):
    """Give every tensor leaf its own storage (a ``clone`` per leaf), so
    no two leaves of a state tree share one buffer whatever built them
    (the JAX package needs it against XLA's aliasing of equal constants;
    the paged server keeps it for its store)."""
    return pytree.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def gather_cache_rows(cache, axes_spec, rows: Sequence[int]):
    """Batch rows ``rows`` of a contiguous decode cache as a small tree.

    Each batch-polymorphic leaf (per ``axes_spec``, a ``vmap``-style tree
    prefix) keeps only the selected rows along its batch axis, in a new
    tensor that owns its storage (``index_select``), so no later write to
    ``cache`` (a program replay, a pooled reset) can reach the extract;
    batch-free leaves pass through.  The park half of contiguous
    preemption."""
    from ..core.shapekey import flatten_axes

    flat, spec = pytree.tree_flatten(cache)
    axes = flatten_axes(axes_spec, cache)
    out = []
    for leaf, ax in zip(flat, axes):
        if ax is None:
            out.append(leaf)
            continue
        idx = torch.as_tensor(list(rows), dtype=torch.long, device=leaf.device)
        out.append(torch.index_select(leaf, ax, idx))
    return pytree.tree_unflatten(out, spec)


def blend_cache_rows(cache, axes_spec, row_tree, rows: Sequence[int]):
    """Write ``row_tree`` (a :func:`gather_cache_rows` extract) back into
    batch rows ``rows`` of ``cache``, out of place: every other row of
    every leaf survives bitwise, and ``cache``'s own tensors are not
    written.  Batch-free leaves keep ``cache``'s values.  The resume half
    of contiguous preemption."""
    from ..core.shapekey import flatten_axes

    flat, spec = pytree.tree_flatten(cache)
    flat_src, _ = pytree.tree_flatten(row_tree)
    axes = flatten_axes(axes_spec, cache)
    out = []
    for leaf, src, ax in zip(flat, flat_src, axes):
        if ax is None:
            out.append(leaf)
            continue
        idx = torch.as_tensor(list(rows), dtype=torch.long, device=leaf.device)
        out.append(leaf.index_copy(ax, idx, src))
    return pytree.tree_unflatten(out, spec)


def default_optimizer(cfg: ModelConfig):
    if cfg.param_count() > ADAFACTOR_THRESHOLD:
        return Adafactor(lr=1e-3).for_config(cfg)
    return AdamW(lr=3e-4)


def make_forward(cfg: ModelConfig, impl: Optional[str] = None) -> Callable:
    """``(params, batch) -> (B, S, vocab) logits``: the family's ``apply``
    on ``batch["tokens"]`` (with ``batch["frames"]`` for the
    encoder-decoder family, ``batch["patches"]`` for the VLM).  ``impl``
    reaches the Forge-compiled bodies (``"ref"``: the plain versions)."""
    model = get_model(cfg)
    if cfg.family == "encdec":
        def fwd(params, batch):
            return model.apply(params, batch["frames"], batch["tokens"], cfg, impl=impl)
    elif cfg.family == "vlm":
        def fwd(params, batch):
            return model.module.apply(params, batch["tokens"], cfg,
                                      patch_embeds=batch["patches"], impl=impl)
    else:
        def fwd(params, batch):
            return model.apply(params, batch["tokens"], cfg, impl=impl)
    return fwd


def make_loss_fn(cfg: ModelConfig, impl: Optional[str] = None) -> Callable:
    """``(params, batch) -> loss``: the mean fp32 cross-entropy of the
    forward's logits against ``batch["labels"]``."""
    fwd = make_forward(cfg, impl)

    def loss_fn(params, batch):
        return losses.cross_entropy(fwd(params, batch), batch["labels"])

    return loss_fn


def loss_and_grads(loss_fn: Callable, params, batch):
    """``(loss, grads)``: the loss at ``params`` and its gradient, a tree
    like ``params`` (``jax.value_and_grad``).  Each leaf is differentiated
    as its own input, as JAX differentiates pytree leaves; a leaf the
    loss does not reach gets zeros."""
    flat, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss = loss_fn(pytree.tree_unflatten(leaves, spec), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return loss.detach(), pytree.tree_unflatten(grads, spec)


def make_train_step(cfg: ModelConfig, optimizer=None) -> Callable:
    """``(params, opt_state, batch) -> (params, opt_state, {"loss"})``.

    Forward and loss (the Forge-compiled bodies, rematerialised in
    backward when ``cfg.remat``), ``torch.autograd`` backward and
    ``optimizer.update`` (default: :func:`default_optimizer`).  An
    Adafactor must update the layer lists the JAX package stacks for
    ``cfg`` (``Adafactor().for_config(cfg)``, see ``optim/adafactor.py``;
    its ``init`` gives the state in that layout): another raises.  The step is
    out of place: it returns new parameter and state tensors and writes
    none of its inputs (the JAX package donates them to ``jax.jit``
    instead).  ``batch`` holds ``tokens`` and ``labels`` tensors on the
    parameters' device (and ``frames`` / ``patches`` for the
    encoder-decoder and VLM families); the loss is a 0-d fp32 tensor."""
    optimizer = optimizer or default_optimizer(cfg)
    if isinstance(optimizer, Adafactor) and optimizer.stacked != stacked_keys(cfg):
        raise ValueError(f"Adafactor updates {optimizer.stacked} stacked, the JAX package "
                         f"stacks {stacked_keys(cfg)} for {cfg.name}: pass "
                         f"optimizer.for_config(cfg)")
    loss_fn = make_loss_fn(cfg)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(loss_fn, params, batch)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss.float()}

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    """``(params, batch) -> {"loss", "ppl"}``."""
    loss_fn = make_loss_fn(cfg)

    def eval_step(params, batch):
        loss = loss_fn(params, batch)
        return {"loss": loss, "ppl": torch.exp(loss)}

    return eval_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """``(params, batch) -> logits``: the forward as a prefill step."""
    fwd = make_forward(cfg)

    def prefill_step(params, batch):
        return fwd(params, batch)

    return prefill_step


def make_serve_step(cfg: ModelConfig, impl: Optional[str] = None,
                    logits: bool = False) -> Callable:
    """``(params, cache, token(B, 1), pos) -> (next_tok(B, 1) int32, new_cache)``.

    ``impl`` is forwarded into the Forge-compiled block bodies: None runs
    the kernels on the card (their plain versions on the CPU), ``"ref"``
    runs the plain versions everywhere.  ``logits=True`` appends the
    last position's logits (B, vocab) to the result."""
    model = get_model(cfg)

    def serve_step(params, cache, token, pos):
        out, new_cache = model.decode_step(params, cache, token, pos, cfg, impl=impl)
        last = out[:, -1, :]
        # a planned call's vocab-sharded logits are gathered first
        # (distrib.actsharding.gathered); plain logits pass untouched
        next_tok = torch.argmax(gathered(last, -1), dim=-1).to(torch.int32)[:, None]
        return (next_tok, new_cache, last) if logits else (next_tok, new_cache)

    return serve_step


#: sentinel emitted instead of an argmax over non-finite logits; never a
#: real token (vocab ids are >= 0), so the scheduler can quarantine the
#: row while its neighbours decode on untouched
POISON_TOKEN = -1


def guarded_argmax(last_logits: torch.Tensor) -> torch.Tensor:
    """Greedy int32 token with a non-finite tripwire: a row whose logits
    hold NaN/+Inf emits :data:`POISON_TOKEN`; rows with finite logits are
    a plain argmax (``-Inf`` entries keep the row max finite and do not
    trip it)."""
    tok = torch.argmax(last_logits, dim=-1).to(torch.int32)
    row_max = torch.amax(last_logits, dim=-1)
    return torch.where(torch.isfinite(row_max), tok, POISON_TOKEN).to(torch.int32)


#: families whose decode step takes per-row positions and slot masks —
#: the slot-level continuous-batching contract (vlm's M-RoPE streams
#: share one position, as in the JAX package)
SLOT_FAMILIES = ("dense", "moe", "hybrid", "ssm")


def supports_slot_decode(cfg: ModelConfig) -> bool:
    return cfg.family in SLOT_FAMILIES


def make_slot_serve_step(cfg: ModelConfig, impl: Optional[str] = None) -> Callable:
    """Slot-level greedy decode step.

    ``(params, cache, token(B, 1), pos(B,), slot_mask(B,)) ->
    (next_tok(B, 1) int32, new_cache)``: each batch row writes its
    KV/state and masks attention at its OWN position, and rows with
    ``slot_mask[b] == False`` leave their cache rows bitwise untouched
    (their emitted token is garbage and must be ignored)."""
    if not supports_slot_decode(cfg):
        raise ValueError(f"family {cfg.family!r} has no slot-level decode "
                         f"(supported: {', '.join(SLOT_FAMILIES)})")
    model = get_model(cfg)

    def slot_step(params, cache, token, pos, slot_mask):
        logits, new_cache = model.decode_step(params, cache, token, pos, cfg,
                                              slot_mask=slot_mask, impl=impl)
        return guarded_argmax(logits[:, -1, :])[:, None], new_cache

    return slot_step


def supports_batched_prefill(cfg: ModelConfig) -> bool:
    """Can this family prefill a whole (B, S) prompt block in one
    dispatch?  The one predicate every serve front consults: True when
    the family exposes a ``prefill_step`` whose one-pass result
    reproduces sequential decode (the dense decoder through a causal
    KV-chunk write, the recurrent families through the chunked state
    scan)."""
    return get_model(cfg).prefill_step is not None


def make_slot_prefill_step(cfg: ModelConfig, impl: Optional[str] = None
                           ) -> Optional[Callable]:
    """Slot-masked whole-prompt prefill against the contiguous cache.

    ``(params, cache, tokens(B, S), pos, slot_mask(B,)) -> (logits,
    cache)`` — plus a trailing ``length(B,)`` when the model declares
    ``prefill_takes_length`` (recurrent state consumes every chunk token,
    so the scan must know where each row's real prompt ends).  The
    masked-out rows' cache survives bitwise.  None for families without
    a batched prefill (MoE capacity routing): those swap in through
    masked decode-step replay."""
    model = get_model(cfg)
    if not supports_batched_prefill(cfg) or not supports_slot_decode(cfg):
        return None

    if model.prefill_takes_length:
        def slot_prefill(params, cache, tokens, pos, slot_mask, length):
            return model.prefill_step(params, cache, tokens, pos, cfg, slot_mask=slot_mask,
                                      length=length, impl=impl)
    else:
        def slot_prefill(params, cache, tokens, pos, slot_mask):
            return model.prefill_step(params, cache, tokens, pos, cfg, slot_mask=slot_mask,
                                      impl=impl)

    return slot_prefill


def make_batched_prefill_step(cfg: ModelConfig, impl: Optional[str] = None
                              ) -> Optional[Callable]:
    """Whole-prompt prefill step: ``(params, cache, tokens(B, S), pos) ->
    ((B, S, vocab) logits, cache)``, one forward pass folding the block
    into the cache.  None where the family has no batched prefill."""
    model = get_model(cfg)
    if not supports_batched_prefill(cfg):
        return None

    def prefill_step(params, cache, tokens, pos):
        return model.prefill_step(params, cache, tokens, pos, cfg, impl=impl)

    return prefill_step


def supports_paged_decode(cfg: ModelConfig) -> bool:
    """Paged KV needs a purely positional KV cache: families whose decode
    state folds past tokens into non-positional state cannot page it."""
    model = get_model(cfg)
    return (model.paged_decode_step is not None and supports_slot_decode(cfg)
            and not model.stateful_decode)


def make_paged_serve_step(cfg: ModelConfig, impl: Optional[str] = None) -> Callable:
    """Slot-level greedy decode against the paged KV pool.

    ``(params, store, page_table(B, MP), token(B, 1), pos(B,),
    slot_mask(B,)) -> (next_tok(B, 1) int32, new_store)``: every row
    writes its K/V and masks attention at its own position; rows with
    ``slot_mask[b] == False`` write to the trash page (their token is
    garbage).  ``store`` is ``{k_pages, v_pages}``; the table is read
    only — allocation is host-side, so swap-in and resize are table
    edits, never KV copies."""
    if not supports_paged_decode(cfg):
        raise ValueError(f"family {cfg.family!r} has no paged decode path")
    model = get_model(cfg)

    def paged_step(params, store, page_table, token, pos, slot_mask):
        cache = dict(store, page_table=page_table)
        logits, new_cache = model.paged_decode_step(params, cache, token, pos, cfg,
                                                    slot_mask=slot_mask, impl=impl)
        new_store = {"k_pages": new_cache["k_pages"], "v_pages": new_cache["v_pages"]}
        return guarded_argmax(logits[:, -1, :])[:, None], new_store

    return paged_step


def make_paged_prefill_step(cfg: ModelConfig, impl: Optional[str] = None
                            ) -> Optional[Callable]:
    """Slot-masked whole-prompt prefill into the paged KV pool.

    ``(params, store, page_table(B, MP), tokens(B, S), pos(B,),
    slot_mask(B,)) -> ((B, S, vocab) logits, new_store)``.  ``pos`` is
    per row: a row whose leading pages matched in the prefix tree
    anchors its chunk at the skip offset, so prefix-hit and cold rows
    prefill in one dispatch."""
    if not supports_paged_decode(cfg):
        return None
    model = get_model(cfg)
    if model.paged_prefill_step is None:
        return None

    def paged_prefill(params, store, page_table, tokens, pos, slot_mask):
        cache = dict(store, page_table=page_table)
        logits, new_cache = model.paged_prefill_step(params, cache, tokens, pos, cfg,
                                                     slot_mask=slot_mask, impl=impl)
        return logits, {"k_pages": new_cache["k_pages"], "v_pages": new_cache["v_pages"]}

    return paged_prefill
