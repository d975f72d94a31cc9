"""Train, prefill and serve step functions — the port of
``repro/launch/steps.py`` for one device.

  * train step   = one optimizer update: value and gradient of
    ``lm_loss`` (``encdec_loss`` for an encoder-decoder config; a batch's
    ``frontend`` goes to ``lm_loss``) (microbatched gradient accumulation when
    ``microbatches > 1``), the global-norm clip, AdamW. Params and
    moments are updated in place, leaf by leaf and a stacked leaf in
    chunks (``Optimizer.update_in_place``): the counterpart of the reference's donated
    params and optimizer state (``steps.py:260``, ``donate_argnums=(0,
    1)``), with which XLA updates the buffers in place. A 4 B-parameter
    model holds ~48 GB at rest in training (bf16 params and grads,
    float32 moments); a whole-tree functional update would hold ~56 GB
    more. The values are the functional update's, bit for bit.
  * prefill step = the full-sequence forward (logits), no gradient: for
    an encoder-decoder config ``encode`` then ``decode_train``.
  * serve step   = one cached decode step (``lm_decode_step``, or
    ``encdec_decode_step``), which updates the caches in place (the
    reference donates them).

The sharding settings (``zero_opt``, ``seq_shard``, ``fsdp``) are kept
with the reference's defaults; on one device they change no number, as
on the reference's (1, 1) mesh. Their multi-device meaning waits for
ROADMAP.md queue 1 item 12, as do ``abstract_params``, ``input_specs``,
``data_shardings`` and ``cache_pspec``, which serve the dry run and
sharding. The 8-bit moments
(``optim/quantized_state.py::adamw8bit``) carry the same
``update_in_place``, so a step composed of ``_value_and_grad``, the clip
and that update trains with int8 moments; the reference sets no step
setting for them, and neither does the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import ArchConfig
from repro_torch.models import encdec
from repro_torch.models.lm import (dtype_of, lm_decode_step, lm_forward,
                                   lm_loss)
from repro_torch.optim import (Optimizer, adamw, clip_scale, global_norm,
                               linear_warmup_cosine)


@dataclasses.dataclass(frozen=True)
class StepSettings:
    microbatches: int = 1
    remat: str = "dots"            # none | dots | full
    zero_opt: bool = True          # ZeRO-1 opt-state sharding
    seq_shard: bool = False        # SP: shard residual seq over 'model'
    fsdp: bool = False             # params data+model sharded (>= ~100B)
    grad_clip: float = 1.0
    lr: float = 3e-4
    moment_dtype: str = "float32"  # float32 | bfloat16
    acc_dtype: str = "float32"     # grad-accumulator dtype (bf16 >= ~340B)


def make_optimizer(s: StepSettings) -> Optimizer:
    return adamw(linear_warmup_cosine(s.lr, s.lr * 0.1, 200, 10_000),
                 weight_decay=0.1, moment_dtype=dtype_of(s.moment_dtype))


def split_microbatches(batch: Dict[str, torch.Tensor], m: int):
    """Each leaf (B, ...) as (m, B // m, ...): microbatch i is ``[i]``."""
    return pytree.tree_map(
        lambda x: x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:])), batch)


def _value_and_grad(loss_fn: Callable, params, batch
                    ) -> Tuple[torch.Tensor, Any, List[torch.Tensor]]:
    """(loss, metrics, grads) of ``loss_fn(params, batch) -> (loss,
    metrics)``; ``grads`` in ``pytree.tree_leaves(params)`` order, zeros
    for a leaf the loss does not reach (as ``jax.grad`` gives)."""
    leaves, spec = pytree.tree_flatten(params)
    with torch.enable_grad():
        live = [l.detach().requires_grad_(True) for l in leaves]
        loss, metrics = loss_fn(pytree.tree_unflatten(live, spec), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(l) if g is None else g
             for l, g in zip(leaves, grads)]
    return loss.detach(), pytree.tree_map(torch.Tensor.detach, metrics), grads


def make_train_step(cfg: ArchConfig, settings: StepSettings):
    """Returns ``(train_step, opt)``. ``train_step(params, opt_state, step,
    batch) -> (params, opt_state, metrics)`` updates ``params`` and
    ``opt_state`` in place and returns them; ``batch``: ``tokens`` and
    ``targets`` (B, S) int, and ``frames`` (B, T, d) for an
    encoder-decoder config or an optional ``frontend`` (B, N, d);
    ``metrics``: the loss's (``ce``, MoE aux) with ``loss`` and
    ``grad_norm`` (before clipping), 0-d tensors on the params' device
    (reading one is the caller's host sync)."""
    opt = make_optimizer(settings)
    acc_dt = dtype_of(settings.acc_dtype)

    def loss_fn(p, mb):
        if cfg.is_encdec:
            return encdec.encdec_loss(p, cfg, mb["frames"], mb["tokens"],
                                      mb["targets"], remat=settings.remat)
        return lm_loss(p, cfg, mb["tokens"], mb["targets"],
                       frontend=mb.get("frontend"), remat=settings.remat)

    def train_step(params, opt_state, step, batch):
        m = settings.microbatches
        if m == 1:
            loss, metrics, grads = _value_and_grad(loss_fn, params, batch)
        else:
            mbs = split_microbatches(batch, m)
            grads = [torch.zeros(l.shape, dtype=acc_dt, device=l.device)
                     for l in pytree.tree_leaves(params)]
            loss, mets = 0.0, []
            for i in range(m):
                l, met, g = _value_and_grad(
                    loss_fn, params, pytree.tree_map(lambda x: x[i], mbs))
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
                loss = loss + l
                mets.append(met)
            grads = [g / m for g in grads]
            loss = loss / m
            metrics = pytree.tree_map(lambda *a: torch.mean(torch.stack(a), 0),
                                      *mets)
        with torch.no_grad():
            gnorm = global_norm(grads)
            opt.update_in_place(grads, opt_state, params, step,
                                clip_scale(gnorm, settings.grad_clip))
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return params, opt_state, metrics

    return train_step, opt


def make_prefill_step(cfg: ArchConfig, settings: StepSettings):
    """``prefill(params, batch) -> logits``: the full-sequence forward of
    ``batch["tokens"]`` (float32 (B, S, V); with a ``frontend`` (B, N +
    S, V)), without gradient; for an encoder-decoder config the decoder's
    teacher-forced logits over ``encode(batch["frames"])``."""

    def prefill(params, batch):
        with torch.no_grad():
            if cfg.is_encdec:
                enc = encdec.encode(params, cfg, batch["frames"],
                                    remat=settings.remat)
                return encdec.decode_train(params, cfg, enc, batch["tokens"],
                                           remat=settings.remat)
            logits, _ = lm_forward(params, cfg, batch["tokens"],
                                   frontend=batch.get("frontend"),
                                   remat=settings.remat)
        return logits

    return prefill


def make_serve_step(cfg: ArchConfig):
    """``serve(params, token, caches, cur_index) -> (logits, caches)``: one
    cached decode step (``lm_decode_step``; ``encdec_decode_step`` over
    ``init_dec_cache``'s caches for an encoder-decoder config), the caches
    updated in place."""
    step = encdec.encdec_decode_step if cfg.is_encdec else lm_decode_step

    def serve(params, token, caches, cur_index):
        with torch.no_grad():
            return step(params, cfg, token, caches, cur_index)

    return serve
