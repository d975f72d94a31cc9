"""Fitting harness — the port of ``make_fit_step``, ``FlowTrainConfig``
and ``train_flowhead`` of ``repro/core/train.py``.

``make_fit_step`` is the one optimizer step every fitting loop shares
(the online refinery's candidate g or flow head, and the offline flow
head fit): loss and gradient, global-norm clip, AdamW update, apply. The
gradient is ``torch.autograd.grad`` over the parameter leaves only; the
step returns new tensors and writes none in place, so the params a
serving loop holds (or an async checkpoint is writing) never change
under it. ``train_hypersolver`` and its trajectory losses wait for
ROADMAP.md queue 1 item 7.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.residual import flow_fitting_loss
from repro_torch.optim import (Optimizer, adamw, apply_updates,
                               clip_by_global_norm)
from repro_torch.optim.schedules import cosine_annealing


def batch_to(b, device):
    """A ledger batch (``ResidualLedger.sample_batch``) on ``device``."""
    return {k: pytree.tree_map(lambda l: l.to(device), v)
            for k, v in b.items()}


def make_fit_step(loss_fn: Callable, opt: Optimizer, grad_clip: float):
    """``fit_step(gp, opt_state, step, *batch) -> (gp', opt_state',
    loss)``: value and grad of ``loss_fn(gp, *batch)``, clip by global
    norm, update, apply. ``loss`` is a 0-d tensor on the params' device
    (reading it is the caller's host sync)."""

    def fit_step(gp, opt_state, step, *batch):
        leaves, spec = pytree.tree_flatten(gp)
        with torch.enable_grad():
            live = [l.detach().requires_grad_(True) for l in leaves]
            loss = loss_fn(pytree.tree_unflatten(live, spec), *batch)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = pytree.tree_unflatten(
            [torch.zeros_like(l) if g is None else g
             for l, g in zip(leaves, grads)], spec)
        with torch.no_grad():
            grads, _ = clip_by_global_norm(grads, grad_clip)
            updates, opt_state = opt.update(grads, opt_state, gp, step)
            gp = apply_updates(gp, updates)
        return gp, opt_state, loss.detach()

    return fit_step


@dataclasses.dataclass
class FlowTrainConfig:
    """Offline flow-head fitting knobs; the defaults match the refinery's
    online fit (``launch/refinery.py::RefineryConfig``)."""

    iters: int = 400
    batch_size: int = 64
    lr: float = 3e-3
    lr_min: float = 1e-4
    weight_decay: float = 1e-6
    grad_clip: float = 10.0
    order: int = 1                # base solver order p (eps^{p+1} scaling)
    relative: bool = True         # per-sample ||R||-normalised objective
    seed: int = 0


def train_flowhead(flow_apply: Callable, flow_params: Any, ledger: Any,
                   cfg: Optional[FlowTrainConfig] = None,
                   log_every: int = 0,
                   logger: Optional[Callable[[int, float], None]] = None):
    """Fit a flow head on residual-ledger rows (any source with the
    ``ResidualLedger.sample_batch(n, rng)`` contract), on the device of
    ``flow_params``. Returns (flow_params, losses list)."""
    cfg = cfg or FlowTrainConfig()
    opt = adamw(cosine_annealing(cfg.lr, cfg.lr_min, cfg.iters),
                weight_decay=cfg.weight_decay)
    opt_state = opt.init(flow_params)
    device = pytree.tree_leaves(flow_params)[0].device

    def loss_fn(fp, s, eps, z, dz, R):
        flow = lambda e, si, zi, dzi: flow_apply(fp, e, si, zi, dzi)
        return flow_fitting_loss(flow, s, eps, z, dz, R, order=cfg.order,
                                 relative=cfg.relative)

    fit_step = make_fit_step(loss_fn, opt, cfg.grad_clip)
    rng = np.random.RandomState(cfg.seed)
    losses = []
    for it in range(cfg.iters):
        b = batch_to(ledger.sample_batch(cfg.batch_size, rng), device)
        flow_params, opt_state, loss = fit_step(
            flow_params, opt_state, it,
            b["s"], b["eps"], b["z"], b["dz"], b["R"])
        losses.append(float(loss))
        if log_every and logger and it % log_every == 0:
            logger(it, float(loss))
    return flow_params, losses
