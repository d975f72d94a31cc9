"""Hypersolver training harness (paper Sec. 3.2 + Appendix C.2) — the
port of ``repro/core/train.py``.

``make_fit_step`` is the one optimizer step every fitting loop shares
(offline ``train_hypersolver`` and ``train_flowhead``, and the online
refinery's candidate g or flow head): loss and gradient, global-norm
clip, AdamW update, apply. The gradient is ``torch.autograd.grad`` over
the parameter leaves only; the step returns new tensors and writes none
in place, so the params a serving loop holds (or an async checkpoint is
writing) never change under it.

``train_hypersolver`` keeps the paper's two-phase protocol: (1) pretrain
on the trajectories of a single batch for ``pretrain_iters``; (2) swap
the batch every ``swap_every`` iterations so g_omega generalizes across
initial conditions. Ground truth is dopri5 at tight tolerances; residual
fitting needs no task supervision.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.hypersolver import HyperSolver
from repro_torch.core.integrate import Integrator
from repro_torch.core.residual import combined_loss, flow_fitting_loss
from repro_torch.core.solvers import FixedGrid
from repro_torch.core.tableaus import Tableau, get as get_tableau
from repro_torch.optim import (Optimizer, adamw, apply_updates,
                               clip_by_global_norm)
from repro_torch.optim.schedules import cosine_annealing

# g_apply(g_params, eps, s, x, z, dz) -> correction pytree like z
GApply = Callable[..., Any]


@dataclasses.dataclass
class HypersolverTrainConfig:
    base_solver: str = "euler"
    K: int = 10                   # mesh length (paper: K=10 image cls, K=1 CNF)
    iters: int = 1000
    pretrain_iters: int = 10      # phase-1 single-batch iterations
    swap_every: int = 10          # paper: swap batch every 10 iters (100 for CNF)
    lr: float = 1e-2              # paper C.2: AdamW lr=1e-2
    lr_min: float = 5e-4          # cosine anneal floor (paper: 5e-4)
    weight_decay: float = 1e-6
    grad_clip: float = 10.0
    atol: float = 1e-4            # dopri5 gt tolerances (paper: 1e-4 img, 1e-5 CNF)
    rtol: float = 1e-4
    residual_weight: float = 1.0
    trajectory_weight: float = 0.0


def bind_g(g_apply: GApply, g_params, x) -> Callable:
    """Close g over (params, x) to the core Correction signature."""
    return lambda eps, s, z, dz: g_apply(g_params, eps, s, x, z, dz)


def make_hypersolver(base, g_apply: GApply, g_params, x) -> HyperSolver:
    tab = base if isinstance(base, Tableau) else get_tableau(base)
    return HyperSolver(tableau=tab, g=bind_g(g_apply, g_params, x))


def make_integrator(base, g_apply: Optional[GApply] = None, g_params=None,
                    x=None, fused: bool = False) -> Integrator:
    """Unified-engine twin of ``make_hypersolver``: an Integrator over the
    base tableau, with g bound over (params, x) when a correction is
    given."""
    tab = base if isinstance(base, Tableau) else get_tableau(base)
    g = bind_g(g_apply, g_params, x) if g_apply is not None else None
    return Integrator(tableau=tab, g=g, fused=fused)


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


def train_hypersolver(node, model_params: Any, g_apply: GApply,
                      g_params: Any, batches: Iterator[Any],
                      cfg: HypersolverTrainConfig, log_every: int = 0,
                      logger: Optional[Callable[[int, float], None]] = None):
    """Fit g_omega by residual (and/or trajectory) fitting against dopri5
    trajectories of ``node`` (core/neural_ode.py) on the batches ``x``
    that ``batches`` yields. Returns (g_params, losses list)."""
    tab = get_tableau(cfg.base_solver)
    opt = adamw(cosine_annealing(cfg.lr, cfg.lr_min, cfg.iters),
                weight_decay=cfg.weight_decay)
    opt_state = opt.init(g_params)
    grid = FixedGrid.over(node.s_span[0], node.s_span[1], cfg.K)

    def reference(x):
        traj, _, _ = node.reference_trajectory(model_params, x, cfg.K,
                                               atol=cfg.atol, rtol=cfg.rtol)
        return traj

    def loss_fn(gp, x, traj):
        hs = make_hypersolver(tab, g_apply, gp, x)
        return combined_loss(hs, node.field(model_params, x), traj, grid,
                             residual_weight=cfg.residual_weight,
                             trajectory_weight=cfg.trajectory_weight)

    fit_step = make_fit_step(loss_fn, opt, cfg.grad_clip)
    losses = []
    x = next(batches)
    traj = reference(x)
    for it in range(cfg.iters):
        if it >= cfg.pretrain_iters and it % cfg.swap_every == 0:
            x = next(batches)
            traj = reference(x)
        g_params, opt_state, loss = fit_step(g_params, opt_state, it, x, traj)
        losses.append(float(loss))
        if log_every and logger and it % log_every == 0:
            logger(it, float(loss))
    return g_params, losses
