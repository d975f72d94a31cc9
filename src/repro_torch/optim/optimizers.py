"""Optimizers as (init, update) pairs over parameter trees — the port of
``repro/optim/optimizers.py`` (AdamW with decoupled weight decay and the
global-norm clip the hypersolver fits use).

Functional, as the reference is: ``update(grads, state, params, step)``
returns new update and moment trees and never writes a tensor in place,
so a caller may hand the old params to another thread (an async
checkpoint) or keep serving them while the next step runs. Trees are
nested dicts/lists/tuples of tensors (``torch.utils._pytree``).

The arithmetic is the reference's, step for step: the schedule is read
at ``step + 1``, the moments stay float32, the bias corrections are
float32 powers of the step, and the weight decay is added to the
normalised direction before the learning rate scales it. Not
``torch.optim.AdamW``, which decays the parameter separately and keeps
its own step count.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

Params = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[..., Any]  # (grads, state, params, step) -> (updates, state)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    leaves = [torch.sum(l.float() ** 2) for l in pytree.tree_leaves(tree)]
    return torch.sqrt(sum(leaves))


def clip_by_global_norm(tree: Params, max_norm: float):
    """The tree scaled so its global norm is at most ``max_norm``, and the
    norm before clipping."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return pytree.tree_map(lambda l: l * scale, tree), norm


def apply_updates(params: Params, updates: Params) -> Params:
    return pytree.tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


class AdamState(NamedTuple):
    mu: Params
    nu: Params


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0,
          moment_dtype: torch.dtype = torch.float32) -> Optimizer:
    """AdamW (Loshchilov & Hutter 2017). ``lr`` is a float or a schedule
    of the step (``optim/schedules.py``)."""
    sched = lr if callable(lr) else (
        lambda s: torch.as_tensor(lr, dtype=torch.float32, device=s.device))

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                      device=p.device)
        return AdamState(mu=pytree.tree_map(zeros, params),
                         nu=pytree.tree_map(zeros, params))

    def update(grads, state: AdamState, params, step):
        dev = pytree.tree_leaves(params)[0].device
        step = torch.as_tensor(step, dtype=torch.float32, device=dev) + 1.0
        lr_t = sched(step)

        def upd_mu(g, m):
            return (b1 * m.float() + (1 - b1) * g.float()).to(moment_dtype)

        def upd_nu(g, v):
            g32 = g.float()
            return (b2 * v.float() + (1 - b2) * g32 * g32).to(moment_dtype)

        mu = pytree.tree_map(upd_mu, grads, state.mu)
        nu = pytree.tree_map(upd_nu, grads, state.nu)
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
        bc1 = 1.0 - f32(b1) ** step
        bc2 = 1.0 - f32(b2) ** step

        def upd(p, m, v):
            m_hat = m.float() / bc1
            v_hat = v.float() / bc2
            step_dir = m_hat / (torch.sqrt(v_hat) + eps)
            if weight_decay:
                step_dir = step_dir + weight_decay * p.float()
            return -lr_t * step_dir

        updates = pytree.tree_map(upd, params, mu, nu)
        return updates, AdamState(mu=mu, nu=nu)

    return Optimizer(init=init, update=update)
