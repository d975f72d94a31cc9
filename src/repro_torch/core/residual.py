"""Hypersolver training losses (paper Sec. 3.2) — the port of
``repro/core/residual.py``.

Residual fitting targets the *local* truncation error (Theorem 1);
trajectory fitting targets the *global* truncation error. Both take
ground-truth trajectories {z(s_k)} from a tightly tolerated adaptive
solver (``core/adaptive.py``). Their norm, as the reference's ``_tree_l2``,
is ONE L2 norm over every leaf of the whole batch at each mesh step k
(then a mean over k, or a sum for the trajectory loss) — not a per-row
norm. The reference maps the K mesh steps in parallel (``jax.vmap``);
here they are a loop of K field evaluations, since a depth ``s`` that
differs per step cannot ride a conv field's batch axis.

``ledger_fitting_loss`` and ``flow_fitting_loss`` fit the Eq. 6 local
truncation residual

    R_i = [z(s_i + eps_i) - z_i - eps_i * psi_i] / eps_i^{p+1}

over rows ``(s_i, eps_i, z_i, dz_i, R_i)`` the online refinery captured
from live traffic (``launch/refinery.py``), so neither needs the vector
field. ``s``/``eps`` are ``(N,)`` rows; ``z``/``dz``/``R`` are trees
whose leaves carry a leading sample axis. The reference maps a per-row
function over the samples (``jax.vmap``); here the net is called once
on the whole batch, which every net of this package accepts (per-row
``s`` and ``eps`` rows broadcast from the leading axis), and the
per-sample norms are taken over each row's own elements. Rows are data:
they are detached, and only the net's parameters see gradients.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.integrate import (Integrator, VectorField, _bcast,
                                        rk_psi, tree_axpy)
from repro_torch.core.solvers import FixedGrid
from repro_torch.core.tableaus import Tableau

Pytree = Any


def _tree_sub(a: Pytree, b: Pytree) -> Pytree:
    return pytree.tree_map(lambda x, y: x - y, a, b)


def _tree_l2(t: Pytree) -> torch.Tensor:
    """One L2 norm over every element of every leaf, in float32 (the
    reference's ``_tree_l2``): a whole batch's norm, a 0-d tensor."""
    leaves = [torch.sum(l.float() ** 2) for l in pytree.tree_leaves(t)]
    return torch.sqrt(sum(leaves) + 1e-24)


def _index(traj: Pytree, k) -> Pytree:
    return pytree.tree_map(lambda l: l[k], traj)


def _knots(grid: FixedGrid, like: torch.Tensor) -> torch.Tensor:
    """s_k = s0 + eps * k for k < K, float32 on ``like``'s device."""
    return grid.s0 + grid.eps * torch.arange(grid.K, dtype=torch.int32,
                                             device=like.device)


def _tree_l2_rows(t: Pytree) -> torch.Tensor:
    """(N,) per-sample L2 norm over every leaf, in float32 (the
    reference's ``_tree_l2`` of each row)."""
    leaves = [torch.sum(l.float().reshape(l.shape[0], -1) ** 2, dim=1)
              for l in pytree.tree_leaves(t)]
    return torch.sqrt(sum(leaves) + 1e-24)


def _detach(t: Pytree) -> Pytree:
    return pytree.tree_map(lambda l: l.detach(), t)


def solver_residual(f: VectorField, tab: Tableau, s, eps, z_k: Pytree,
                    z_k1: Pytree):
    """R(s_k, z(s_k), z(s_{k+1})) = [z(s_{k+1}) - z(s_k) - eps psi] /
    eps^{p+1} (paper Eq. 6). Also returns dz = f(s_k, z_k) for reuse by
    g_omega."""
    psi, stages = rk_psi(f, tab, s, eps, z_k)
    pred = tree_axpy(eps, psi, z_k)
    resid = pytree.tree_map(
        lambda a, b: (a - b) / (eps ** (tab.order + 1)), z_k1, pred)
    return resid, stages[0]


def _require_g(hs: Integrator) -> None:
    if hs.g is None:
        raise ValueError("a fitting loss needs an Integrator with a "
                         "correction g")


def residual_fitting_loss(hs: Integrator, f: VectorField, traj: Pytree,
                          grid: FixedGrid) -> torch.Tensor:
    """ell = (1/K) sum_k || R_k - g(eps, s_k, z(s_k)) ||_2  (paper Sec. 3.2).

    ``traj`` has a leading mesh axis of length K+1 and is ground truth:
    it is detached, and R_k and dz are computed without gradients (the
    paper's reference implementation detaches f's evaluations), so only
    g's parameters see gradients."""
    _require_g(hs)
    traj = _detach(traj)
    s_knots = _knots(grid, pytree.tree_leaves(traj)[0])
    losses = []
    for k in range(grid.K):
        z_k = _index(traj, k)
        with torch.no_grad():
            resid, dz = solver_residual(f, hs.tableau, s_knots[k], grid.eps,
                                        z_k, _index(traj, k + 1))
        pred = hs.g(grid.eps, s_knots[k], z_k, dz)
        losses.append(_tree_l2(_tree_sub(resid, pred)))
    return torch.mean(torch.stack(losses))


def ledger_fitting_loss(g: Callable, s: torch.Tensor, eps: torch.Tensor,
                        z: Pytree, dz: Pytree, R: Pytree) -> torch.Tensor:
    """ell = (1/N) sum_i || R_i - g(eps_i, s_i, z_i, dz_i) ||_2."""
    z, dz, R = _detach(z), _detach(dz), _detach(R)
    pred = g(eps, s, z, dz)
    return torch.mean(_tree_l2_rows(_tree_sub(R, pred)))


def flow_fitting_loss(flow: Callable, s: torch.Tensor, eps: torch.Tensor,
                      z: Pytree, dz: Pytree, R: Pytree, order: int = 1,
                      relative: bool = False) -> torch.Tensor:
    """Fit a flow head (core/flowhead.py) on the same rows g trains on:
    the true step is ``z_i + eps_i dz_i + eps_i^{p+1} R_i``, and

        ell = (1/N) sum_i || z(s_i+eps_i) - F(eps_i, s_i, z_i, dz_i) ||_2
                    / eps_i^{p+1}

    (for the structured ``make_flow_apply`` head, exactly
    ``ledger_fitting_loss`` of its net). ``relative=True`` divides each
    sample by ``1 + ||R_i||``, so the hardest rows of a mixed ledger do
    not dominate the fit of a tier that only serves easy ones."""
    z, dz, R = _detach(z), _detach(dz), _detach(R)
    scale = eps ** (order + 1)
    target = pytree.tree_map(
        lambda zl, dzl, Rl: zl + _bcast(eps, dzl) * dzl
        + _bcast(scale, Rl) * Rl, z, dz, R)
    pred = flow(eps, s, z, dz)
    ell = _tree_l2_rows(_tree_sub(target, pred)) / scale
    if relative:
        ell = ell / (1.0 + _tree_l2_rows(R))
    return torch.mean(ell)


def trajectory_fitting_loss(hs: Integrator, f: VectorField, traj: Pytree,
                            grid: FixedGrid) -> torch.Tensor:
    """L = sum_k || z(s_k) - z_k ||_2 with z_k the unrolled hypersolve."""
    _require_g(hs)
    traj = _detach(traj)
    s_knots = _knots(grid, pytree.tree_leaves(traj)[0])
    z = _index(traj, 0)
    losses = []
    for k in range(grid.K):
        z, _, _ = hs.step(f, s_knots[k], grid.eps, z)
        losses.append(_tree_l2(_tree_sub(_index(traj, k + 1), z)))
    return torch.sum(torch.stack(losses))


def combined_loss(hs: Integrator, f: VectorField, traj: Pytree,
                  grid: FixedGrid, residual_weight: float = 1.0,
                  trajectory_weight: float = 0.0) -> torch.Tensor:
    """Residual and trajectory fitting 'can be combined into a single loss
    term, depending on the application' (paper Sec. 3.2)."""
    loss = torch.zeros((), dtype=torch.float32,
                       device=pytree.tree_leaves(traj)[0].device)
    if residual_weight:
        loss = loss + residual_weight * residual_fitting_loss(hs, f, traj,
                                                              grid)
    if trajectory_weight:
        loss = loss + trajectory_weight * trajectory_fitting_loss(
            hs, f, traj, grid)
    return loss
