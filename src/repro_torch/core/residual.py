"""Hypersolver fitting losses on captured residual samples — the port of
``ledger_fitting_loss`` and ``flow_fitting_loss`` of
``repro/core/residual.py`` (paper Sec. 3.2, Eq. 6).

Both fit the Eq. 6 local truncation residual

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

The trajectory losses (``residual_fitting_loss``,
``trajectory_fitting_loss``, ``combined_loss``) serve offline training
and wait for ROADMAP.md queue 1 item 7.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.integrate import _bcast

Pytree = Any


def _tree_sub(a: Pytree, b: Pytree) -> Pytree:
    return pytree.tree_map(lambda x, y: x - y, a, b)


def _tree_l2_rows(t: Pytree) -> torch.Tensor:
    """(N,) per-sample L2 norm over every leaf, in float32 (the
    reference's ``_tree_l2`` of each row)."""
    leaves = [torch.sum(l.float().reshape(l.shape[0], -1) ** 2, dim=1)
              for l in pytree.tree_leaves(t)]
    return torch.sqrt(sum(leaves) + 1e-24)


def _detach(t: Pytree) -> Pytree:
    return pytree.tree_map(lambda l: l.detach(), t)


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
