"""Fixed-grid solver API over pytree states (paper Eq. 2-3) — the port of
``repro/core/solvers.py``.

The integration engine is ``repro_torch.core.integrate``; this module
keeps the mesh definition (``FixedGrid``) and the thin wrappers
(``odeint_fixed``, ``local_error``) so numerical code reads like the
paper. A vector field is any callable ``f(s, z) -> dz`` over a pytree
``z``; conditioning inputs ``x`` are closed over (paper Eq. 1).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.integrate import (  # noqa: F401 — re-exported leaf algebra
    Integrator,
    Pytree,
    VectorField,
    rk_psi,
    rk_stages,
    tree_axpy,
    tree_lincomb,
    with_initial,
)
from repro_torch.core.tableaus import Tableau


class FixedGrid(NamedTuple):
    """Uniform depth mesh s_k = s0 + k * eps, k = 0..K (paper Sec. 2).

    ``eps`` may be a scalar or a tensor with a leading batch axis
    (per-sample step sizes for multi-rate serving — the Integrator
    broadcasts it leaf-wise against the state).
    """

    s0: float
    eps: Any
    K: int

    @property
    def s_span(self) -> torch.Tensor:
        """The K+1 mesh points, float32 as the reference computes them
        (an int32 step index times eps); with a batched eps, a
        ``(K+1, *eps.shape)`` mesh, one column per sample. On eps's
        device when eps is a tensor, else on the CPU."""
        ks = torch.arange(self.K + 1, dtype=torch.int32)
        eps = self.eps
        if isinstance(eps, torch.Tensor):
            ks = ks.to(eps.device).reshape((-1,) + (1,) * eps.ndim)
        return self.s0 + eps * ks

    @classmethod
    def over(cls, s0: float, s1: float, K: int) -> "FixedGrid":
        return cls(s0=s0, eps=(s1 - s0) / K, K=K)

    @classmethod
    def over_batched(cls, s0: float, s1, K: int) -> "FixedGrid":
        """Per-sample spans: ``s1`` a row -> float32 eps with a batch axis."""
        s1 = s1 if isinstance(s1, torch.Tensor) \
            else torch.as_tensor(s1, dtype=torch.float32)
        return cls(s0=s0, eps=(s1 - s0) / K, K=K)


def odeint_fixed(f: VectorField, z0: Pytree, grid: FixedGrid, tab: Tableau,
                 return_traj: bool = True):
    """Integrate z' = f(s, z) on a fixed grid with an explicit RK method:
    ``Integrator(tab).solve``. Returns the trajectory stacked on a leading
    axis of length K+1 (z0 included) if ``return_traj``, else the
    terminal state."""
    return Integrator(tableau=tab).solve(f, z0, grid,
                                         return_traj=return_traj)


def local_error(f: VectorField, tab: Tableau, s, eps, z_true: Pytree,
                z_true_next: Pytree) -> torch.Tensor:
    """Local truncation error e_k = ||z(s_{k+1}) - z(s_k) - eps psi||
    (Sec. 2): one L2 norm over every leaf of the whole batch, in float32."""
    psi, _ = rk_psi(f, tab, s, eps, z_true)
    pred = tree_axpy(eps, psi, z_true)
    diff = pytree.tree_map(lambda a, b: a - b, z_true_next, pred)
    return torch.sqrt(sum(torch.sum(l.float() ** 2)
                          for l in pytree.tree_leaves(diff)))


def nfe_per_step(tab: Tableau) -> int:
    """Number of vector-field evaluations per solver step (= p for RK-p)."""
    return tab.stages
