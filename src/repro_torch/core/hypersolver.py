"""Hypersolvers (paper Sec. 3): base explicit solver + learned residual
net — the port of ``repro/core/hypersolver.py``.

General p-th order hypersolved update (paper Eq. 5):

    z_{k+1} = z_k + eps * psi(s_k, x, z_k) + eps^{p+1} * g_omega(eps, s_k, x, z_k)

``HyperSolver`` is a thin alias over the unified ``Integrator`` engine
(core/integrate.py) kept for paper-facing call sites: ``g_omega`` is any
callable ``g(eps, s, z, dz) -> pytree like z`` where ``dz = f(s, z)`` is
the first RK stage, passed in for free reuse (the paper feeds ``g`` the
concatenation ``[z, dx, ds]``). Conditioning inputs ``x`` are closed over
inside both ``f`` and ``g`` (paper Eq. 1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.integrate import (Correction, Integrator, Pytree,
                                        VectorField)
from repro_torch.core.solvers import FixedGrid
from repro_torch.core.tableaus import get as get_tableau


@dataclasses.dataclass(frozen=True)
class HyperSolver(Integrator):
    """A base tableau paired with a correction network of matching order;
    ``fused=True`` runs each step's update as one launch of the
    ``hyper_step`` CUDA kernel (kernels/hyper_step)."""

    def odeint(self, f: VectorField, z0: Pytree, grid: FixedGrid,
               return_traj: bool = True):
        """Integrate with the unified engine over the fixed mesh."""
        return self.solve(f, z0, grid, return_traj=return_traj)


def make(base: str, g: Optional[Correction] = None) -> HyperSolver:
    return HyperSolver(tableau=get_tableau(base), g=g)
