"""General Neural ODE formulation (paper Eq. 1, Massaroli et al. 2020b) —
the port of ``repro/core/neural_ode.py``:

    z' = f_theta(s, x, z),  z(0) = h_x(x),  y_hat(s) = h_y(z(s))

``h_x`` / ``h_y`` are kept linear maps (paper Sec. 2). The module is
functional: parameters are explicit dicts of tensors, and the three maps
are ``apply(params, ...)`` callables. All integration routes through the
unified ``Integrator`` engine (core/integrate.py); ``solver`` arguments
accept an Integrator, a HyperSolver, a Tableau, or a tableau name.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from torch.utils import _pytree as pytree

from repro_torch.core.adaptive import odeint_dopri5
from repro_torch.core.integrate import as_integrator
from repro_torch.core.solvers import FixedGrid
from repro_torch.core.tableaus import Tableau

Params = Any
Apply = Callable[..., Any]


@dataclasses.dataclass(frozen=True)
class NeuralODE:
    """Functional Neural ODE. ``f_apply(params, s, x, z) -> dz``.

    ``hx_apply(params, x) -> z0`` and ``hy_apply(params, z) -> y`` are the
    linear input/output maps; identity lambdas are valid.
    """

    f_apply: Apply
    hx_apply: Apply
    hy_apply: Apply
    s_span: tuple = (0.0, 1.0)

    def field(self, params: Params, x: Any) -> Callable:
        """Close f over (params, x): the VectorField handed to solvers."""
        return lambda s, z: self.f_apply(params, s, x, z)

    def grid(self, K: int) -> FixedGrid:
        return FixedGrid.over(self.s_span[0], self.s_span[1], K)

    def solve(self, params: Params, x: Any, solver, K: int,
              return_traj: bool = False, checkpoint: bool = False):
        integ = as_integrator(solver)
        f = self.field(params, x)
        z0 = self.hx_apply(params, x)
        return integ.solve(f, z0, self.grid(K), return_traj=return_traj,
                           checkpoint=checkpoint)

    def forward(self, params: Params, x: Any, solver, K: int):
        """y_hat(S) = h_y(z(S)) (paper Sec. 2)."""
        zT = self.solve(params, x, solver, K, return_traj=False)
        return self.hy_apply(params, zT)

    def reference_trajectory(self, params: Params, x: Any, K: int,
                             atol: float = 1e-5, rtol: float = 1e-5):
        """Ground-truth mesh checkpoints {z(s_k)} via dopri5 (paper Sec.
        3.2), detached: (trajectory, grid, nfe)."""
        grid = self.grid(K)
        f = self.field(params, x)
        z0 = self.hx_apply(params, x)
        traj, nfe = odeint_dopri5(f, z0, grid, atol=atol, rtol=rtol)
        return pytree.tree_map(lambda l: l.detach(), traj), grid, nfe

    def forward_fixed(self, params: Params, x: Any, tab: Tableau, K: int):
        """Plain fixed-step baseline forward (no hypersolver)."""
        return self.forward(params, x, as_integrator(tab), K)
