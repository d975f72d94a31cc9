"""Adaptive-step Dormand-Prince 5(4) — the paper's ground-truth solver,
the port of ``odeint_dopri5`` of ``repro/core/adaptive.py``.

It gives the "exact" solution checkpoints z(s_k) at mesh points for
hypersolver training (paper Sec. 3.2: "practically obtained through an
adaptive-step solver set up with low tolerances"). One step of the pair,
the error ratio and the clamped step factor are the shared embedded-error
path of ``core/controllers.py``.

Where the reference runs a ``lax.while_loop`` per mesh segment, the port
runs an eager loop: the step size, the current depth and the accept
decision stay float32 tensors on the state's device, and each step reads
back one boolean (is the segment's end still ahead?) — one host sync a
step. As in the reference, a segment stops after ``max_steps * 6`` field
evaluations, and the solve is not differentiated through: it runs under
``torch.no_grad()`` (trainers detach its outputs, the paper's
``.detach()``). ``odeint_dopri5_batched`` waits for ROADMAP.md queue 1
item 8.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.controllers import (embedded_step, error_ratio,
                                          step_factor)
from repro_torch.core.integrate import _stack, with_initial
from repro_torch.core.solvers import FixedGrid, Pytree, VectorField
from repro_torch.core.tableaus import DOPRI5


def _integrate_segment(f, z0, s0, s1, eps0, atol, rtol, max_steps):
    """Adaptively integrate from s0 to s1 (0-d float32 tensors on the
    state's device); returns (z(s1), last eps, nfe)."""
    s, z, eps, nfe = s0, z0, eps0, 0
    s_end = s1 - 1e-12
    while nfe < max_steps * 6 and bool(s < s_end):
        h = torch.minimum(eps, s1 - s)
        z_new, err, _ = embedded_step(f, DOPRI5, s, h, z)
        ratio = error_ratio(z, z_new, err, atol, rtol)
        accept = ratio <= 1.0
        eps = torch.minimum(
            torch.clamp(h * step_factor(ratio, DOPRI5.order), min=1e-8),
            s1 - s0)
        z = pytree.tree_map(lambda a, b: torch.where(accept, a, b), z_new, z)
        s = torch.where(accept, s + h, s)
        nfe += 6
    return z, eps, nfe


def odeint_dopri5(f: VectorField, z0: Pytree, grid: FixedGrid,
                  atol: float = 1e-5, rtol: float = 1e-5,
                  max_steps_per_segment: int = 1000):
    """Solve the IVP, emitting the solution at every mesh point of ``grid``
    (scalar eps). Returns (trajectory with leading axis K+1, total NFE as
    a Python int). The trajectory is the hypersolver training target
    {(s_k, z(s_k))} of paper Sec. 3.2."""
    dev = pytree.tree_leaves(z0)[0].device
    eps = torch.as_tensor(grid.eps, dtype=torch.float32).to(dev)
    if eps.ndim:
        raise ValueError("odeint_dopri5 takes a scalar-eps grid; per-sample "
                         "solves are odeint_dopri5_batched (not ported yet, "
                         "ROADMAP.md queue 1 item 8)")
    span = grid.s_span.to(dev)
    z, traj, nfe = z0, [], 0
    with torch.no_grad():
        for k in range(grid.K):
            z, eps, n = _integrate_segment(
                f, z, span[k], span[k + 1], eps, atol, rtol,
                max_steps_per_segment)
            traj.append(z)
            nfe += n
    return with_initial(z0, _stack(traj)), nfe
