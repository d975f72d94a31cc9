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
``.detach()``).

``odeint_dopri5_batched`` is the reference's ``jax.vmap`` of the whole
solve: every sample of a leading batch axis keeps its own depth, step
size, NFE and done flag on the device, and runs its own accept/reject
sequence. The field and the error ratio are called per sample through
``torch.func.vmap``, as ``jax.vmap`` calls them (``f`` sees one sample's
unbatched state and a 0-d ``s``); the loop runs while any row's segment
is still open, one host sync a step, and a row whose segment has closed
keeps its state, as a ``while_loop`` under ``vmap`` does.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.controllers import (embedded_step, error_ratio,
                                          step_factor)
from repro_torch.core.integrate import _bcast, _stack, with_initial
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
        raise ValueError("odeint_dopri5 takes a scalar-eps grid; for "
                         "per-sample step sequences over a batch axis use "
                         "odeint_dopri5_batched")
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


def _batched_segment(step, z0, s0, s1, eps0, max_steps):
    """Per-sample adaptive integration from s0 to s1 (0-d float32 tensors)
    of every row of ``z0``; ``eps0`` and the returned eps and nfe are
    ``(B,)`` rows. ``step(s, h, z) -> (z_new, ratio)`` is vmapped."""
    s = torch.zeros_like(eps0) + s0
    z, eps = z0, eps0
    nfe = torch.zeros(eps0.shape, dtype=torch.int32, device=eps0.device)
    s_end = s1 - 1e-12
    while True:
        live = (s < s_end) & (nfe < max_steps * 6)
        if not bool(live.any()):
            return z, eps, nfe
        h = torch.minimum(eps, s1 - s)
        z_new, ratio = step(s, h, z)
        accept = live & (ratio <= 1.0)
        new_eps = torch.minimum(
            torch.clamp(h * step_factor(ratio, DOPRI5.order), min=1e-8),
            s1 - s0)
        z = pytree.tree_map(lambda a, b: torch.where(_bcast(accept, a), a, b),
                            z_new, z)
        s = torch.where(accept, s + h, s)
        eps = torch.where(live, new_eps, eps)
        nfe = nfe + 6 * live.to(torch.int32)


def odeint_dopri5_batched(f: VectorField, z0: Pytree, grid: FixedGrid,
                          atol: float = 1e-5, rtol: float = 1e-5,
                          max_steps_per_segment: int = 1000):
    """``odeint_dopri5`` over a leading batch axis of ``z0``, each sample
    with its OWN accept/reject step sequence (scalar-eps grid), so stiff
    rows take more internal steps than easy rows, and the returned
    per-sample NFE exposes exactly that, the signal multi-rate serving
    buckets on. ``f`` is called with per-sample (unbatched) states and a
    0-d ``s``. Returns (trajectory with leading axes (B, K+1), nfe (B,)
    int32)."""
    leaves = pytree.tree_leaves(z0)
    dev, B = leaves[0].device, leaves[0].shape[0]
    eps = torch.as_tensor(grid.eps, dtype=torch.float32).to(dev)
    if eps.ndim:
        raise ValueError("odeint_dopri5_batched takes a scalar-eps grid")
    span = grid.s_span.to(dev)

    def one(s, h, z):
        z_new, err, _ = embedded_step(f, DOPRI5, s, h, z)
        return z_new, error_ratio(z, z_new, err, atol, rtol)

    step = torch.func.vmap(one)
    eps = eps.expand(B).contiguous()
    z, traj = z0, []
    nfe = torch.zeros(B, dtype=torch.int32, device=dev)
    with torch.no_grad():
        for k in range(grid.K):
            z, eps, n = _batched_segment(step, z, span[k], span[k + 1], eps,
                                         max_steps_per_segment)
            traj.append(z)
            nfe = nfe + n
    traj = with_initial(z0, _stack(traj))
    return pytree.tree_map(lambda l: l.movedim(0, 1), traj), nfe
