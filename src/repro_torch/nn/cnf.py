"""Continuous normalizing flows (FFJORD variant, paper Sec. 4.2) — the
port of ``repro/nn/cnf.py``.

State is the pytree (z, logp). Dynamics:

    dz/ds    = f_theta(s, z)
    dlogp/ds = -tr(df/dz)(s, z)

Exact trace via one forward-mode product per dimension
(``torch.func.jvp``, cheap for the paper's 2-D densities; reverse-mode
autograd passes through it, so the NLL trains through the solver, and
``torch.func.vmap`` takes it, so per-sample solvers can call it on one
sample's state); the Hutchinson estimator is there for higher
dimensions. The flow maps base N(0, I) at s=0 to data at s=1 ("sampling
direction"); density evaluation integrates the reversed field.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import FixedGrid, as_integrator
from repro_torch.nn.module import mlp_apply, mlp_init


def cnf_mlp_init(gen: torch.Generator, dim: int = 2, hidden=(128, 128, 128),
                 param_dtype=torch.float32, device=None):
    """Paper C.3: three-layer MLP of hidden dims 128,128,128; input [z, s]."""
    return mlp_init(gen, (dim + 1, *hidden, dim), param_dtype, device=device)


def depth_column(s, z: torch.Tensor) -> torch.Tensor:
    """The depth ``s`` as a column beside z, broadcast to ``z[..., :1]``'s
    shape as the reference's ``jnp.broadcast_to``: a scalar fills it, and
    a per-sample ``(B,)`` depth of B > 1 raises, as it does there. A
    Python number is filled on z's device (no host-to-device copy)."""
    if not isinstance(s, torch.Tensor):
        return torch.full(z[..., :1].shape, s, dtype=z.dtype, device=z.device)
    return torch.broadcast_to(s.to(device=z.device, dtype=z.dtype),
                              z[..., :1].shape)


def cnf_field(params) -> Callable:
    def f(s, z):
        return mlp_apply(params, torch.cat([z, depth_column(s, z)], -1),
                         act=torch.tanh)
    return f


def _basis(z: torch.Tensor, i: int) -> torch.Tensor:
    """The i-th unit vector of z's last axis, broadcast to z's shape."""
    hot = torch.arange(z.shape[-1], device=z.device) == i
    return torch.zeros_like(z) + hot.to(z.dtype)


def exact_trace_dynamics(params) -> Callable:
    """VectorField over (z, logp) with exact divergence (per-dim jvp)."""
    f = cnf_field(params)

    def aug(s, state):
        z, _ = state
        dz = f(s, z)
        tr = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
        for i in range(z.shape[-1]):
            _, jv = torch.func.jvp(lambda zz: f(s, zz), (z,), (_basis(z, i),))
            tr = tr + jv[..., i]
        return (dz, -tr)

    return aug


def rademacher_trace(f: Callable, s, z: torch.Tensor,
                     probes: torch.Tensor) -> torch.Tensor:
    """Hutchinson estimate of tr(df/dz)(s, z) over the given probes: the
    mean over i of ``probes[i] . (df/dz probes[i])``, per sample."""
    tr = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
    for e in probes:
        _, jv = torch.func.jvp(lambda zz: f(s, zz), (z,), (e,))
        tr = tr + torch.sum(jv * e, dim=-1)
    return tr / probes.shape[0]


def hutchinson_dynamics(params, gen: torch.Generator, n_samples: int = 1
                        ) -> Callable:
    """Stochastic trace estimator (Rademacher) for high-dim CNFs. As in
    the reference, every evaluation sees the same probes: they are drawn
    from ``gen`` once per state shape, then reused."""
    f = cnf_field(params)
    probes = {}

    def aug(s, state):
        z, _ = state
        key = (tuple(z.shape), z.dtype, z.device)
        if key not in probes:          # Rademacher (+-1) draws
            bits = torch.randint(0, 2, (n_samples, *z.shape), generator=gen,
                                 device=z.device)
            probes[key] = (2 * bits - 1).to(z.dtype)
        return (f(s, z), -rademacher_trace(f, s, z, probes[key]))

    return aug


def reversed_field(aug: Callable) -> Callable:
    """Density direction: integrate x -> base by reversing depth."""
    def rev(s, state):
        dz, dlogp = aug(1.0 - s, state)
        return (pytree.tree_map(lambda t: -t, dz), -dlogp)
    return rev


def base_log_prob(z: torch.Tensor) -> torch.Tensor:
    return (-0.5 * torch.sum(z * z, -1)
            - 0.5 * z.shape[-1] * math.log(2 * math.pi))


# ------------------------------------------- integration entry points ----
# All CNF solves route through the unified Integrator engine; ``solver``
# accepts an Integrator / HyperSolver / Tableau / name (hypersolver
# corrections, and the fused hyper_step update, ride along inside the
# Integrator, paper Sec. 4.2).

def cnf_sample(params, z0: torch.Tensor, K: int = 1, solver="heun",
               return_traj: bool = False):
    """Map base draws ``z0 ~ N(0, I)`` to data space with K solver steps.

    Returns the terminal ``(x, dlogp)`` state (or the dense trajectory).
    With a trained 2nd-order hypersolver inside ``solver`` this is the
    paper's 2-NFE sampling result."""
    integ = as_integrator(solver)
    aug = exact_trace_dynamics(params)
    state0 = (z0, torch.zeros(z0.shape[:-1], dtype=z0.dtype,
                              device=z0.device))
    return integ.solve(aug, state0, FixedGrid.over(0.0, 1.0, K),
                       return_traj=return_traj)


def cnf_log_prob(params, x: torch.Tensor, K: int = 8, solver="rk4"):
    """log p(x) by integrating the reversed augmented field data -> base."""
    integ = as_integrator(solver)
    rev = reversed_field(exact_trace_dynamics(params))
    state0 = (x, torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device))
    zT, dlogp = integ.solve(rev, state0, FixedGrid.over(0.0, 1.0, K),
                            return_traj=False)
    return base_log_prob(zT) - dlogp
