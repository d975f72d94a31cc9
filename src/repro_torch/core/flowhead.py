"""FlowHead — a learned solution operator as the serving ladder's K=0
tier; the port of ``repro/core/flowhead.py`` (see its docstring).

    F(fp, eps, s, z, dz) = z + eps * dz + eps^{p+1} * net(fp, eps, s, z, dz)

one full-span explicit-Euler step plus an eps^{p+1}-scaled learned
correction: the hypersolver update shape (paper Eq. 3) with the whole
span as one step. A zero-initialised readout makes F exactly one Euler
step; fitting F on the refinery ledger's rows reduces to fitting ``net``
to R, the target the hypersolver g trains on
(``core/residual.py::flow_fitting_loss``); ``net`` has g's signature,
so flow params swap like g's (``launch/engine.py::hot_swap_flow``).
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.integrate import _bcast

Pytree = Any
FlowNet = Callable[..., Any]

__all__ = ["make_flow_apply", "flow_combine"]


def flow_combine(eps, z: Pytree, dz: Pytree, corr: Pytree,
                 order: int = 1) -> Pytree:
    """``z + eps*dz + eps^{order+1}*corr`` leaf-wise. ``eps`` is the span
    (a Python float when serving) or a per-sample ``(N,)`` row (a batch
    of ledger rows in a fit); the scaled correction is rounded to the
    state's dtype first, as the reference rounds it."""
    scale = eps ** (order + 1)

    def leaf(zl, dzl, cl):
        sc = torch.as_tensor(scale, dtype=zl.dtype, device=zl.device)
        return zl + _bcast(eps, dzl) * dzl + _bcast(sc, cl) * cl.to(zl.dtype)

    return pytree.tree_map(leaf, z, dz, corr)


def make_flow_apply(net: FlowNet, order: int = 1) -> Callable:
    """Wrap a correction net into ``flow_apply(fp, eps, s, z, dz) ->
    z(s + eps)``; ``order`` is the base solver's order p."""

    def flow_apply(fp, eps, s, z, dz):
        return flow_combine(eps, z, dz, net(fp, eps, s, z, dz), order=order)

    return flow_apply
