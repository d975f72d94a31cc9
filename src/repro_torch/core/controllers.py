"""Step controllers — the port of ``repro/core/controllers.py``.

From a cheap local-error probe a controller picks a per-sample mesh
length K (easy requests integrate in 2-4 NFEs, hard ones in 8-16). All
controllers share one selection rule: with a one-full-span probe error
``e ~ C * h^{q+1}`` and global error over K steps ``e / K^q``, the
smallest mesh meeting ``tol`` is

    K = ceil((e / tol)^{1/q})         (clipped to [k_min, k_max]).

``FixedController`` (no probe), ``EmbeddedErrorController`` (one
embedded-pair probe step) and ``HypersolverResidualController`` (the
correction magnitude ||g|| * h^{p+1}, one field evaluation) pick K;
``TierRouter`` layers the K=0 flow tier on top of a probing controller.
``embedded_step`` / ``error_ratio`` / ``step_factor`` are the embedded
estimator ``odeint_dopri5`` (core/adaptive.py) shares.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.tableaus import HEUN, Tableau, get as get_tableau

Pytree = Any


class Probe(NamedTuple):
    """Per-sample mesh lengths plus the evidence. ``dz0 = f(s0, z0)`` is
    the probe's first stage, reused as stage 0 of the solve; None when
    the controller did not probe."""

    K: torch.Tensor         # (B,) int32 selected mesh lengths
    err: torch.Tensor       # (B,) float32 local-error estimate (0 = no probe)
    nfe: int                # vector-field evals the probe spent, per sample
    dz0: Optional[Pytree]   # f(s0, z0), reusable as the solve's first stage


# Classical step-size controller constants (shared with core/adaptive.py).
SAFETY = 0.9
MIN_FACTOR = 0.2
MAX_FACTOR = 5.0


def embedded_step(f, tab: Tableau, s, eps, z: Pytree):
    """One step of an embedded RK pair: ``(z_hi, err, stages)`` with
    ``err = eps * sum_j (b_j - b_err_j) r_j`` leaf-wise."""
    from repro_torch.core.integrate import (_scale, rk_stages, tree_axpy,
                                            tree_lincomb)

    if tab.b_err is None:
        raise ValueError(f"tableau {tab.name!r} has no embedded b_err weights")
    stages = rk_stages(f, tab, s, eps, z)
    z_hi = tree_axpy(eps, tree_lincomb(tab.b, stages), z)
    err_w = tuple(b - be for b, be in zip(tab.b, tab.b_err))
    err = pytree.tree_map(lambda l: _scale(eps, l),
                          tree_lincomb(err_w, stages))
    return z_hi, err, stages


def error_ratio(z: Pytree, z_new: Pytree, err: Pytree, atol, rtol
                ) -> torch.Tensor:
    """RMS of err / (atol + rtol * max(|z|, |z_new|)); accept iff <= 1.
    A 0-d float32 tensor on the state's device."""

    def leafwise(zl, znl, el):
        tol = atol + rtol * torch.maximum(zl.abs(), znl.abs())
        return torch.mean((el.float() / tol.float()) ** 2)

    parts = [leafwise(*ls) for ls in zip(pytree.tree_leaves(z),
                                         pytree.tree_leaves(z_new),
                                         pytree.tree_leaves(err))]
    return torch.sqrt(sum(parts) / len(parts))


def step_factor(ratio, order: int) -> torch.Tensor:
    """Classical safety-clamped step-size multiplier ratio^{-1/order}."""
    ratio = torch.as_tensor(ratio, dtype=torch.float32)
    return torch.clamp(
        SAFETY * torch.clamp(ratio, min=1e-10) ** (-1.0 / order),
        MIN_FACTOR, MAX_FACTOR)


def per_sample_norm(tree: Pytree) -> torch.Tensor:
    """RMS over everything but the leading (batch) axis, averaged across
    leaves — the per-request scalar the serving policy keys on."""
    parts = [torch.mean(l.float().reshape(l.shape[0], -1) ** 2, dim=-1)
             for l in pytree.tree_leaves(tree)]
    return torch.sqrt(sum(parts) / len(parts))


def mesh_for_tolerance(err, tol: float, q: int, k_min: int, k_max: int):
    """K = ceil((err/tol)^{1/q}) clipped — the shared selection rule. A
    non-finite probe error gets k_max, never the smallest bucket."""
    e = torch.as_tensor(err, dtype=torch.float32)
    e = torch.maximum(e, torch.tensor(1e-30, dtype=torch.float32,
                                      device=e.device))
    k = torch.ceil((e / tol) ** (1.0 / q))
    k = torch.where(torch.isfinite(k), k, torch.full_like(k, float(k_max)))
    return torch.clamp(k, k_min, k_max).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class FixedController:
    """Constant mesh length for every sample (no probe, probe_nfe = 0)."""

    K: int

    k_min: int = dataclasses.field(init=False, default=1)

    @property
    def k_max(self) -> int:
        return self.K

    def select(self, integ, f, z0: Pytree, span: Tuple[float, float]) -> Probe:
        ref = pytree.tree_leaves(z0)[0]
        B = ref.shape[0]
        Ks = torch.full((B,), self.K, dtype=torch.int32, device=ref.device)
        return Probe(Ks, torch.zeros((B,), dtype=torch.float32,
                                     device=ref.device), 0, None)


@dataclasses.dataclass(frozen=True)
class EmbeddedErrorController:
    """Per-sample K from one embedded-pair probe step over the full span
    (default HEUN: 2 NFEs). q is the serving integrator's order."""

    tol: float = 1e-2
    k_min: int = 1
    k_max: int = 16
    probe: Tableau = HEUN

    def __post_init__(self):
        if isinstance(self.probe, str):
            object.__setattr__(self, "probe", get_tableau(self.probe))
        if self.probe.b_err is None:
            raise ValueError(
                f"probe tableau {self.probe.name!r} has no b_err weights")

    @property
    def probe_nfe(self) -> int:
        return self.probe.stages

    def select(self, integ, f, z0: Pytree, span: Tuple[float, float]) -> Probe:
        s0, s1 = span
        h = s1 - s0
        _, err, stages = embedded_step(f, self.probe, s0, h, z0)
        e = per_sample_norm(err)
        q = max(integ.order, 1)
        Ks = mesh_for_tolerance(e, self.tol, q, self.k_min, self.k_max)
        return Probe(Ks, e, self.probe.stages, stages[0])


@dataclasses.dataclass(frozen=True)
class HypersolverResidualController:
    """Per-sample K from the learned correction magnitude: the local defect
    of one full-span base step is ~ ||g(h, s0, z0, dz)|| * h^{p+1}, at the
    cost of the dz = f(s0, z0) evaluation the solve needs anyway."""

    tol: float = 1e-2
    k_min: int = 1
    k_max: int = 16

    probe_nfe: int = dataclasses.field(init=False, default=1)

    def select(self, integ, f, z0: Pytree, span: Tuple[float, float]) -> Probe:
        if integ.g is None:
            raise ValueError(
                "HypersolverResidualController needs an Integrator with a "
                "correction g; use EmbeddedErrorController for base solvers")
        s0, s1 = span
        h = s1 - s0
        dz = f(s0, z0)
        corr = integ.g(h, s0, z0, dz)
        p = integ.order
        e = per_sample_norm(corr) * (h ** (p + 1))
        Ks = mesh_for_tolerance(e, self.tol, p, self.k_min, self.k_max)
        return Probe(Ks, e, 1, dz)


# ------------------------------------------------------------ tier router ----

@dataclasses.dataclass(frozen=True)
class TierRouter:
    """The three-way serving ladder over a probing controller: ``flow``
    (probe error at most ``flow_threshold * tol``: the K=0 learned
    solution operator, core/flowhead.py, one net eval), ``hyper`` (K <=
    ``hyper_k_max`` after the bucket snap) and ``high-K`` (the rest).
    ``flow_threshold`` is a confidence margin inside ``tol``, not a second
    tolerance; requests on the escalation path (``K_floor > 0``) never
    route to flow again. Routing runs on the host over the probe's error
    row, which the serving loops read back anyway."""

    flow_threshold: float = 0.25   # route to flow iff err <= this * tol
    hyper_k_max: int = 4           # hyper/high-K boundary (reporting tier)

    def __post_init__(self):
        if not (0.0 <= self.flow_threshold <= 1.0):
            raise ValueError(
                f"flow_threshold={self.flow_threshold}: expected a "
                "confidence fraction in [0, 1] — the flow tier serves "
                "requests whose probe error is confidently BELOW "
                "tolerance, so a threshold above 1 would route requests "
                "the probe already flagged as failing")

    def flow_mask(self, err, tol: float, k_floor) -> np.ndarray:
        """(B,) bool: rows to serve on the K=0 flow tier. Non-finite
        probe errors and escalated requests (``k_floor > 0``) are
        excluded. The comparison is in float32, the threshold rounded to
        float32 as the reference rounds a Python scalar."""
        err = np.asarray(err, np.float32)
        k_floor = np.asarray(k_floor, np.int32)
        return (np.isfinite(err)
                & (err <= np.float32(self.flow_threshold * tol))
                & (k_floor == 0))

    def tier_of(self, K) -> np.ndarray:
        """Reporting tier of a snapped bucket row: 1 = hyper (``K <=
        hyper_k_max``), 2 = high-K (flow rows are tier 0, by
        ``flow_mask``)."""
        K = np.asarray(K, np.int32)
        return np.where(K <= self.hyper_k_max, 1, 2).astype(np.int32)
