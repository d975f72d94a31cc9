"""Butcher tableaus for explicit Runge-Kutta methods.

A tableau fully characterizes an explicit RK method (paper Eq. 3 / Fig. 5):

    r_i = f(s_k + c_i eps, z_k + eps * sum_j a_ij r_j)      j < i
    psi = sum_j b_j r_j

``order`` is the classical order p of the method; the hypersolver correction
term is scaled by eps^{p+1} (paper Eq. 5).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Tableau:
    name: str
    a: Tuple[Tuple[float, ...], ...]  # strictly lower-triangular stage matrix
    b: Tuple[float, ...]
    c: Tuple[float, ...]
    order: int
    # Embedded lower-order weights for adaptive methods (None for fixed-step).
    b_err: Tuple[float, ...] | None = None

    @property
    def stages(self) -> int:
        return len(self.b)

    def validate(self) -> None:
        """Consistency conditions: sum(b) == 1 and c_i == sum_j a_ij."""
        assert abs(sum(self.b) - 1.0) < 1e-12, self.name
        for i in range(self.stages):
            row = self.a[i]
            assert len(row) == i, (self.name, i)
            assert abs(self.c[i] - sum(row)) < 1e-12, (self.name, i)


EULER = Tableau(name="euler", a=((),), b=(1.0,), c=(0.0,), order=1)

MIDPOINT = Tableau(
    name="midpoint", a=((), (0.5,)), b=(0.0, 1.0), c=(0.0, 0.5), order=2
)

# b_err = plain Euler: the classical Heun-Euler 2(1) embedded pair — the
# cheapest embedded local-error estimate (2 NFEs), used by the serving
# probe (core/controllers.py::EmbeddedErrorController).
HEUN = Tableau(name="heun", a=((), (1.0,)), b=(0.5, 0.5), c=(0.0, 1.0),
               order=2, b_err=(1.0, 0.0))

RALSTON = Tableau(
    name="ralston",
    a=((), (2.0 / 3.0,)),
    b=(0.25, 0.75),
    c=(0.0, 2.0 / 3.0),
    order=2,
)

RK4 = Tableau(
    name="rk4",
    a=((), (0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)),
    b=(1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0),
    c=(0.0, 0.5, 0.5, 1.0),
    order=4,
)

RK38 = Tableau(
    name="rk38",
    a=((), (1.0 / 3.0,), (-1.0 / 3.0, 1.0), (1.0, -1.0, 1.0)),
    b=(1.0 / 8.0, 3.0 / 8.0, 3.0 / 8.0, 1.0 / 8.0),
    c=(0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0),
    order=4,
)

RK3_KUTTA = Tableau(
    name="rk3",
    a=((), (0.5,), (-1.0, 2.0)),
    b=(1.0 / 6.0, 2.0 / 3.0, 1.0 / 6.0),
    c=(0.0, 0.5, 1.0),
    order=3,
)

# Dormand-Prince 5(4): the paper's ground-truth/reference solver (dopri5).
DOPRI5 = Tableau(
    name="dopri5",
    a=(
        (),
        (1.0 / 5.0,),
        (3.0 / 40.0, 9.0 / 40.0),
        (44.0 / 45.0, -56.0 / 15.0, 32.0 / 9.0),
        (19372.0 / 6561.0, -25360.0 / 2187.0, 64448.0 / 6561.0, -212.0 / 729.0),
        (9017.0 / 3168.0, -355.0 / 33.0, 46732.0 / 5247.0, 49.0 / 176.0,
         -5103.0 / 18656.0),
        (35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0, -2187.0 / 6784.0,
         11.0 / 84.0),
    ),
    b=(35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0, -2187.0 / 6784.0,
       11.0 / 84.0, 0.0),
    b_err=(5179.0 / 57600.0, 0.0, 7571.0 / 16695.0, 393.0 / 640.0,
           -92097.0 / 339200.0, 187.0 / 2100.0, 1.0 / 40.0),
    c=(0.0, 1.0 / 5.0, 3.0 / 10.0, 4.0 / 5.0, 8.0 / 9.0, 1.0, 1.0),
    order=5,
)


def alpha_family(alpha: float) -> Tableau:
    """General 2nd-order explicit family (paper Fig. 5 right).

    c = (0, alpha); a21 = alpha; b = (1 - 1/(2 alpha), 1/(2 alpha)).
    alpha = 0.5 recovers midpoint, alpha = 1.0 recovers Heun,
    alpha = 2/3 recovers Ralston.
    """
    if alpha <= 0:
        raise ValueError("alpha must be positive")
    inv = 1.0 / (2.0 * alpha)
    return Tableau(
        name=f"alpha_{alpha:g}",
        a=((), (float(alpha),)),
        b=(1.0 - inv, inv),
        c=(0.0, float(alpha)),
        order=2,
    )


REGISTRY = {
    t.name: t
    for t in (EULER, MIDPOINT, HEUN, RALSTON, RK3_KUTTA, RK4, RK38, DOPRI5)
}


def get(name: str) -> Tableau:
    if name.startswith("alpha_"):
        return alpha_family(float(name.split("_", 1)[1]))
    if name not in REGISTRY:
        raise KeyError(f"unknown tableau {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def _selfcheck() -> None:
    for t in REGISTRY.values():
        t.validate()
    for al in np.linspace(0.1, 1.0, 7):
        alpha_family(float(al)).validate()


_selfcheck()
