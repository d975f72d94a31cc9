"""Fixed-grid mesh definition (``FixedGrid``) — the port of
``repro/core/solvers.py``'s mesh; the integration engine is
``repro_torch.core.integrate``."""
from __future__ import annotations

from typing import Any, NamedTuple


class FixedGrid(NamedTuple):
    """Uniform depth mesh s_k = s0 + k * eps, k = 0..K (paper Sec. 2).

    ``eps`` may be a scalar or a tensor with a leading batch axis
    (per-sample step sizes for multi-rate serving — the Integrator
    broadcasts it leaf-wise against the state).
    """

    s0: float
    eps: Any
    K: int

    @classmethod
    def over(cls, s0: float, s1: float, K: int) -> "FixedGrid":
        return cls(s0=s0, eps=(s1 - s0) / K, K=K)
