"""Serving cost oracle — the ``SequentialEvalOracle`` of
``repro/launch/oracle.py``: one cost unit per SEQUENTIAL vector-field
evaluation (a K-step loop of an s-stage tableau costs ``s*K``, a probe its
``probe_nfe``, a ``seg``-step segment of a slot pool ``s*seg``, a K=0
flow-tier eval 1), batch width free. The roofline oracle waits for the
cost model slice (ROADMAP.md queue 1 item 9)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SequentialEvalOracle:
    unit: str = "sequential_evals"

    def probe_cost(self, shape, width: int, probe_nfe: int) -> float:
        return float(probe_nfe)

    def segment_cost(self, shape, seg: int, slots: int,
                     stages: int) -> float:
        return float(stages * seg)

    def solve_cost(self, shape, k_max: int, width: int,
                   stages: int) -> float:
        return float(stages * k_max)

    def flow_cost(self, shape, width: int) -> float:
        # one correction-net eval ~ one field eval on this clock: the
        # flow tier's whole solve
        return 1.0


def make_oracle(name: str, cfg=None, *, ctx: int = 4096):
    """CLI-facing factory (``launch/serve.py --cost-oracle``)."""
    if name == "sequential":
        return SequentialEvalOracle()
    if name == "roofline":
        raise NotImplementedError(
            "the roofline cost oracle is not ported yet: ROADMAP.md queue 1 "
            "item 9 (cost model and tuning on H100 terms)")
    raise ValueError(f"unknown cost oracle {name!r} "
                     "(expected 'sequential' or 'roofline')")
