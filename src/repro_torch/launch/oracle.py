"""Serving cost oracle — the ``SequentialEvalOracle`` of
``repro/launch/oracle.py``: one cost unit per SEQUENTIAL vector-field
evaluation (a K-step loop of an s-stage tableau costs ``s*K``, a probe its
``probe_nfe``, a ``seg``-step segment of a slot pool ``s*seg``), batch
width free. The roofline oracle waits for the cost model slice (ROADMAP.md
queue 1 item 9); the K=0 flow tier's ``flow_cost`` waits for item 4."""
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
