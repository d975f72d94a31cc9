"""Pluggable serving cost oracles — the port of ``repro/launch/oracle.py``:
what a probe, a pool segment, a drain solve and a K=0 flow eval cost on
the virtual clock.

Both serving loops (``launch/engine.py``'s drain ``MultiRateEngine`` and
``launch/scheduler.py``'s in-flight ``InflightScheduler``) stamp
completions and ledgers through ONE of these oracles:

  * ``SequentialEvalOracle`` — the default: one cost unit per SEQUENTIAL
    vector-field evaluation (a K-step loop of an s-stage tableau costs
    ``s*K``, a probe its ``probe_nfe``, a ``seg``-step segment of a slot
    pool ``s*seg``, a K=0 flow-tier eval 1). Batch width is free on this
    clock, so under it an infinitely wide slot pool is costless.
  * ``RooflineOracle`` — the same events priced in predicted device
    MICROseconds by the analytic roofline model
    (``roofline/costmodel.py::cell_cost``, on the H100 record by
    default): one vector-field evaluation (= one depth group's forward)
    of a ``width``-row pool is a decode cell at ``depth_fraction =
    1/n_groups``, taking the dominant of the compute, HBM and collective
    times with no overlap assumed. Width is priced (weight reads amortize
    sublinearly across rows), which is what the scheduler-knob autotuner
    (``launch/autotune.py``) optimizes.

The oracle's ``unit`` tag rides into every ``TraceReport`` and
``latency_stats`` row (``cost_unit``). Only time-like fields change
units (cost, latency, queue wait, throughput); step COUNTS (useful,
total and waste slot-steps, occupancy) are clock-independent.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Protocol, Tuple, runtime_checkable

from repro_torch.configs import ArchConfig, ShapeSpec
from repro_torch.models.lm import group_layout
from repro_torch.roofline.costmodel import (H100, Chip, Mesh2D, cell_cost,
                                          predicted)

#: Unit tag for REAL-clock measurements (``time.perf_counter``, in
#: microseconds). ``sequential_evals`` and ``device_us`` are predictions
#: an oracle priced; ``wall_us`` is what the host measured. Rows in two
#: units are ratio'd, never summed.
WALLCLOCK_UNIT = "wall_us"


@runtime_checkable
class CostOracle(Protocol):
    """What a serving loop asks its clock. ``shape`` is the per-request
    input shape (a pool/batch cell key); ``width`` the number of rows the
    priced program runs over; ``stages`` the tableau's stage count."""

    unit: str

    def probe_cost(self, shape: Tuple[int, ...], width: int,
                   probe_nfe: int) -> float:
        """One admission probe over ``width`` rows (``probe_nfe`` field
        evaluations)."""
        ...

    def segment_cost(self, shape: Tuple[int, ...], seg: int, slots: int,
                     stages: int) -> float:
        """One ``seg``-step advance of a ``slots``-row slot pool."""
        ...

    def solve_cost(self, shape: Tuple[int, ...], k_max: int, width: int,
                   stages: int) -> float:
        """One drain batch of ``width`` rows scanned to ``k_max``."""
        ...

    def flow_cost(self, shape: Tuple[int, ...], width: int) -> float:
        """One K=0 flow-tier evaluation (core/flowhead.py) over ``width``
        rows: a single net eval, no solver steps."""
        ...


@dataclasses.dataclass(frozen=True)
class SequentialEvalOracle:
    """The sequential-field-eval clock: cost counts sequential
    vector-field evaluations, batch width free. The default of both
    serving loops."""

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


class RooflineOracle:
    """Price serving events in predicted device-us via ``cell_cost``.

    ``cfg`` is the arch whose depth field is served (the serve CLI passes
    its ``--arch``); ``ctx`` the decode context length of the priced
    cell; ``mesh`` the roofline mesh (default: one device); ``n_groups``
    the number of depth groups one field evaluation covers (default:
    ``models/lm.py::group_layout``); ``chip`` the chip record (default:
    the H100). ``step_time`` memoizes per pool width."""

    unit = "device_us"

    def __init__(self, cfg: ArchConfig, *, ctx: int = 4096,
                 mesh: Optional[Mesh2D] = None,
                 n_groups: Optional[int] = None, chip: Chip = H100):
        if n_groups is None:
            _, n_groups, _ = group_layout(cfg)
        self.cfg = cfg
        self.ctx = int(ctx)
        self.mesh = mesh or Mesh2D(1, 1, 1)
        self.n_groups = max(int(n_groups), 1)
        self.chip = chip
        self._step_us: Dict[int, float] = {}

    def step_time(self, width: int) -> float:
        """Predicted device-us of ONE vector-field evaluation over
        ``width`` rows: the dominant roofline term of a decode cell at
        ``depth_fraction = 1/n_groups`` (no overlap assumed; on one
        device the collective term is left out, ``costmodel.predicted``). Increasing
        in width but sublinear — the per-group weight read is shared by
        every row."""
        width = max(int(width), 1)
        if width not in self._step_us:
            spec = ShapeSpec(name=f"oracle_decode{self.ctx}_b{width}",
                             kind="decode", seq_len=self.ctx,
                             global_batch=width)
            t = cell_cost(self.cfg, spec, self.mesh,
                          depth_fraction=1.0 / self.n_groups,
                          chip=self.chip)
            self._step_us[width] = 1e6 * predicted(t, self.mesh)[0]
        return self._step_us[width]

    def probe_cost(self, shape, width: int, probe_nfe: int) -> float:
        return probe_nfe * self.step_time(width)

    def segment_cost(self, shape, seg: int, slots: int,
                     stages: int) -> float:
        return stages * seg * self.step_time(slots)

    def solve_cost(self, shape, k_max: int, width: int,
                   stages: int) -> float:
        return stages * k_max * self.step_time(width)

    def flow_cost(self, shape, width: int) -> float:
        # the flow net is eval-shaped (rank-r MLP ~ one depth group's
        # cost envelope), so price it as one field evaluation
        return self.step_time(width)


def make_oracle(name: str, cfg: Optional[ArchConfig] = None, *,
                ctx: int = 4096) -> CostOracle:
    """CLI-facing factory (``launch/serve.py --cost-oracle``)."""
    if name == "sequential":
        return SequentialEvalOracle()
    if name == "roofline":
        if cfg is None:
            raise ValueError(
                "the roofline oracle prices a specific architecture: "
                "pass the served ArchConfig")
        return RooflineOracle(cfg, ctx=ctx)
    raise ValueError(f"unknown cost oracle {name!r} "
                     "(expected 'sequential' or 'roofline')")
