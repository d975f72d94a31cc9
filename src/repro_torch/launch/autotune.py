"""Scheduler-knob autotuning against the roofline cost oracle — the port
of ``repro/launch/autotune.py``.

The sequential-eval clock prices pool WIDTH at zero, so under it the
optimal scheduler wants an infinitely wide slot pool and there is
nothing to tune. The roofline oracle (``launch/oracle.py::
RooflineOracle``, on the H100 record by default) prices a ``(shape, seg,
slots)`` segment in predicted device-us where weight reads amortize
SUBLINEARLY across rows, which turns ``seg`` / ``slots`` / the bucket
set into a real tradeoff:

  * wider pool: more capacity per segment, but every segment is fatter —
    worth it exactly while queueing dominates the tail;
  * smaller ``seg``: faster admission and retirement (smaller latency
    quantum), same per-useful-step price;
  * finer bucket grid: less snap-up overshoot (``snap_to_buckets`` only
    rounds K UP, so the controller's quality floor is preserved), less
    masked waste, shorter busy periods.

Each candidate is scored by REPLAYING one seeded Poisson trace through
the port's ``InflightScheduler`` under the oracle clock (the toy
servable ``launch/workload.py::toy_classifier``; the ORACLE carries the
priced architecture), reading p99 latency off ``latency_stats``, and
hillclimbed with ``roofline/hillclimb.py::hypothesis_loop``. A request's
K comes from the probe of the toy's field, never from its readout head,
so the verdict does not depend on the head: the CLI draws it from
``numpy.random.RandomState(7)`` (the reference draws it from JAX's
``PRNGKey(7)``) and records that in each verdict. Verdicts persist to
``artifacts/torch/tuned/<cell>.json``.

    PYTHONPATH=src python -m repro_torch.launch.autotune [--budget small]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs import get
from repro_torch.launch.engine import EngineConfig
from repro_torch.launch.oracle import RooflineOracle
from repro_torch.launch.scheduler import InflightScheduler
from repro_torch.launch.workload import (
    heterogeneous_requests, latency_stats, poisson_trace, replay_scheduler,
    toy_classifier,
)
from repro_torch.roofline.costmodel import H100, Chip
from repro_torch.roofline.hillclimb import hypothesis_loop

TUNED_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "artifacts", "torch",
    "tuned"))

# the serving cells the tuner tracks: one priced architecture per decode
# context — short-context and long-context decode sit at different points
# on the HBM roof, so their tuned knobs may legitimately differ
TUNE_CELLS = (
    {"cell": "qwen3_8b_decode4k", "arch": "qwen3_8b", "ctx": 4096},
    {"cell": "qwen3_8b_decode32k", "arch": "qwen3_8b", "ctx": 32768},
)

DEFAULT_BASE = {"seg": 2, "slots": 8, "buckets": (2, 4, 8, 16)}

DEFAULT_STEPS = [
    ("slots 8->16",
     "the old clock priced rows at zero; the roofline cell amortizes the "
     "per-group weight read across rows, so doubling the pool costs <2x "
     "per segment — under queueing load the extra capacity should cut "
     "p99 by more than the fatter segment adds",
     {"slots": 16}),
    ("slots 16->32",
     "same argument again — expected to refute once the pool stops being "
     "the bottleneck: every segment still gets fatter, but nothing "
     "queues long enough to buy it back",
     {"slots": 32}),
    ("seg 2->1",
     "halve the admission/retirement quantum: a finished slot refills "
     "after stages*1 steps instead of stages*2, and a newcomer waits at "
     "most one short segment — per-useful-step price unchanged, tail "
     "wait down",
     {"seg": 1}),
    ("buckets +(3,6,12)",
     "finer snap grid: K snap-up overshoot shrinks (snap_to_buckets "
     "only rounds UP, so the controller's quality floor is preserved), "
     "masked-step waste drops, busy periods shorten",
     {"buckets": (2, 3, 4, 6, 8, 12, 16)}),
]

_BUDGET_N = {"tiny": 16, "small": 48, "full": 128}

#: where the CLI's toy head comes from (recorded in each verdict)
HEAD_SOURCE = "numpy RandomState(7) standard_normal (32, 10) / sqrt(32)"


def toy_head(d: int = 32, n_classes: int = 10) -> np.ndarray:
    """The toy classifier's readout head for the tuner's replays, drawn
    from ``numpy.random.RandomState(7)`` (float32, scaled by 1/sqrt(d))."""
    W = np.random.RandomState(7).standard_normal((d, n_classes))
    return (W / np.sqrt(d)).astype(np.float32)


def make_objective(oracle: RooflineOracle, trace, W: np.ndarray, *,
                   solver: str = "euler", max_batch: int = 8,
                   tol: float = 5e-3):
    """Score one knob dict by a full trace replay on the oracle clock:
    (p99 latency in oracle units, summary info for the hillclimb log).
    ``W`` is the toy classifier's readout head."""

    def evaluate(kw):
        ecfg = EngineConfig(buckets=tuple(kw["buckets"]), tol=tol,
                            max_batch=max_batch, solver=solver,
                            fused=False)
        sched = InflightScheduler(toy_classifier(W, solver, fused=False),
                                  ecfg, slots=int(kw["slots"]),
                                  seg=int(kw["seg"]), oracle=oracle)
        stats = latency_stats(replay_scheduler(sched, trace))
        info = {"p99_latency": stats["p99_latency"],
                "p99_queue_wait": stats["p99_queue_wait"],
                "waste_frac": stats["waste_frac"],
                "occupancy": stats["occupancy"]}
        return stats["p99_latency"], info

    return evaluate


def autotune_cell(spec: Dict, *, budget: str = "small", seed: int = 3,
                  load: float = 1.0, base: Optional[Dict] = None,
                  steps=None, W: Optional[np.ndarray] = None,
                  chip: Chip = H100) -> Dict:
    """Hillclimb (seg, slots, buckets) for one serving cell. ``load`` is
    the arrival rate in requests per base-pool field-eval time — 1.0
    runs the base pool past capacity so queueing dominates the tail.
    ``W`` is the toy's readout head (default ``toy_head()``); ``chip``
    the oracle's chip record."""
    n = _BUDGET_N.get(budget, _BUDGET_N["small"])
    base = dict(base or DEFAULT_BASE)
    head = HEAD_SOURCE if W is None else "caller"
    W = toy_head() if W is None else W
    oracle = RooflineOracle(get(spec["arch"]), ctx=spec["ctx"], chip=chip)
    # arrival rate converts from per-field-eval to per-oracle-unit so the
    # workload stresses every cell equally regardless of its step price
    rate = load / oracle.step_time(base["slots"])
    xs = heterogeneous_requests(n, 32, seed=seed)
    trace = poisson_trace(xs, rate=rate, seed=seed + 100)
    evaluate = make_objective(oracle, trace, W)
    best_kw, best_score, log = hypothesis_loop(
        evaluate, steps or DEFAULT_STEPS, base)
    return {
        "bench": "scheduler", "mode": "tuner", "cell": spec["cell"],
        "arch": spec["arch"], "ctx": spec["ctx"],
        "cost_unit": oracle.unit, "objective": "p99_latency",
        "trace": f"poisson_seed{seed}", "requests": n, "load": load,
        "base": {"seg": base["seg"], "slots": base["slots"],
                 "buckets": list(base["buckets"])},
        "chosen": {"seg": int(best_kw["seg"]),
                   "slots": int(best_kw["slots"]),
                   "buckets": list(best_kw["buckets"])},
        "p99_base": log[0]["score"], "p99_tuned": best_score,
        "confirmed": [r["change"] for r in log[1:]
                      if r["verdict"] == "CONFIRMED"],
        "log": log,
        "chip": chip.name, "head": head,
    }


def tuned_path(cell: str, out_dir: str = TUNED_DIR) -> str:
    return os.path.join(out_dir, f"{cell}.json")


def save_tuned(result: Dict, out_dir: str = TUNED_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = tuned_path(result["cell"], out_dir)
    with open(path, "w") as fh:
        json.dump(result, fh, indent=1, default=str)
        fh.write("\n")
    return path


def load_tuned(cell: str, out_dir: str = TUNED_DIR) -> Optional[Dict]:
    path = tuned_path(cell, out_dir)
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return json.load(fh)


def autotune_cells(budget: str = "small",
                   out_dir: str = TUNED_DIR) -> List[Dict]:
    """Every tracked cell, tuned on the H100 record and persisted."""
    results = []
    for spec in TUNE_CELLS:
        res = autotune_cell(spec, budget=budget)
        save_tuned(res, out_dir)
        results.append(res)
    return results


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(
        description="autotune scheduler knobs against the roofline oracle "
                    "(H100 record)")
    ap.add_argument("--budget", default="small",
                    choices=sorted(_BUDGET_N))
    ap.add_argument("--out", default=TUNED_DIR)
    args = ap.parse_args(argv)
    for res in autotune_cells(args.budget, args.out):
        print(f"== {res['cell']} (ctx={res['ctx']}, {res['cost_unit']} "
              f"on {res['chip']}) ==")
        for row in res["log"]:
            if row["change"] == "baseline":
                print(f"  baseline: p99={row['p99_latency']} "
                      f"occ={row['occupancy']}")
            else:
                print(f"  [{row['iter']}] {row['change']}: "
                      f"{row['score_before']} -> {row['score_after']} "
                      f"({row['gain']}) {row['verdict']}")
        print(f"  chosen: {res['chosen']}  "
              f"p99 {res['p99_base']} -> {res['p99_tuned']}")
        print(f"  wrote {tuned_path(res['cell'], args.out)}")


if __name__ == "__main__":
    main()
