"""Assemble the port's EXPERIMENTS.md from its own artifacts — the port of
``repro/roofline/experiments_md.py``: the roofline table
(``roofline/report.py``), the hillclimb log (``roofline/hillclimb.py``)
and benchmark rows, all read from ``artifacts/torch/`` and priced on the
H100 record, and the dry run's per-device summary
(``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.roofline.experiments_md

Run ``python -m repro_torch.launch.dryrun``, ``python -m
repro_torch.roofline.report`` and ``python -m
repro_torch.roofline.hillclimb`` first; a missing artifact renders as a
note. Nothing here reads the reference's artifacts.
"""
from __future__ import annotations

import json
import os

from repro_torch.roofline.costmodel import H100, Chip

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "..",
                                    ".."))
ART = os.path.join(ROOT, "artifacts", "torch")


def _load(p, default=None):
    try:
        with open(p) as f:
            return json.load(f)
    except FileNotFoundError:
        return default


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f} s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f} ms"
    return f"{x * 1e6:.1f} µs"


def load_dryrun(folder: str):
    """Every cell artifact (``<arch>__<shape>__{sp,mp}.json``) of the
    port's dry run in ``folder``, in name order."""
    if not os.path.isdir(folder):
        return []
    out = []
    for name in sorted(os.listdir(folder)):
        if name.endswith(".json") and name.count("__") == 2:
            out.append(_load(os.path.join(folder, name)))
    return out


def dryrun_section(summary) -> str:
    """The port's dry run (``launch/dryrun.py``): which cells ran, and
    each OK cell's per-device memory and collectives."""
    ok = [r for r in summary if r["status"] == "OK"]
    skip = [r for r in summary if r["status"] == "SKIP"]
    fail = [r for r in summary if r["status"] == "FAIL"]
    out = ["## §Dry-run\n"]
    out.append(
        f"**{len(summary)} cells** in `artifacts/torch/dryrun/` "
        f"(`python -m repro_torch.launch.dryrun`): {len(ok)} OK, "
        f"{len(skip)} documented SKIPs, {len(fail)} failures. Each OK cell "
        f"is one step of `launch/steps.py` traced on a fake process group "
        f"of 256 (or 512) ranks, its params, moments and inputs DTensors "
        f"of fake local blocks placed by `distributed/sharding.py`; "
        f"nothing is computed, and the numbers are rank 0's (FLOPs of the "
        f"matrix products, bytes, peak live bytes, each collective's "
        f"output bytes and `CommDebugMode`'s counts). `trace_s` is the "
        f"seconds the trace took, not a compile time. A cell absent from "
        f"the table was not run (ROADMAP.md).\n")
    if skip:
        out.append("Skips (long_500k on O(S²) full-attention archs): " +
                   ", ".join(sorted({r["arch"] for r in skip})) + ".\n")
    if not ok:
        return "".join(out)
    out.append("\n### Per-device memory & collectives\n")
    out.append("| arch | shape | mesh | args GiB/dev | temp GiB/dev | "
               "TFLOP/dev | trace s | collective ops |\n"
               "|---|---|---|---|---|---|---|---|\n")
    for r in ok:
        counts = {k: v for k, v in r["collective_counts"].items() if v}
        mem = r["memory"]
        out.append(
            f"| {r['arch']} | {r['shape']} | "
            f"{'2x16x16' if r['multi_pod'] else '16x16'} | "
            f"{mem['argument_bytes'] / 2**30:.2f} | "
            f"{mem['temp_bytes'] / 2**30:.2f} | {r['flops'] / 1e12:.1f} | "
            f"{r['trace_s']} | {counts} |\n")
    out.append(
        "\nNotes: (i) the kernels' plain versions run on the fake blocks, "
        "so FLOPs are the model's and the temp bytes include the plain "
        "attention's (B, H, 512, S) score chunks, which the flash kernel "
        "on the card never holds. (ii) MoE dispatch gathers the batch's "
        "tokens over the batch axes on every device (correct before "
        "fast; an all-to-all dispatch is ROADMAP work), which the temp "
        "bytes of the MoE cells show.\n")
    return "".join(out)


# what would move each (family, kind) cell's dominant term, in the
# port's terms
MOVES = {
    ("moe", "train"): "int8 a2a payloads + EP placement (see §Perf)",
    ("dense", "train"): "SP + collective/compute overlap",
    ("ssm", "train"): "one fused AdamW pass (ROADMAP item 25), then "
                      "per-group gradient leaves (item 18)",
    ("hybrid", "train"): "one fused AdamW pass (ROADMAP item 25), then "
                         "per-group gradient leaves (item 18)",
    ("vlm", "train"): "SP + fused patch-proj",
    ("audio", "train"): "encoder flash attention (S²=2.25M a head)",
    ("any", "prefill"): "the flash kernel keeps scores on chip",
    ("any", "decode"): "int8 weights+KV, batching, hypersolved depth "
                       "(§Perf C)",
}


def roofline_section(rows, chip: Chip = H100) -> str:
    """One table per mesh of ``rows`` (``report.py``'s rows, each with its
    ``mesh``), in order of first appearance."""
    from repro_torch.configs import get
    out = ["\n## §Roofline\n"]
    out.append(
        f"Terms per (arch × shape) on the chip record {chip.describe()}. "
        "compute = FLOPs/(devices·peak); "
        "memory = HBM bytes/(device·bw); collective = coll bytes/"
        "(device·link), one link rate for every mesh: a mesh beyond one "
        "8-GPU node is a what-if at that rate. `useful` = MODEL_FLOPS "
        "(6·N_active·D train, 2·N_active·D inference) / analytic "
        "FLOPs. `roofline frac` = t_compute / max(term) — the fraction "
        "of the compute roof reached if the dominant non-compute term "
        "were fully overlapped. Predictions of the model, not "
        "measurements.\n")
    # report.py writes one block of rows per mesh; a SKIP row (no mesh)
    # belongs to the block it sits in
    blocks = []
    for r in rows:
        mesh = r.get("mesh", "16x16") if r["status"] == "OK" else None
        if not blocks or (mesh is not None and mesh != blocks[-1][0]):
            blocks.append([mesh or "16x16", []])
        blocks[-1][1].append(r)
    for mesh, block in blocks:
        out.append(f"\n### mesh {mesh}\n\n")
        out.append("| arch | shape | t_comp | t_mem | t_coll | dominant | "
                   "roofline frac | useful | what would move the dominant "
                   "term |\n|---|---|---|---|---|---|---|---|---|\n")
        for r in block:
            if r["status"] == "SKIP":
                out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                           f"SKIP | — | — | {r['reason']} |\n")
                continue
            fam = get(r["arch"]).family
            kind = ("train" if r["shape"].startswith("train") else
                    "prefill" if r["shape"].startswith("prefill")
                    else "decode")
            move = MOVES.get((fam, kind), MOVES.get(("any", kind), ""))
            out.append(
                f"| {r['arch']} | {r['shape']} | "
                f"{_fmt_s(r['t_compute_s'])} | "
                f"{_fmt_s(r['t_memory_s'])} | "
                f"{_fmt_s(r['t_collective_s'])} | "
                f"{r['dominant']} | {r['roofline_fraction']} | "
                f"{r['useful_ratio']} | {move} |\n")
    return "".join(out)


def perf_section(log) -> str:
    out = ["\n## §Perf — hillclimb log "
           "(hypothesis → change → predicted before/after → verdict)\n"]
    out.append(
        "Three cells: **A** olmoe_1b_7b × train_4k, **B** "
        "llama4-maverick × train_4k, **C** qwen3-8b × decode_32k (the "
        "paper-technique cell: hypersolved depth attacks the dominant "
        "memory term directly), on the 16 × 16 mesh as a what-if at one "
        "link rate. Every change is priced by the model, not run: the "
        "port implements hypersolved depth (`models/cdepth.py`), int8 "
        "dispatch and the int8 KV cache (`set_perf_options`), and "
        "EP-over-data and SP over a device mesh (`launch/steps.py`, "
        "measured per device in §Dry-run); int8 weights are not "
        "ported.\n\n")
    if not log:
        out.append("(no hillclimb log: run `python -m "
                   "repro_torch.roofline.hillclimb`)\n")
    for r in log:
        if r["change"] == "baseline":
            out.append(f"\n### {r['cell']}\n\n")
            out.append(f"Baseline: compute {_fmt_s(r['t_compute_s'])}, "
                       f"memory {_fmt_s(r['t_memory_s'])}, collective "
                       f"{_fmt_s(r['t_collective_s'])} → dominant = "
                       f"**{r['dominant']}**, roofline fraction "
                       f"{r['roofline_fraction']}.\n\n")
            out.append("| # | change | hypothesis (napkin math) | dominant "
                       "before → after | gain | verdict |\n"
                       "|---|---|---|---|---|---|\n")
            continue
        out.append(
            f"| {r['iter']} | {r['change']} | {r['hypothesis']} | "
            f"{r['dominant_term_before_s']} → {r['dominant_term_after_s']} "
            f"| {r['gain_on_dominant']} | {r['verdict']} |\n")
    return "".join(out)


def bench_section(rows) -> str:
    if not rows:
        return ("\n## Paper-claim validation\n\n(no benchmark cell of the "
                "port yet: ROADMAP item 13)\n")
    out = ["\n## Paper-claim validation\n"]
    by = {}
    for r in rows:
        by.setdefault(r["bench"], []).append(r)

    if "complexity_table" in by:
        out.append("\n### Fig. 2 — asymptotic complexity (empirical "
                   "order fits)\n\n| solver | NFE/step | local order "
                   "(theory) | local order (fit) |\n|---|---|---|---|\n")
        for r in by["complexity_table"]:
            out.append(f"| {r['solver']} | {r['nfe_per_step']} | "
                       f"{r['theory_local_order']} | "
                       f"{r['empirical_local_order']} |\n")

    if "pareto_mnist" in by:
        out.append("\n### Fig. 3/9 — image-classification pareto\n\n"
                   "| solver | K | NFE | GMAC | MAPE % | acc drop % |\n"
                   "|---|---|---|---|---|---|\n")
        for r in by["pareto_mnist"]:
            out.append(f"| {r['solver']} | {r['K']} | {r['nfe']} | "
                       f"{r['gmac']} | {r['mape']} | "
                       f"{r['acc_loss_pct']} |\n")
        lo = [r for r in by["pareto_mnist"] if r["K"] in (2, 4, 8)]
        he = [r for r in lo if r["solver"] == "hyper_euler"]
        others = [r for r in lo if r["solver"] != "hyper_euler"]
        wins = all(
            h["mape"] <= min(o["mape"] for o in others
                             if o["K"] == h["K"]) for h in he)
        out.append(f"\nHyperEuler pareto-dominates at low NFE (K ≤ 8): "
                   f"**{'CONFIRMED' if wins else 'partial'}** "
                   f"(paper Fig. 3).\n")

    if "wallclock_mnist" in by:
        out.append("\n### Fig. 4 — wall-clock at iso-accuracy (ratios are "
                   "the claim; each row names its device)\n\n"
                   "| solver | K | NFE | ms/batch | speedup vs dopri5 |\n"
                   "|---|---|---|---|---|\n")
        for r in by["wallclock_mnist"]:
            out.append(f"| {r['solver']} | {r['K']} | {r['nfe']} | "
                       f"{r['ms']} | {r['speedup_vs_dopri5']}× |\n")

    if "alpha_family" in by:
        out.append("\n### Fig. 5-6 — base-solver generalization "
                   "(HyperMidpoint swapped across the α-family, no "
                   "finetuning)\n\n| α | MAPE plain | MAPE hyper | hyper "
                   "wins |\n|---|---|---|---|\n")
        for r in by["alpha_family"]:
            out.append(f"| {r['alpha']} | {r['mape_plain']} | "
                       f"{r['mape_hyper']} | {r['hyper_wins']} |\n")

    if "cnf" in by:
        out.append("\n### Fig. 1/7 — CNF sampling at 2 NFE\n\n"
                   "| density | method | NFE | sample displacement vs "
                   "dopri5 | hist-L1 vs data | dopri5 hist-L1 | dopri5 "
                   "NFE |\n|---|---|---|---|---|---|---|\n")
        for r in by["cnf"]:
            out.append(f"| {r['density']} | {r['method']} | {r['nfe']} | "
                       f"{r['disp_vs_dopri5']} | {r['hist_l1_vs_data']} | "
                       f"{r['hist_l1_dopri5_vs_data']} | "
                       f"{r['dopri5_nfe']} |\n")

    if "trajectory_tracking" in by:
        out.append("\n### Fig. 8 — trajectory fitting (tracking task)\n\n"
                   "| solver | K | NFE | global err |\n|---|---|---|---|\n")
        for r in by["trajectory_tracking"]:
            out.append(f"| {r['solver']} | {r['K']} | {r['nfe']} | "
                       f"{r['global_err']} |\n")

    if "overhead" in by:
        out.append("\n### Sec. 6 — relative overhead O_r → 1 with solver "
                   "order\n\n| base | order | MAC_g/MAC_f | O_r |\n"
                   "|---|---|---|---|\n")
        for r in by["overhead"]:
            out.append(f"| {r['base']} | {r['order']} | "
                       f"{r['mac_g_over_mac_f']} | "
                       f"{r['relative_overhead_O_r']} |\n")

    if "cdepth_lm" in by:
        out.append("\n### Beyond paper — hypersolved continuous-depth LM "
                   "scoring\n\n| solver | K/groups | NFE frac | KL vs "
                   "full depth | logit MAE |\n|---|---|---|---|---|\n")
        for r in by["cdepth_lm"]:
            out.append(f"| {r['solver']} | {r['K']}/"
                       f"{r['full_depth_groups']} | {r['nfe_fraction']} | "
                       f"{r.get('kl_vs_full_depth', '—')} | "
                       f"{r['logit_mae']} |\n")
    return "".join(out)


HEADER = """# EXPERIMENTS — the PyTorch/CUDA port

The port's record for *Hypersolvers: Toward Fast Continuous-Depth
Models* (NeurIPS 2020). PyTorch {tver}; every time below is a prediction
of the analytic roofline model on the {chip} record (not a measurement;
the port's measurements on the card are in PERF.md, each with the card's
name and power limit). Regenerate: `python -m repro_torch.roofline.report`,
`python -m repro_torch.roofline.hillclimb`, then this module.

"""


def main():
    import torch
    roof = _load(os.path.join(ART, "roofline_baseline.json"), [])
    hill = _load(os.path.join(ART, "hillclimb_log.json"), [])
    bench = _load(os.path.join(ART, "bench_results.json"), [])
    md = HEADER.format(tver=torch.__version__, chip=H100.name)
    md += dryrun_section(load_dryrun(os.path.join(ART, "dryrun")))
    md += roofline_section(roof)
    md += perf_section(hill)
    md += bench_section(bench)
    out = os.path.join(ART, "EXPERIMENTS.md")
    os.makedirs(ART, exist_ok=True)
    with open(out, "w") as f:
        f.write(md)
    print(f"wrote {out} ({len(md)} chars)")


if __name__ == "__main__":
    main()
