"""Roofline report — the port of ``repro/roofline/report.py``: the analytic
cost model's terms per (arch x shape) on a chip record (the H100 by
default), with per-device memory from a dry-run artifact where one
exists.

    PYTHONPATH=src python -m repro_torch.roofline.report [--markdown out.md]

Per (arch x shape) and mesh: compute / memory / collective terms (s),
dominant term, MODEL_FLOPS and the useful-compute ratio. The CLI prints
the reference's two meshes (16 x 16 and 2 x 16 x 16) and one card
(1 x 1 x 1). On the H100 record every collective is priced at one NVLink
4 rate, which holds inside one 8-GPU node: the two large meshes are
what-ifs under that rate. Where the port's dry run
(``launch/dryrun.py``) has written a cell to ``artifacts/torch/dryrun/``,
its row on the two large meshes gains the traced per-device memory
(arguments and peak temporaries), the collective ops and the trace
seconds.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

from repro_torch.configs import ARCH_IDS, SHAPES, cell_is_applicable, get
from repro_torch.roofline.costmodel import (
    F32, H100, MULTI_POD, SINGLE_POD, Chip, Mesh2D, RooflineTerms, cell_cost,
)

ART = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "..",
                                   "..", "artifacts", "torch"))
ONE_CARD = Mesh2D(1, 1, 1)

# the reference's launch/dryrun.py TRAIN_SETTINGS, per architecture
_SETTINGS: Dict[str, Dict] = {
    "nemotron_4_340b": dict(microbatches=16, remat="full", seq_shard=True,
                            fsdp=True, moment_bytes=2),
    "llama4_maverick_400b_a17b": dict(microbatches=8, remat="full",
                                      seq_shard=True, fsdp=True,
                                      moment_bytes=2),
    "mistral_nemo_12b": dict(microbatches=4, remat="full"),
    "qwen3_8b": dict(microbatches=4, remat="full"),
    "whisper_base": dict(microbatches=1, remat="dots"),
    "_default": dict(microbatches=4, remat="full"),
}


def settings_for(arch: str) -> Dict:
    base = dict(microbatches=4, remat="full", seq_shard=False, fsdp=False,
                moment_bytes=F32)
    base.update(_SETTINGS.get(arch, _SETTINGS["_default"]))
    return base


def load_artifact(arch: str, shape: str, multi_pod: bool) -> Optional[Dict]:
    tag = f"{arch}__{shape}__{'mp' if multi_pod else 'sp'}.json"
    path = os.path.join(ART, "dryrun", tag)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def mesh_label(mesh: Mesh2D) -> str:
    if mesh == SINGLE_POD:
        return "16x16"
    if mesh == MULTI_POD:
        return "2x16x16"
    return f"{mesh.pod}x{mesh.data}x{mesh.model}"


def cell_row(arch: str, shape_name: str, multi_pod: bool = False, *,
             mesh: Optional[Mesh2D] = None, chip: Chip = H100) -> Dict:
    """One (arch x shape) row on ``mesh`` (default: the single- or
    multi-pod mesh by ``multi_pod``), priced on ``chip``."""
    cfg = get(arch)
    shape = SHAPES[shape_name]
    ok, reason = cell_is_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "SKIP",
                "reason": reason}
    s = settings_for(arch)
    if mesh is None:
        mesh = MULTI_POD if multi_pod else SINGLE_POD
    t: RooflineTerms = cell_cost(
        cfg, shape, mesh, remat=s["remat"], microbatches=s["microbatches"],
        seq_shard=s.get("seq_shard", False), fsdp=s.get("fsdp", False),
        moment_bytes=s.get("moment_bytes", F32), chip=chip)
    # dry-run artifacts exist only for the two large meshes
    art = load_artifact(arch, shape_name, mesh == MULTI_POD) \
        if mesh in (SINGLE_POD, MULTI_POD) else None
    row = {
        "arch": arch, "shape": shape_name, "status": "OK",
        "mesh": mesh_label(mesh),
        "t_compute_s": t.t_compute,
        "t_memory_s": t.t_memory,
        "t_collective_s": t.t_collective,
        "dominant": t.dominant,
        "roofline_fraction": round(t.roofline_fraction, 3),
        "model_flops": t.model_flops,
        "hlo_equiv_flops": t.flops_total,
        "useful_ratio": round(t.useful_ratio, 3),
    }
    if art and art.get("status") == "OK":
        mem = art["memory"]
        row["dev_temp_gib"] = round(mem["temp_bytes"] / 2 ** 30, 2)
        row["dev_args_gib"] = round(mem["argument_bytes"] / 2 ** 30, 2)
        row["traced_coll_ops"] = {k: v for k, v in
                                  art["collective_counts"].items() if v}
        row["trace_s"] = art["trace_s"]
    return row


def full_table(multi_pod: bool = False, *, mesh: Optional[Mesh2D] = None,
               chip: Chip = H100):
    return [cell_row(a, s, multi_pod, mesh=mesh, chip=chip)
            for a in ARCH_IDS for s in SHAPES]


def _fmt_s(x: float) -> str:
    if x >= 0.1:
        return f"{x:.2f}s"
    if x >= 1e-4:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}us"


def markdown_table(rows) -> str:
    hdr = ("| arch | shape | t_comp | t_mem | t_coll | dominant | "
           "roofline frac | useful | temp GiB/dev |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        if r["status"] == "SKIP":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | SKIP | "
                       f"— | — | — |\n")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(r['t_compute_s'])} | "
            f"{_fmt_s(r['t_memory_s'])} | {_fmt_s(r['t_collective_s'])} | "
            f"{r['dominant']} | {r['roofline_fraction']} | "
            f"{r['useful_ratio']} | {r.get('dev_temp_gib', '—')} |\n")
    return "".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--markdown", default=None)
    args = ap.parse_args(argv)
    meshes = ((SINGLE_POD, "what-if: 256 devices at one NVLink rate"),
              (MULTI_POD, "what-if: 512 devices at one NVLink rate"),
              (ONE_CARD, "one card; the reference's arithmetic still "
                         "prices its TP and logits collectives"))
    rows, md = [], [f"chip record {H100.describe()}\n"]
    for mesh, note in meshes:
        table = full_table(mesh=mesh, chip=H100)
        rows += table
        md.append(f"\n### mesh {mesh_label(mesh)} ({note})\n\n")
        md.append(markdown_table(table))
    md = "".join(md)
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(md)
    print(md)
    os.makedirs(ART, exist_ok=True)
    out = os.path.join(ART, "roofline_baseline.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=1, default=str)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
