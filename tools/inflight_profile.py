"""Where the in-flight scheduler's time goes on the card, per model, read
from the serving CLI's own ``--profile-dir`` trace.

    python3 tools/inflight_profile.py [--arch qwen3_4b ...] [--out DIR]

For each model (full width, bf16, seeded random weights): a calibration
drain of the CLI's 8 prompts of 128 tokens sets the tolerance at a
quarter of the median probe error (as ``chip_smoke.py`` does, so K mixes
4 and 8), then the CLI serves 16 prompts in flight (``--inflight
--arrival-trace poisson``, slots 4, seg 2, euler, multi-rate, fused) once
with the synchronous loop and once with ``--overlap``, each under
``--profile-dir DIR/<arch>_<loop>``. From each Chrome trace: the CUDA
kernels and their summed device time, the device's busy share (kernel
time over the span of the traced serving loop; the profiler slows the
host, so the share is a floor), the CUDA runtime calls that wait for the
device or move data (per segment), and the kernels that take the most
time. One JSON line per model and loop, then the card's name and power
limit, and a last ``{"ok": true, ...}`` line. Needs one CUDA device.
"""
import argparse
import collections
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.launch import serve  # noqa: E402

S, REQUESTS = 128, 16
RUNTIME_CALLS = ("cudaLaunchKernel", "cudaMemcpyAsync",
                 "cudaStreamSynchronize", "cudaEventSynchronize",
                 "cudaDeviceSynchronize", "cudaHostAlloc")


def cli(arch, *extra):
    return serve.main(["--arch", arch, "--prompt-len", str(S), "--solver",
                       "euler", "--multirate", "--fused", "--buckets",
                       "2,4,8", *extra])


def read_trace(path, segments):
    """Kernel time, busy share and runtime calls of one Chrome trace."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X"]
    start = min(e["ts"] for e in events)
    span_us = max(e["ts"] + e.get("dur", 0) for e in events) - start
    kernels, calls = collections.Counter(), collections.Counter()
    runtime = collections.Counter()
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]] += e.get("dur", 0)
            calls[e["name"]] += 1
        elif e.get("cat") == "cuda_runtime" and e["name"] in RUNTIME_CALLS:
            runtime[e["name"]] += 1
    kernel_us = sum(kernels.values())
    return dict(
        traced_span_ms=span_us / 1e3,
        kernels=sum(calls.values()) or None,
        device_kernel_ms=kernel_us / 1e3 if calls else None,
        device_busy_share=kernel_us / span_us if calls else None,
        runtime_calls_per_segment={k: v / segments
                                   for k, v in sorted(runtime.items())},
        top_kernels_ms=[dict(name=n[:80], ms=us / 1e3, calls=calls[n])
                        for n, us in kernels.most_common(6)])


def profile_arch(arch, out_dir):
    calib = cli(arch, "--batch", "8")
    tol = float(np.median([r.err_probe for r in calib["results"]])) / 4.0
    del calib
    torch.cuda.empty_cache()
    for loop in ("sync", "overlap"):
        trace_dir = os.path.join(out_dir, f"{arch}_{loop}")
        out = cli(arch, "--batch", str(REQUESTS), "--tol", repr(tol),
                  "--inflight", "--arrival-trace", "poisson",
                  "--profile-dir", trace_dir,
                  *(["--overlap"] if loop == "overlap" else []))
        sched = out["sched"]
        row = dict(arch=arch, loop=loop, requests=REQUESTS, prompt_len=S,
                   slots=sched.slots, seg=sched.seg, tol=tol,
                   profiled_wall_s=out["seconds"],
                   segments=sched.dispatches,
                   K=[r.K for r in out["results"]],
                   statuses=sorted({r.status for r in out["results"]}),
                   **read_trace(os.path.join(trace_dir,
                                             "serve.pt.trace.json"),
                                sched.dispatches))
        print(json.dumps(row), flush=True)
        del out, sched
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+",
                    default=["qwen3_4b", "recurrentgemma_2b", "rwkv6_1p6b"])
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "inflight_profile"),
                    help="where the traces go (build/ is not committed; "
                         "a trace runs to tens of MB)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("inflight_profile: torch.cuda.is_available() is False; this "
              "tool needs a CUDA device", file=sys.stderr)
        return 2
    for arch in args.arch:
        profile_arch(arch, args.out)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
