"""The roofline phase of ``chip_smoke.py`` alone, on one card.

    python3 tools/roofline_smoke.py

Builds the six kernels from the checkout (``kernels/_build.py``), then
runs what ``chip_smoke.phase_roofline`` needs, in ``chip_smoke.py``'s
order: ``phase_serve`` (full-width qwen3_4b, its params and calibrated
tolerance), ``phase_inflight`` (the in-flight K it is held to) and
``phase_roofline`` (the drain and both in-flight loops on the roofline
clock, the serving CLI with ``--cost-oracle roofline``, segments timed
by CUDA events); then qwen3_4b's decode through the CLI's default
(``phase_decode_cli``) and the ``roofline_vs_measured`` line of the
segment and that decode. Each phase prints its JSON line and raises on a
failed check; then the launches, the card's name and power limit, and a
last ``{"ok": true, ...}`` line. Exits non-zero without a CUDA device.
"""
import collections
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("roofline_smoke: torch.cuda.is_available() is False; this "
              "script needs a CUDA device", file=sys.stderr)
        return 2
    dev = cs.resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    cs._build.build_all()
    cs.emit(phase="build", seconds=time.perf_counter() - t0)
    launches = collections.Counter()
    served, params, prompt, tol = cs.phase_serve(dev)
    launches.update(served)
    launches.update(cs.phase_inflight(dev, cs.get("qwen3_4b"), params,
                                      prompt, tol))
    t0 = time.perf_counter()
    roof, segment = cs.phase_roofline(dev, params, prompt, tol)
    launches.update(roof)
    cs.emit(phase="roofline_total", seconds=time.perf_counter() - t0)
    del params
    cs.release_card()
    launches.update(cs.phase_decode_cli(dev, cs.memory_bandwidth(name),
                                        "qwen3_4b"))
    cs.report_roofline(segment, decode_archs=("qwen3_4b",), train_archs=())
    cs.emit(launches=dict(launches))
    print(smi, flush=True)
    cs.emit(ok=True, device=dict(platform="gpu", kind=name,
                                 count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
