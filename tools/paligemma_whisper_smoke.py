"""The PaliGemma and Whisper phases of ``chip_smoke.py`` alone, on one card.

    python3 tools/paligemma_whisper_smoke.py

Builds the six kernels from the checkout (``kernels/_build.py``), then
runs ``chip_smoke.py``'s ``phase_paligemma`` (full-width paligemma_3b
with its patch frontend: the prefill step, the continuous-depth scorer,
the serving CLI's cached decode and five train steps) and
``phase_whisper`` (full-width whisper_base: the prefill step, the cached
decode against teacher forcing, five steps of ``train_loop`` and the
float32 step against the all-plain model). Each phase prints its JSON
line and raises on a failed check; then the launches, the card's name
and power limit, and a last ``{"ok": true, ...}`` line. Exits non-zero
without a CUDA device.
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
        print("paligemma_whisper_smoke: torch.cuda.is_available() is False; "
              "this script needs a CUDA device", file=sys.stderr)
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
    bandwidth = cs.memory_bandwidth(name)
    t0 = time.perf_counter()
    launches = collections.Counter(cs.phase_paligemma(dev, bandwidth))
    launches.update(cs.phase_whisper(dev, bandwidth))
    cs.emit(phase="paligemma_whisper_total",
            seconds=time.perf_counter() - t0, launches=dict(launches))
    print(smi, flush=True)
    cs.emit(ok=True, device=dict(platform="gpu", kind=name,
                                 count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
