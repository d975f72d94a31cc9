"""The hd-192 flash checks and the Nemotron-4 and Llama-4 phases of
``chip_smoke.py`` alone, on one card.

    python3 tools/nemotron_llama4_smoke.py [--archs nemotron_4_340b ...]

from the repository root. Builds the six kernels from the checkout
(``kernels/_build.py``; flash attention's ptxas lines printed), holds the
flash kernel against its plain version at ``chip_smoke.FLASH_CASES``'
head-width-192 cases and times them (``phase_flash``), holds its training
route's gradient at hd 192 to the all-plain one
(``phase_train_kernels``), then runs ``phase_nemotron`` (full-width
nemotron_4_340b at 4 layers) and ``phase_llama4`` (full-width
llama4_maverick_400b_a17b at 2 layers), or the ones ``--archs`` names:
each served through the engine and decoded, with launches counted and
the decode held to its teacher-forced limit. Each phase prints its JSON
line and raises on a failed check; then the launches, the card's name
and power limit, and a last ``{"ok": true, ...}`` line. Exits non-zero
without a CUDA device.
"""
import argparse
import collections
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

PHASES = {"nemotron_4_340b": cs.phase_nemotron,
          "llama4_maverick_400b_a17b": cs.phase_llama4}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--archs", nargs="+", default=list(PHASES),
                    choices=list(PHASES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("nemotron_llama4_smoke: torch.cuda.is_available() is False; "
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
    cs.emit(phase="build", seconds=time.perf_counter() - t0,
            ptxas=[line.strip() for line in
                   cs._build.BUILD_LOG.get("flash_attention", "")
                   .splitlines()
                   if "Used" in line or "spill" in line
                   or "Compiling entry" in line])
    bandwidth = cs.memory_bandwidth(name)
    cs.phase_flash(dev, bandwidth, [c for c in cs.FLASH_CASES
                                    if c[1][-1] == 192])
    cs.phase_train_kernels(dev, [c for c in cs.TRAIN_KERNEL_CASES
                                 if c[0] == "flash_attention"])
    t0 = time.perf_counter()
    launches = collections.Counter()
    for arch in args.archs:
        launches.update(PHASES[arch](dev, bandwidth))
    cs.emit(phase="nemotron_llama4_total", seconds=time.perf_counter() - t0,
            launches=dict(launches))
    print(smi, flush=True)
    cs.emit(ok=True, device=dict(platform="gpu", kind=name,
                                 count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
