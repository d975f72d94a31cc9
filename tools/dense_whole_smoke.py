"""The Mistral-NeMo-12B and Qwen3-8B phases of ``chip_smoke.py`` alone,
on one card.

    python3 tools/dense_whole_smoke.py [--archs mistral_nemo_12b ...]

from the repository root. Builds the six kernels from the checkout
(``kernels/_build.py``), holds hyper_step against its plain version at
both models' drain widths (``chip_smoke.hs_cases``' 4,096 and 5,120
cases) and flash attention at their shape (the ``qwen3`` case: bf16,
causal, 32 heads of 128 over 8, 8 x 128) and times them, then runs
``phase_mistral_nemo`` (full-width mistral_nemo_12b at its 40 layers)
and ``phase_qwen3_8b`` (full-width qwen3_8b at its 36 layers), or the
ones ``--archs`` names: each served through the engine (euler and
hyper_euler), in flight (Mistral-NeMo's overlap loop through the serving
CLI) and decoded, with launches counted and the decode held to its
teacher-forced limit. Each phase prints its JSON line and raises on a
failed check; then the launches, the card's name and power limit, and a
last ``{"ok": true, ...}`` line. Exits non-zero without a CUDA device.
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

PHASES = {"mistral_nemo_12b": cs.phase_mistral_nemo,
          "qwen3_8b": cs.phase_qwen3_8b}
HS_CASES = ("euler+g-5120", "euler+g-4096")
FLASH_CASES = ("qwen3",)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--archs", nargs="+", default=list(PHASES),
                    choices=list(PHASES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dense_whole_smoke: torch.cuda.is_available() is False; "
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
    cs.phase_kernels(dev, bandwidth, [c for c in cs.hs_cases()
                                      if c.name in HS_CASES])
    cs.phase_flash(dev, bandwidth, [c for c in cs.FLASH_CASES
                                    if c[0] in FLASH_CASES])
    t0 = time.perf_counter()
    launches = collections.Counter()
    for arch in args.archs:
        launches.update(PHASES[arch](dev, bandwidth))
    cs.emit(phase="dense_whole_total", seconds=time.perf_counter() - t0,
            launches=dict(launches))
    print(smi, flush=True)
    cs.emit(ok=True, device=dict(platform="gpu", kind=name,
                                 count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
