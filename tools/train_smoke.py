"""The trainer's phases of ``chip_smoke.py`` alone, on one card.

    python3 tools/train_smoke.py
    python3 tools/train_smoke.py --fp32-seeds 13 14 15 16 17

Builds the six kernels from the checkout (``kernels/_build.py``), then
runs ``chip_smoke.py``'s training phases in its order:
``phase_train_kernels`` (the kernels' training routes against their
plain versions), ``phase_train_cli`` (full-width qwen3_4b through
``python -m repro_torch.launch.train``'s ``main``), ``phase_train``
(full-width recurrentgemma_2b and rwkv6_1p6b through ``train_loop``, and
one float32 step of each dense family at reduced depth, kernel route
against plain) and ``phase_train_faults`` (the fault-tolerance scenarios
on reduced qwen3_4b). Each phase prints its JSON line and raises on a
failed check; then the launches, the card's name and power limit, and a
last ``{"ok": true, ...}`` line. Exits non-zero without a CUDA device.

With ``--fp32-seeds`` it runs only ``train_fp32_step`` for each dense
family, once per params seed, and prints each reading (kernel route and
planted fault against the plain route) without holding it to a limit:
the readings that ``chip_smoke.TRAIN_FP32_TOL`` is set between.
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fp32-seeds", type=int, nargs="+", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
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
    t0 = time.perf_counter()
    if args.fp32_seeds:
        batch = next(cs.token_batches(cs.get("rwkv6_1p6b").vocab, cs.B,
                                      cs.S, seed=0, device="cpu"))
        for arch, n in cs.FP32_DECODE_LAYERS.items():
            for seed in args.fp32_seeds:
                r = cs.train_fp32_step(dev, arch, n, batch, seed=seed)
                rel = {route: r[route]["grads"]["max_abs_diff"]
                       / r[route]["grads"]["max_abs"]
                       for route in ("kernel", "gradless")}
                cs.emit(phase="train_fp32_reading", arch=arch, seed=seed,
                        grads_rel=rel, **r)
        print(smi, flush=True)
        cs.emit(ok=True, device=dict(platform="gpu", kind=name,
                                     count=torch.cuda.device_count()))
        return 0
    cs.phase_train_kernels(dev)
    launches = collections.Counter(cs.phase_train_cli(dev))
    launches.update(cs.phase_train(dev))
    launches.update(cs.phase_train_faults(dev))
    cs.emit(phase="train_total", seconds=time.perf_counter() - t0,
            launches=dict(launches))
    print(smi, flush=True)
    cs.emit(ok=True, device=dict(platform="gpu", kind=name,
                                 count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
