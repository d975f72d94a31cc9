"""The mesh phase of ``chip_smoke.py`` alone, on every visible card.

    python3 tools/mesh_smoke.py

On one card the pool's mesh of every card is that card; on several it
spans them, so each sub-pool runs on its own card with its own replica
of the model and of the correction's params.

Builds the six kernels from the checkout (``kernels/_build.py``) and
checks each against its plain version (``chip_smoke``'s kernel phases),
then runs what ``chip_smoke.phase_mesh`` needs, in ``chip_smoke.py``'s
order: ``phase_serve`` (full-width qwen3_4b, its params and calibrated
tolerance), ``phase_inflight`` (the unsharded pool's records) and
``phase_mesh`` (the pool over every visible card and split in two on
one card, sync and overlap, each held to the unsharded pool bit for bit;
a parametric g swapped mid-flight on the widest mesh; the serving CLI
with ``--mesh 1``, with ``--mesh <every card>`` and a restored g, and
its refusal of one card too many).
Each phase prints its JSON line and raises on a failed check; then the
launches, the card's name and power limit, and a last
``{"ok": true, ...}`` line. Exits non-zero without a CUDA device.
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
        print("mesh_smoke: torch.cuda.is_available() is False; this "
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
    bandwidth = cs.memory_bandwidth(name)
    cs.phase_kernels(dev, bandwidth)
    cs.phase_flash(dev, bandwidth)
    cs.phase_rglru(dev, bandwidth)
    cs.phase_rwkv6(dev, bandwidth)
    launches = collections.Counter()
    served, params, prompt, tol = cs.phase_serve(dev)
    launches.update(served)
    launches.update(cs.phase_inflight(dev, cs.get("qwen3_4b"), params,
                                      prompt, tol, keep_records=True))
    launches.update(cs.phase_mesh(dev, cs.get("qwen3_4b"), params, prompt,
                                  tol))
    cs.emit(launches=dict(launches))
    print(smi, flush=True)
    cs.emit(ok=True, device=dict(platform="gpu", kind=name,
                                 count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
