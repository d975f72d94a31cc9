"""Where an eager decode step's time goes on the card, per model.

    python3 tools/decode_profile.py [--arch qwen3_4b ...] [--steps 4]

For each model: full width, bf16, seeded random weights, 8 prompts of 128
tokens prefilled (``lm_prefill``), then decode steps (``lm_decode_step``,
the float32 readout matrix built once, as ``greedy_generate`` does). The
host clock times ``--steps`` synchronised steps; ``torch.profiler`` then
records ``--steps`` more (CPU and CUDA activities). One JSON line per
model: host ms per step, CUDA kernels per step and per block, the summed
device time of those kernels per step, the device's busy share (kernel
time over the same profiled steps' wall time; the profiler slows the
host, so this share is a floor), the host's ``cudaLaunchKernel``
calls per step, the kernels that take the most device time, and the
weight-bytes bound per step (2 B a parameter over the card's memory
rate). Where the profiler records no kernel, the device fields are null
("not measured"). Then the card's name and power limit, and a last
``{"ok": true, ...}`` line. Needs one CUDA device.
"""
import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.roofline.costmodel import H100  # noqa: E402

B, S = 8, 128
# the cost model's H100 record: the published HBM3 rate, bytes/s
BANDWIDTH = {H100.name: H100.hbm_bw}


def profile_arch(arch, steps, dev, bandwidth):
    cfg = get(arch)
    params = lm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    prompt = torch.as_tensor(np.random.RandomState(1).randint(
        0, cfg.vocab, (B, S)), device=dev)
    n_blocks = cfg.n_layers
    with torch.no_grad():
        w = lm.readout_weight(params, cfg, lm.dtype_of(cfg.dtype))
        caches = lm.init_lm_cache(cfg, B, S + 3 * steps + 2, device=dev)
        logits, caches = lm.lm_prefill(params, cfg, prompt, caches,
                                       readout_w=w)
        pos = S

        def step():
            nonlocal logits, caches, pos
            tok = logits.argmax(-1).to(torch.int32)
            logits, caches = lm.lm_decode_step(params, cfg, tok, caches, pos,
                                               readout_w=w)
            pos += 1

        for _ in range(steps):          # warm-up
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps

        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = collections.Counter()
    count = collections.Counter()
    launches = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] += e.time_range.elapsed_us()
            count[e.name] += 1
        elif e.name == "cudaLaunchKernel":
            launches += 1
    n_kernels = sum(count.values())
    device_ms = sum(kernels.values()) / 1e3 / steps if n_kernels else None
    n_params = lm.count_params(params)
    row = dict(
        arch=arch, layers=cfg.n_layers, d_model=cfg.d_model, dtype=cfg.dtype,
        batch=B, context=S, steps=steps, wall_ms_per_step=wall_ms,
        kernels_per_step=n_kernels / steps if n_kernels else None,
        kernels_per_block=n_kernels / steps / n_blocks if n_kernels
        else None,
        profiled_wall_ms_per_step=prof_wall_ms,
        device_kernel_ms_per_step=device_ms,
        device_busy_share=device_ms / prof_wall_ms if n_kernels else None,
        host_launch_calls_per_step=launches / steps,
        top_kernels_ms_per_step=[
            dict(name=name[:80], ms=us / 1e3 / steps, calls=count[name]
                 // steps) for name, us in kernels.most_common(8)],
        params=n_params,
        weight_bytes_bound_ms_per_step=2 * n_params / bandwidth * 1e3)
    print(json.dumps(row), flush=True)
    del params, caches, w, logits
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+",
                    default=["qwen3_4b", "recurrentgemma_2b", "rwkv6_1p6b"])
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_profile: torch.cuda.is_available() is False; this "
              "tool needs a CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    if name not in BANDWIDTH:
        raise RuntimeError(f"no memory rate on record for {name!r}")
    for arch in args.arch:
        profile_arch(arch, args.steps, dev, BANDWIDTH[name])
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
