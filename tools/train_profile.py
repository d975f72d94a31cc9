"""Where a full-width training step's device time goes, per model.

    python3 tools/train_profile.py [--arch qwen3_4b ...] [--steps 2]

For each model: full width, bf16, seeded random weights, the trainer's
step (``launch/steps.py::make_train_step`` with the CLI's settings:
remat none, AdamW over the warmup-cosine schedule, in place) on 8 x 128
tokens of ``token_batches``. Two warm-up steps, ``--steps`` steps timed
on the host clock between syncs, then ``--steps`` more under
``torch.profiler`` (CPU and CUDA activities). One JSON line per model:
host ms per step, device kernel ms per step (summed kernel time), the
device's busy share over the profiled steps' wall time (the profiler
slows the host, so this share is a floor), kernels per step, device ms
per step by kind of kernel (``KINDS``, matched on the kernel's name, the
first match wins) and the kernels that take the most device time. Where
the profiler records no kernel, the device fields are null ("not
measured"). Then the card's name and power limit, and a last ``{"ok":
true, ...}`` line. Needs one CUDA device.
"""
import argparse
import collections
import itertools
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.data import token_batches  # noqa: E402
from repro_torch.launch.steps import StepSettings, make_train_step  # noqa: E402
from repro_torch.models.lm import init_lm  # noqa: E402

B, S = 8, 128
# kind of kernel -> substrings of its name (lower case)
KINDS = [
    ("flash_attention", ("flash_attention",)),
    ("rglru_scan", ("rglru",)),
    ("rwkv6_scan", ("rwkv6", "wkv6")),
    ("gemm", ("gemm", "cutlass", "xmma", "sm90_", "cublas", "ampere_")),
    ("reduce", ("reduce",)),
    ("fill", ("fill",)),
    ("copy", ("copy", "memcpy", "cat")),
    ("elementwise", ("elementwise",)),
]


def kind_of(name: str) -> str:
    low = name.lower()
    return next((k for k, keys in KINDS if any(s in low for s in keys)),
                "other")


def profile_arch(arch, steps, dev):
    cfg = get(arch)
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                     device=dev)
    step_fn, opt = make_train_step(cfg, StepSettings(remat="none",
                                                     zero_opt=False))
    opt_state = opt.init(params)
    data = itertools.islice(token_batches(cfg.vocab, B, S, device=dev),
                            2 + 2 * steps)
    batches = [{"tokens": t, "targets": y} for t, y in data]
    i = 0

    def step():
        nonlocal params, opt_state, i
        params, opt_state, met = step_fn(params, opt_state, i, batches[i])
        i += 1
        return met

    for _ in range(2):
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
    kernels, count, kinds = (collections.Counter(), collections.Counter(),
                             collections.Counter())
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            kernels[e.name] += us
            count[e.name] += 1
            kinds[kind_of(e.name)] += us
    n_kernels = sum(count.values())
    device_ms = sum(kernels.values()) / 1e3 / steps if n_kernels else None
    row = dict(
        arch=arch, layers=cfg.n_layers, d_model=cfg.d_model, dtype=cfg.dtype,
        batch=B, seq=S, steps=steps, wall_ms_per_step=wall_ms,
        profiled_wall_ms_per_step=prof_wall_ms,
        device_kernel_ms_per_step=device_ms,
        device_busy_share=device_ms / prof_wall_ms if n_kernels else None,
        kernels_per_step=n_kernels / steps if n_kernels else None,
        device_ms_per_step_by_kind={k: us / 1e3 / steps for k, us in
                                    kinds.most_common()} if n_kernels
        else None,
        top_kernels_ms_per_step=[
            dict(name=name[:100], ms=us / 1e3 / steps,
                 calls=count[name] / steps)
            for name, us in kernels.most_common(10)])
    print(json.dumps(row), flush=True)
    del params, opt_state, batches
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+",
                    default=["qwen3_4b", "recurrentgemma_2b", "rwkv6_1p6b"])
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_profile: torch.cuda.is_available() is False; this "
              "tool needs a CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    for arch in args.arch:
        profile_arch(arch, args.steps, dev)
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
