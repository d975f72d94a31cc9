"""Readings behind ``chip_smoke.py``'s teacher-forced decode limits, and
the prefill's time with its readout at the last position against a
readout over every position, on one GPU.

    python3 tools/decode_limits.py [--seeds 1 2 3] [--archs ARCH ...]

from the repository root. For each model (full width in bf16, and
float32 at ``chip_smoke.py``'s 4 layers, Griffin 6; ``--archs`` keeps
the named ones; OLMoE runs in bf16 only; Nemotron-4-340B and Llama-4
Maverick in bf16 at ``chip_smoke.CUT_LAYERS``' depth, Mistral-NeMo-12B
and Qwen3-8B in bf16 at their full depth), seeded random
weights, 8 prompts of 128 tokens per prompt seed, 32 greedy tokens
(``chip_smoke.generate_logits``): the teacher-forced error of the sound
generate and of the same generate under the planted fault
``chip_smoke.lost_cache_writes`` (``chip_smoke.teacher_forced_err``, a
share of the largest |logit| at the worst generated position, or the
median one for a model in ``chip_smoke.DECODE_STAT``, both printed; for
a MoE model against a chain of decode steps), against the limit ``chip_smoke.py``
holds that model to; for ``whisper_base`` also the encoder-decoder's 32
teacher-forced cached decode steps against ``decode_train``, sound and
under ``chip_smoke.foreign_cross_kv`` (the LM readings are of the
decoder-only LM with learned positions that the serving CLI builds). For the bf16 LMs also
``lm_prefill`` (last position read out) and the same block loop with
every position read out then the last kept, timed on the host clock
around synchronised work in the order A B B A, three times. Prints the card's name and power limit
first, then one JSON line per model, then a last ``{"ok": true, ...}``
line; exits non-zero without a CUDA device or when a reading falls on
the wrong side of its limit.
"""
import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.models import lm  # noqa: E402


def every_position_prefill(params, cfg, prompt, caches, w):
    """The prefill with a readout over every position, the last kept."""
    h, _ = lm._blocks(params, cfg, lm.add_positions(
        params, cfg, lm._embed(params, cfg, prompt)), caches)
    return lm._readout(params, cfg, h, w)[:, -1].clone()


def prefill_times(params, cfg, prompt, w):
    times = {"last_position": [], "every_position": []}
    order = ["every_position", "last_position", "last_position",
             "every_position"] * 3
    for name in order:
        caches = lm.init_lm_cache(cfg, cs.B, cs.S + cs.GEN, device=w.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "last_position":
            lm.lm_prefill(params, cfg, prompt, caches, readout_w=w)
        else:
            every_position_prefill(params, cfg, prompt, caches, w)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        del caches
    return times


def readings(cfg, seeds, weight_seed, tol, dev):
    params = lm.init_lm(torch.Generator(device=dev).manual_seed(weight_seed),
                        cfg, device=dev)
    stat = cs.DECODE_STAT.get(cfg.name, "max")
    row = dict(arch=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
               limit=tol, position=stat, sound=[], fault=[],
               by_position={k: {"max": [], "median": []}
                            for k in ("sound", "fault")})
    with torch.no_grad():
        w = lm.readout_weight(params, cfg, lm.dtype_of(cfg.dtype))
        for seed in seeds:
            prompt = torch.as_tensor(np.random.RandomState(seed).randint(
                0, cfg.vocab, (cs.B, cs.S)), device=dev)
            for key, fault in (("sound", contextlib.nullcontext()),
                               ("fault", cs.lost_cache_writes())):
                with fault:
                    logits, toks, _, _ = cs.generate_logits(
                        params, cfg, prompt, cs.GEN, w)
                per = cs.teacher_forced_per_position(params, cfg, prompt,
                                                     logits, toks, w)
                reads = {"max": float(per.max()),
                         "median": float(per.median())}
                row[key].append(reads[stat])
                for k, v in reads.items():
                    row["by_position"][key][k].append(v)
        if cfg.dtype == "bfloat16":
            row["prefill_ms"] = prefill_times(params, cfg, prompt, w)
    del params, w
    torch.cuda.empty_cache()
    print(json.dumps(row), flush=True)
    return max(row["sound"]) <= tol < min(row["fault"])


def whisper_readings(seeds, dev):
    """Whisper-base's teacher-forced cached decode (``chip_smoke.py``'s
    ``whisper_decode_err``: full width, bf16, frames and tokens per seed)
    sound and under the planted fault ``foreign_cross_kv``, against
    ``chip_smoke.WHISPER_DECODE_TOL``."""
    cfg = get("whisper_base")
    params = cs.init_encdec(torch.Generator(device=dev).manual_seed(0), cfg,
                            device=dev)
    row = dict(arch=cfg.name, dtype=cfg.dtype, limit=cs.WHISPER_DECODE_TOL,
               sound=[], fault=[])
    for seed in seeds:
        batch = cs.whisper_inputs(cfg, dev, seed)
        with torch.no_grad():
            enc = cs.encdec.encode(params, cfg, batch["frames"])
        for key, fault in (("sound", False), ("fault", True)):
            row[key].append(cs.whisper_decode_err(
                params, cfg, enc, batch["tokens"], fault=fault)[0])
    del params
    torch.cuda.empty_cache()
    print(json.dumps(row), flush=True)
    return max(row["sound"]) <= cs.WHISPER_DECODE_TOL < min(row["fault"])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--archs", nargs="+", default=list(cs.BF16_DECODE_TOL))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_limits: torch.cuda.is_available() is False; this "
              "tool needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cs._build.build_all()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    ok = True
    for arch in args.archs:
        cfg = cs.cut_config(arch)
        ok &= readings(cfg, args.seeds, 0, cs.BF16_DECODE_TOL[arch], dev)
    if "whisper_base" in args.archs:
        ok &= whisper_readings(args.seeds, dev)
    for arch, n_layers in cs.FP32_DECODE_LAYERS.items():
        if arch not in args.archs:
            continue
        cfg = dataclasses.replace(get(arch), n_layers=n_layers,
                                  dtype="float32", param_dtype="float32")
        ok &= readings(cfg, args.seeds, 7, cs.FP32_DECODE_TOL, dev)
    if not ok:
        print("decode_limits: a reading is on the wrong side of its limit",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
