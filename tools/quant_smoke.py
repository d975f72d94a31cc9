"""The quantized-path phases of ``chip_smoke.py`` alone, on one card.

    python3 tools/quant_smoke.py

Builds the six kernels from the checkout (``kernels/_build.py``), draws
full-width qwen3_4b (bf16, seed 0) and runs ``phase_kv_int8`` (8 x 4,096
prompt, 32 tokens with the bf16 and the int8 KV cache) and
``phase_chunking``; frees it, draws full-width olmoe_1b_7b (seed 0) with
the serving CLI's 8 x 128 prompt (the weights and prompt of
``chip_smoke.py``'s OLMoE phases) and runs ``phase_moe_int8`` (int8
dispatch on one block, the forward and a fixed-K drain) and
``phase_train_8bit`` (four training steps with 8-bit Adam moments, the
in-place update and the gradient compression checked on full-width
gradients); then the ``roofline_vs_measured`` rows of those phases. Each
phase prints its JSON line and raises on a failed check; then the
launches, the card's name and power limit, and a last ``{"ok": true,
...}`` line. Exits non-zero without a CUDA device.
"""
import collections
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("quant_smoke: torch.cuda.is_available() is False; this "
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
    t0 = time.perf_counter()
    params = cs.init_lm(torch.Generator(device=dev).manual_seed(0),
                        cs.get("qwen3_4b"), device=dev)
    launches.update(cs.phase_kv_int8(dev, cs.memory_bandwidth(name), params))
    launches.update(cs.phase_chunking(dev, params))
    del params
    cs.release_card()
    cfg = cs.get("olmoe_1b_7b")
    params = cs.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    # the serving CLI's prompt, which chip_smoke.py's OLMoE phases get
    prompt = np.random.RandomState(1).randint(
        0, cfg.vocab, size=(cs.B, cs.S)).astype(np.int32)
    launches.update(cs.phase_moe_int8(dev, params, prompt))
    launches.update(cs.phase_train_8bit(dev, params))
    del params
    cs.release_card()
    cs.emit(phase="quant_total", seconds=time.perf_counter() - t0)
    cs.report_roofline(None, decode_archs=(), train_archs=())
    cs.emit(launches=dict(launches))
    print(smi, flush=True)
    cs.emit(ok=True, device=dict(platform="gpu", kind=name,
                                 count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
