"""Serving CLI of the port — the argparse surface of ``repro/launch/serve.py``
plus ``--device`` (default ``cuda``; ``cpu`` on request, never as a
fallback). Batching/eps policy lives in ``launch/engine.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_4b \
        --batch 8 --prompt-len 128 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_4b \
        --solver euler --multirate --fused --buckets 2,4,8 \
        --batch 8 --prompt-len 128
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma_2b --reduced --device cpu --solver euler \
        --multirate --fused --batch 2 --prompt-len 16

Any ported architecture serves (``qwen3_4b``, ``recurrentgemma_2b``,
``rwkv6_1p6b``).

solver=discrete (default): standard full-depth cached decode
(``engine.greedy_generate``): the prompt is prefilled through the port's
kernels, then ``--gen`` tokens are decoded greedily one at a time.
Reports tokens per second and the NFE equivalent (one per group).

solver=euler|heun|...|hyper_* : continuous-depth scoring at a fixed
``--nfe K`` or error-controlled ``--multirate`` (``--tol``,
``--buckets``, ``--max-batch``), with ``--fused`` routing every solver
step's update through the CUDA kernel, and ``--g-ckpt``/``--g-rank``
loading a correction the JAX package trained. Reports per-request K, NFE
and argmax agreement against the full-depth forward.

Flags of slices not ported yet exit non-zero naming their ROADMAP.md item:
``--inflight`` and its knobs, ``--mesh``, ``--overlap``, ``--refine*``,
``--flow-*``, ``--cost-oracle roofline`` and ``--profile-dir``.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get
from repro_torch.launch.engine import (EngineConfig, MultiRateEngine,
                                       greedy_generate, lm_depth_model,
                                       load_g_params)
from repro_torch.models.lm import (discrete_nfe, group_layout, init_lm,
                                   lm_forward)

_ITEM = {
    "inflight": "ROADMAP.md queue 1 item 3 (the in-flight scheduler)",
    "flow": "ROADMAP.md queue 1 item 4 (the K=0 flow tier)",
    "refine": "ROADMAP.md queue 1 item 5 (the online refinery)",
    "roofline": "ROADMAP.md queue 1 item 9 (cost model on H100 terms)",
    "mesh": "ROADMAP.md queue 1 item 10 (the multi-GPU slot pool)",
    "profile": "ROADMAP.md queue 1 item 11 (serving-loop profiling)",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda by default; pass "
                         "cpu to run on the CPU — there is no fallback)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--solver", default="discrete")
    ap.add_argument("--nfe", type=int, default=0,
                    help="fixed mesh length K (ignored with --multirate)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--g-ckpt", default=None,
                    help="checkpoint dir of a trained LM hypersolver "
                         "correction, as the JAX package writes it "
                         "(enables hyper_* solvers)")
    ap.add_argument("--g-rank", type=int, default=32,
                    help="rank of the g_omega checkpoint being restored")
    ap.add_argument("--flow-ckpt", default=None, help=_ITEM["flow"])
    ap.add_argument("--flow-rank", type=int, default=64, help=_ITEM["flow"])
    ap.add_argument("--flow-threshold", type=float, default=0.0,
                    help=_ITEM["flow"])
    ap.add_argument("--multirate", action="store_true",
                    help="error-controlled per-request step sizes "
                         "(launch/engine.py) instead of one fixed K")
    ap.add_argument("--tol", type=float, default=1e-2,
                    help="probe local-error tolerance for --multirate")
    ap.add_argument("--buckets", default="2,4,8",
                    help="comma-separated serving K buckets for --multirate")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--fused", action="store_true",
                    help="route every solver step's update through the "
                         "hand-written CUDA kernel (any bucket mix fuses)")
    ap.add_argument("--inflight", action="store_true", help=_ITEM["inflight"])
    ap.add_argument("--seg", type=int, default=2, help=_ITEM["inflight"])
    ap.add_argument("--slots", type=int, default=4, help=_ITEM["inflight"])
    ap.add_argument("--arrival-trace", default="none",
                    choices=["none", "poisson", "bursty"],
                    help=_ITEM["inflight"])
    ap.add_argument("--arrival-rate", type=float, default=0.25,
                    help=_ITEM["inflight"])
    ap.add_argument("--mesh", type=int, default=0, help=_ITEM["mesh"])
    ap.add_argument("--cost-oracle", default="sequential",
                    choices=["sequential", "roofline"],
                    help="virtual-clock pricing: 'sequential' counts "
                         "sequential field evals; 'roofline' waits for "
                         + _ITEM["roofline"])
    ap.add_argument("--overlap", action="store_true", help=_ITEM["inflight"])
    ap.add_argument("--deadline", type=float, default=0.0,
                    help=_ITEM["inflight"])
    ap.add_argument("--queue-cap", type=int, default=0,
                    help=_ITEM["inflight"])
    ap.add_argument("--overload-policy", default="shed",
                    choices=["shed", "degrade", "block"],
                    help=_ITEM["inflight"])
    ap.add_argument("--profile-dir", default=None, help=_ITEM["profile"])
    ap.add_argument("--refine", action="store_true", help=_ITEM["refine"])
    ap.add_argument("--refine-dir", default=None, help=_ITEM["refine"])
    ap.add_argument("--capture-rate", type=float, default=1.0,
                    help=_ITEM["refine"])
    ap.add_argument("--ledger-cap", type=int, default=512,
                    help=_ITEM["refine"])
    ap.add_argument("--refine-steps", type=int, default=2,
                    help=_ITEM["refine"])
    ap.add_argument("--shadow-every", type=int, default=50,
                    help=_ITEM["refine"])
    ap.add_argument("--ledger-out", default=None, help=_ITEM["refine"])
    ap.add_argument("--progress-every", type=int, default=0,
                    help=_ITEM["inflight"])
    return ap


def _refuse_unported(args) -> None:
    """Exit non-zero, naming the ROADMAP.md item, for any flag of a slice
    that is not ported yet (a silently ignored flag would mislabel a run)."""
    waits = []
    if args.inflight or args.overlap or args.seg != 2 or args.slots != 4 \
            or args.arrival_trace != "none" or args.arrival_rate != 0.25 \
            or args.deadline or args.queue_cap \
            or args.overload_policy != "shed" or args.progress_every:
        waits.append(("--inflight and its knobs", "inflight"))
    if args.mesh:
        waits.append(("--mesh", "mesh"))
    if args.refine or args.refine_dir or args.ledger_out \
            or args.capture_rate != 1.0 or args.ledger_cap != 512 \
            or args.refine_steps != 2 or args.shadow_every != 50:
        waits.append(("--refine and its knobs", "refine"))
    if args.flow_ckpt or args.flow_threshold or args.flow_rank != 64:
        waits.append(("--flow-ckpt/--flow-threshold/--flow-rank", "flow"))
    if args.cost_oracle == "roofline":
        waits.append(("--cost-oracle roofline", "roofline"))
    if args.profile_dir:
        waits.append(("--profile-dir", "profile"))
    if waits:
        raise SystemExit("not ported to repro_torch yet: " + "; ".join(
            f"{flag} waits for {_ITEM[item]}" for flag, item in waits))


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the CLI; returns what it served (params, prompt and timings,
    with the tokens of the discrete path or the engine and results of a
    solver) for programmatic callers."""
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    device = resolve_device(args.device)

    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_lm(gen, cfg, device=device)
    prompt = np.random.RandomState(1).randint(
        0, cfg.vocab, size=(args.batch, args.prompt_len)).astype(np.int32)

    if args.solver == "discrete":
        with torch.no_grad():
            _synchronize(device)
            t0 = time.perf_counter()
            toks = greedy_generate(params, cfg, prompt, args.gen)
            _synchronize(device)
            dt = time.perf_counter() - t0
        toks = toks.cpu().numpy()
        print(f"[discrete] {args.batch}x{args.gen} tokens in {dt:.2f}s "
              f"({args.batch * args.gen / dt:.1f} tok/s), "
              f"NFE/token = {discrete_nfe(cfg)} groups")
        print("sample:", toks[0, :16])
        return dict(cfg=cfg, params=params, prompt=prompt, tokens=toks,
                    seconds=dt, device=device)

    _, n_groups, _ = group_layout(cfg)
    g_params = None
    if args.g_ckpt:
        g_params = load_g_params(args.g_ckpt, cfg, rank=args.g_rank,
                                 device=device)
    if args.solver.startswith("hyper_") and g_params is None:
        raise SystemExit(f"--solver {args.solver} needs --g-ckpt "
                         "(a trained correction checkpoint)")

    buckets = tuple(int(b) for b in args.buckets.split(","))
    K_fixed = args.nfe or max(1, n_groups // 2)
    ecfg = EngineConfig(
        buckets=buckets if args.multirate else (K_fixed,),
        tol=args.tol,
        max_batch=args.max_batch,
        solver=args.solver,
        controller="auto" if args.multirate else "fixed",
        fixed_K=K_fixed,
        fused=args.fused,
    )
    model = lm_depth_model(params, cfg, solver=args.solver,
                           g_params=g_params, fused=args.fused)
    engine = MultiRateEngine(model, ecfg)

    with torch.no_grad():
        full, _ = lm_forward(params, cfg, torch.as_tensor(prompt,
                                                          device=device))
        full_top = full.argmax(-1).cpu().numpy()
        del full
        _synchronize(device)
        t0 = time.perf_counter()
        results = engine.run(prompt)
        _synchronize(device)
        dt = time.perf_counter() - t0
    agree = [float(np.mean(np.argmax(r.outputs, -1) == full_top[i]))
             for i, r in enumerate(results)]
    nfes = [r.nfe for r in results]
    mode = "multirate" if args.multirate else f"K={K_fixed}"
    print(f"[{args.solver} {mode} {device}] scored "
          f"{args.batch}x{args.prompt_len} in {dt:.3f}s; mean NFE "
          f"{np.mean(nfes):.2f}/{n_groups} (probe {engine.probe_nfe}); mean "
          f"argmax agreement vs full depth: {np.mean(agree):.3f}")
    for r, a in zip(results, agree):
        print(f"  req {r.uid}: K={r.K} nfe={r.nfe} "
              f"err_probe={r.err_probe:.3e} agree={a:.3f} "
              f"fused={r.fused_kernel} status={r.status}")
    return dict(cfg=cfg, params=params, prompt=prompt, engine=engine,
                results=results, agree=agree, full_top=full_top, seconds=dt,
                device=device)


if __name__ == "__main__":
    main()
