"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Builds every CUDA kernel of the serving path from the sources in the
checkout, holds each against its plain PyTorch version at the serving
shapes and times both, serves full-width ``qwen3_4b`` (36 layers, d 2560,
bf16, random weights from a seeded generator) through the port's serving
CLI and engine with the fused kernel, and checks fused against unfused
serving in float32. Every phase prints one JSON line and raises on
failure. The line before the last is the kernels' record; the last line
is ``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when no CUDA device is available or the port's sources are missing.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core.tableaus import get as get_tableau  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.hyper_step import ops as hs_ops  # noqa: E402
from repro_torch.kernels.hyper_step.ref import fused_rk_update_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.engine import (  # noqa: E402
    EngineConfig, MultiRateEngine, lm_depth_model, snap_to_buckets)
from repro_torch.models.cdepth import lm_g_init  # noqa: E402
from repro_torch.models.lm import init_lm  # noqa: E402
from repro_torch.nn.module import truncated_normal_init  # noqa: E402

B, S, D = 8, 128, 2560          # the serving phase's batch of prompts
BUCKETS = "2,4,8"
FP32_PEAK = 67e12               # H100 SXM float32 outside the tensor cores


def emit(**row):
    print(json.dumps(row), flush=True)


def memory_bandwidth(name: str) -> float:
    """Published device-memory rate of the card (bytes/s): H100 SXM only."""
    if name == "NVIDIA H100 80GB HBM3":
        return 3.35e12
    raise RuntimeError(f"no memory rate on record for {name!r}")


def ordered_bits(t: torch.Tensor) -> torch.Tensor:
    """16-bit float patterns as integers ordered like the values."""
    b = t.view(torch.int16).to(torch.int32)
    return torch.where(b < 0, -(b & 0x7FFF), b)


def time_ms(fn, flush: torch.Tensor, reps: int = 30) -> float:
    """Median device time of ``fn`` in ms, cold L2: the flush buffer is
    rewritten before each run, and a sleep kernel keeps the stream busy
    while the host enqueues, so the events bracket device work only."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(5_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_kernels(dev, bandwidth):
    """hyper_step at the serving shape: kernel against plain version, both
    timed, and the bound of this run's data (frozen rows read only z)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    Ks = torch.tensor([2, 4, 8, 8, 4, 2, 8, 4], dtype=torch.int32, device=dev)
    eps = torch.tensor(1.0, device=dev) / Ks
    act = torch.tensor([1, 1, 1, 1, 1, 1, 0, 0], dtype=torch.int32,
                       device=dev)
    dopri = tuple(bj for bj in get_tableau("dopri5").b if bj != 0.0)
    cases = [("euler+g", (1.0,), True, 1), ("heun", (0.5, 0.5), False, 2),
             ("dopri5-live", dopri, False, 5)]
    rows, max_err = [], 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for name, b, with_g, order in cases:
            draw = lambda: torch.randn((B, S, D), generator=gen,  # noqa
                                       device=dev).to(dtype)
            z, stages = draw(), [draw() for _ in b]
            g = draw() if with_g else None
            out = hs_ops.fused_rk_update(z, stages, g, eps, b, order,
                                         active=act)
            ref = fused_rk_update_ref(z, stages, g, eps, b, order, active=act)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            if dtype == torch.float32:
                ok = bool(((out - ref).abs()
                           <= 1e-6 + 1e-6 * ref.abs()).all())
            else:
                ok = int((ordered_bits(out) - ordered_bits(ref))
                         .abs().max()) <= 1
            if not ok:
                raise AssertionError(f"hyper_step {name} {dtype}: kernel "
                                     f"disagrees with plain (max {err})")
            if not torch.equal(out[act == 0], z[act == 0]):
                raise AssertionError(f"hyper_step {name}: frozen rows moved")
            max_err = max(max_err, err)
            eps_row, epsp_row = eps.contiguous(), eps ** (order + 1)
            buf = torch.empty_like(z)
            ms = time_ms(lambda: hs_ops.launch(
                buf, z, stages, g, eps_row, epsp_row, act, b), flush)
            plain_ms = time_ms(lambda: fused_rk_update_ref(
                z, stages, g, eps, b, order, active=act), flush)
            n_act = int(act.sum())
            per_row = S * D * z.element_size()
            operands = len(b) + 2 + int(with_g)
            nbytes = (n_act * operands + (B - n_act) * 2) * per_row + B * 12
            flops = n_act * S * D * 2 * (len(b) + int(with_g))
            bound_ms = max(nbytes / bandwidth, flops / FP32_PEAK) * 1e3
            rows.append(dict(case=name, dtype=str(dtype).replace("torch.", ""),
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bytes=nbytes,
                             bound_by="bytes" if nbytes / bandwidth
                             >= flops / FP32_PEAK else "operations"))
    emit(phase="kernels", kernel="hyper_step", shape=[B, S, D],
         eps=eps.tolist(), active=act.tolist(), cases=rows,
         max_abs_err=max_err)
    return rows, max_err


def packed_k_max_sum(results, max_batch):
    """Sum of k_max over the engine's packed batches: stable sort by K,
    chunks of max_batch (one drain, no retries)."""
    Ks = np.sort(np.asarray([r.K for r in results]), kind="stable")
    return int(sum(Ks[lo:lo + max_batch].max()
                   for lo in range(0, len(Ks), max_batch)))


def straddling_tol(errs, q: int = 1) -> float:
    """A tolerance that splits this run's probe errors across the bucket
    edge at 4: a request takes K = ceil((err / tol)^(1/q)), i.e. at most 4
    below the median error and 5, snapped to 8, above it. Random weights
    probe alike (the errors sit within a few percent), so no fixed
    tolerance would mix K."""
    return float(np.median(errs)) / 4.0 ** q


def check_served(results, tag):
    buckets = {int(b) for b in BUCKETS.split(",")}
    if len({r.K for r in results}) < 2:
        raise AssertionError(f"{tag}: every request took K={results[0].K}; "
                             "the batch must mix K")
    for r in results:
        if r.status != "ok":
            raise AssertionError(f"{tag}: request {r.uid} status {r.status}")
        if not np.isfinite(r.outputs).all():
            raise AssertionError(f"{tag}: request {r.uid} non-finite")
        if r.K not in buckets:
            raise AssertionError(f"{tag}: request {r.uid} K={r.K}")
        if not r.fused_kernel:
            raise AssertionError(f"{tag}: request {r.uid} not fused")


def serve_breakdown(engine, prompt):
    """Where one drain's time goes (host clock around synchronised work,
    median of 3): the probe (embed + probe step), the fused solve, the
    float32 readout, the host copy of the logits into Completed, and the
    engine's host finite screen of them."""
    m, ctrl = engine.model, engine.controller

    def timed(fn):
        out, times = None, []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return out, float(np.median(times)) * 1e3

    with torch.no_grad():
        (z0, probe), probe_ms = timed(lambda: (
            lambda z: (z, ctrl.select(m.integ, m.field_of(prompt), z,
                                      m.span)))(m.embed(prompt)))
        Ks = torch.as_tensor(snap_to_buckets(
            probe.K.cpu().numpy(), engine.ecfg.buckets), device=z0.device)
        k_max = int(Ks.max())
        zT, solve_ms = timed(lambda: m.integ.solve_multirate(
            m.field_of(prompt), z0, m.span, Ks, k_max,
            first_stage=probe.dz0))
        logits, readout_ms = timed(lambda: m.readout(prompt, zT))
        host, copy_ms = timed(lambda: logits.cpu().numpy())
        _, screen_ms = timed(lambda: np.isfinite(
            host.reshape(len(host), -1)).all(axis=1))
    return dict(probe=probe_ms, solve=solve_ms, k_max=k_max,
                readout=readout_ms, host_copy=copy_ms,
                host_finite_screen=screen_ms)


def serve_cli(*extra):
    return serve.main(["--arch", "qwen3_4b", "--batch", str(B),
                       "--prompt-len", str(S), "--solver", "euler",
                       "--multirate", "--fused", "--buckets", BUCKETS,
                       *extra])


def hyper_engine(params, cfg, gp, tol):
    model = lm_depth_model(params, cfg, solver="hyper_euler", g_params=gp,
                           fused=True)
    ecfg = EngineConfig(buckets=tuple(int(b) for b in BUCKETS.split(",")),
                        tol=tol, max_batch=8, solver="hyper_euler",
                        fused=True)
    return MultiRateEngine(model, ecfg)


def phase_serve(dev):
    """The main path: full-width qwen3_4b served through the CLI (euler)
    and the engine (hyper_euler with a seeded nonzero g), every solver
    step's update through the kernel, each batch mixing K. A calibration
    run before it reads this run's probe errors and picks each solver's
    tolerance from them."""
    torch.cuda.reset_peak_memory_stats(dev)
    calib = serve_cli()
    cfg, prompt = calib["cfg"], calib["prompt"]
    gen = torch.Generator(device=dev).manual_seed(1)
    gp = lm_g_init(gen, cfg, rank=32, device=dev)
    gp["w_out"] = truncated_normal_init(gen, gp["w_out"].shape, 0.02,
                                        gp["w_out"].dtype, dev)
    tol_euler = straddling_tol([r.err_probe for r in calib["results"]])
    with torch.no_grad():
        tol_hyper = straddling_tol(hyper_engine(
            calib["params"], cfg, gp, 1e-2).probe(prompt)[1])
    del calib
    torch.cuda.empty_cache()

    hs_ops.LAUNCHES.clear()
    t0 = time.perf_counter()
    cli = serve_cli("--tol", repr(tol_euler))
    cli_wall = time.perf_counter() - t0
    check_served(cli["results"], "serve euler")
    params = cli["params"]

    engine = hyper_engine(params, cfg, gp, tol_hyper)
    ecfg, model = engine.ecfg, engine.model
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hyper = engine.run(prompt)
        torch.cuda.synchronize()
        hyper_s = time.perf_counter() - t0
    check_served(hyper, "engine hyper_euler")
    launches = hs_ops.LAUNCHES["hyper_step"]
    expected = packed_k_max_sum(cli["results"], 8) \
        + packed_k_max_sum(hyper, ecfg.max_batch)
    if launches != expected:
        raise AssertionError(f"hyper_step launched {launches} times, the "
                             f"solver steps were {expected}")
    hyper_agree = [float(np.mean(np.argmax(r.outputs, -1)
                                 == cli["full_top"][i]))
                   for i, r in enumerate(hyper)]

    breakdown = serve_breakdown(cli["engine"], prompt)
    emit(phase="serve", arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, batch=B, prompt_len=S,
         euler=dict(seconds=cli["seconds"], cli_wall_s=cli_wall,
                    tol=tol_euler, K=[r.K for r in cli["results"]],
                    mean_nfe=float(np.mean([r.nfe for r in cli["results"]])),
                    agree=float(np.mean(cli["agree"]))),
         hyper_euler=dict(seconds=hyper_s, tol=tol_hyper,
                          K=[r.K for r in hyper],
                          mean_nfe=float(np.mean([r.nfe for r in hyper])),
                          agree=float(np.mean(hyper_agree))),
         hyper_step_launches=launches, expected_launches=expected,
         euler_breakdown_ms=breakdown,
         logits_bytes=B * S * cfg.vocab * 4,
         peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    del cli, params, model, engine, gp
    return launches


def phase_fused_vs_unfused(dev):
    """Full width in float32 at 4 layers, TF32 off: fused and unfused
    serving pick the same K and agree to rtol 1e-4 (atol 1e-5 of the
    largest logit)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get("qwen3_4b"), n_layers=4, dtype="float32",
                              param_dtype="float32")
    params = init_lm(torch.Generator(device=dev).manual_seed(2), cfg,
                     device=dev)
    prompt = np.random.RandomState(3).randint(0, cfg.vocab, (B, S))
    report = {}
    for solver in ("euler", "heun"):
        def engine(fused, tol):
            return MultiRateEngine(
                lm_depth_model(params, cfg, solver=solver, fused=fused),
                EngineConfig(buckets=(2, 4, 8), tol=tol, solver=solver,
                             fused=fused))
        with torch.no_grad():
            tol = straddling_tol(engine(False, 1e-2).probe(prompt)[1],
                                 get_tableau(solver).order)
            runs = [engine(fused, tol).run(prompt) for fused in (False, True)]
        ks = [[r.K for r in run] for run in runs]
        if ks[0] != ks[1]:
            raise AssertionError(f"{solver}: K unfused {ks[0]} fused {ks[1]}")
        if len(set(ks[1])) < 2:
            raise AssertionError(f"{solver}: every request took K={ks[1][0]}")
        diff = scale = 0.0
        for a, b in zip(*runs):
            # rtol 1e-4; atol 1e-5 of the largest logit, because a logit is
            # a 2560-term dot product whose rounding scales with its terms
            np.testing.assert_allclose(b.outputs, a.outputs, rtol=1e-4,
                                       atol=1e-5 * np.abs(a.outputs).max())
            diff = max(diff, float(np.abs(b.outputs - a.outputs).max()))
            scale = max(scale, float(np.abs(a.outputs).max()))
        report[solver] = dict(tol=tol, K=ks[1], max_abs_diff=diff,
                              max_abs_logit=scale)
    emit(phase="fused_vs_unfused", layers=4, dtype="float32", **report)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit(phase="device", torch=torch.__version__, cuda=torch.version.cuda,
         name=name, count=torch.cuda.device_count(), nvidia_smi=smi)
    print(smi, flush=True)

    t0 = time.perf_counter()
    libs = _build.build_all()
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries={k: os.path.relpath(v, ROOT) for k, v in libs.items()},
         ptxas={k: [l.strip() for l in v.splitlines() if "Used" in l
                    or "spill" in l] for k, v in _build.BUILD_LOG.items()})

    rows, max_err = phase_kernels(dev, memory_bandwidth(name))
    launches = phase_serve(dev)
    phase_fused_vs_unfused(dev)

    head = next(r for r in rows if r["case"] == "euler+g"
                and r["dtype"] == "bfloat16")
    emit(kernels=[dict(
        name="hyper_step", route="cuda",
        source="src/repro_torch/kernels/hyper_step/csrc/hyper_step.cu",
        replaces="src/repro/kernels/hyper_step/hyper_step.py:89",
        launches=launches, max_abs_err=max_err, ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None)])
    emit(ok=True, device=dict(platform="gpu", kind=name,
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
