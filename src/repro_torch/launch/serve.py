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
``rwkv6_1p6b``, ``olmoe_1b_7b``; ``llama4_maverick_400b_a17b`` reduced,
as its full width fits no single card).

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

--inflight swaps the drain engine for the continuous-batching slot-pool
scheduler (``launch/scheduler.py``): ``--slots`` slots advance ``--seg``
depth steps per scheduling round, finished requests retire and refill
between segments. ``--arrival-trace poisson|bursty`` replays a seeded
arrival trace (``--arrival-rate`` requests per cost unit) and prints the
``[inflight <trace>]`` latency line (``launch/workload.py``); ``none``
submits the whole batch at once. ``--mesh N`` splits the slot pool over
N devices (``launch/mesh.py::make_serving_mesh``: ``cuda:0 .. cuda:N-1``,
or N CPU entries with ``--device cpu``): ``--slots`` is the global pool
width, a multiple of N, under one admission queue.

``--cost-oracle`` picks the virtual clock both serving loops stamp
(``launch/oracle.py``): ``sequential`` (default) counts sequential field
evaluations; ``roofline`` prices every probe, segment, solve and flow
eval of the served ``--arch`` at the prompt's context in predicted
device microseconds on the H100 record (``roofline/costmodel.py``), so
latency, queue wait, throughput and ``--deadline`` are in ``device_us``
and ``--arrival-rate`` is per device-us. The clock moves no K, nfe,
status or output. ``--overlap`` runs the pipelined loop
(uid-for-uid identical completions). Request hardening: ``--deadline``
(virtual-clock slack), ``--queue-cap`` with ``--overload-policy``
(shed/degrade/block), and ``--progress-every N`` prints a progress line
every N ticks. A first SIGTERM/SIGINT stops admission and lets the
in-flight slots drain; a second one gives up the drain.

``--flow-ckpt`` (a flow head the port or the JAX package saved, e.g.
through ``core/train.py::train_flowhead`` and ``CheckpointManager``) with
``--flow-threshold`` adds the K=0 flow tier on top of ``--multirate``:
requests whose probe error is at most threshold × tol are served by the
learned solution operator in one net eval (``core/flowhead.py``); a
non-finite flow eval escalates into the K-bucket ladder
(``status=escalated``).

``--refine`` (with ``--inflight``) attaches the online refinery
(``launch/refinery.py``): serving captures residual rows into a bounded
ledger (``--capture-rate``, ``--ledger-cap``), a candidate correction
fits between scheduler ticks (``--refine-steps`` a tick, checkpointed
to ``--refine-dir``, which ``--g-ckpt`` restores on a later run), and
every ``--shadow-every`` candidate steps a shadow scorer replays
held-out prompts and hot-swaps the candidate in only on
non-regression. The progress line then carries the ledger fill, the
candidate step and the promotions; a graceful drain flushes the ledger
(``--ledger-out``) and waits for a pending candidate checkpoint.

``--profile-dir DIR`` wraps the serving loop of every mode (decode,
drain, in-flight) in ``torch.profiler`` (CPU activity, and CUDA on a
card) and writes a Chrome trace, ``DIR/serve.pt.trace.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import signal
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get
from repro_torch.launch.engine import (EngineConfig, MultiRateEngine,
                                       greedy_generate, lm_depth_model,
                                       load_flow_params, load_g_params)
from repro_torch.launch.oracle import make_oracle
from repro_torch.models.lm import (discrete_nfe, group_layout, init_lm,
                                   lm_forward)

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
    ap.add_argument("--flow-ckpt", default=None,
                    help="checkpoint dir of a trained K=0 flow head "
                         "(core/flowhead.py); requires --flow-threshold")
    ap.add_argument("--flow-rank", type=int, default=64,
                    help="rank of the flow-head checkpoint being restored")
    ap.add_argument("--flow-threshold", type=float, default=0.0,
                    help="route requests whose probe error is below this "
                         "fraction of --tol to the K=0 flow tier (one net "
                         "eval, no solver; --multirate only). 0 disables "
                         "the tier; flow evals that come back non-finite "
                         "escalate into the K-bucket ladder "
                         "(status='escalated')")
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
    ap.add_argument("--inflight", action="store_true",
                    help="serve through the in-flight slot-pool scheduler "
                         "(launch/scheduler.py) instead of the drain engine")
    ap.add_argument("--seg", type=int, default=2,
                    help="depth steps per scheduling segment (--inflight)")
    ap.add_argument("--slots", type=int, default=4,
                    help="slot-pool width per request shape (--inflight)")
    ap.add_argument("--arrival-trace", default="none",
                    choices=["none", "poisson", "bursty"],
                    help="replay a seeded streaming arrival trace through "
                         "the scheduler (--inflight only)")
    ap.add_argument("--arrival-rate", type=float, default=0.25,
                    help="poisson arrival rate / bursty burst pacing, in "
                         "requests per virtual cost unit")
    ap.add_argument("--mesh", type=int, default=0,
                    help="split the slot pool over N devices (--inflight "
                         "only): --slots is the GLOBAL pool width and must "
                         "be a multiple of N; with --device cpu the mesh "
                         "has N CPU entries")
    ap.add_argument("--cost-oracle", default="sequential",
                    choices=["sequential", "roofline"],
                    help="virtual-clock pricing (launch/oracle.py): "
                         "'sequential' counts sequential field evals "
                         "(batch-width free); 'roofline' prices probes, "
                         "segments and solves of the served --arch in "
                         "predicted device-us on the H100 record "
                         "(roofline/costmodel.py)")
    ap.add_argument("--overlap", action="store_true",
                    help="pipelined in-flight loop (--inflight only): "
                         "launch segment N+1 before reading segment N's "
                         "retire metadata; completions are uid-for-uid "
                         "identical to the synchronous loop")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="per-request deadline slack on the virtual clock "
                         "(--inflight only): a request not finished within "
                         "this many cost units of its arrival is dropped or "
                         "evicted with status='deadline'; 0 = none")
    ap.add_argument("--queue-cap", type=int, default=0,
                    help="bound the admission queue at this many waiting "
                         "requests (--inflight only); 0 = unbounded")
    ap.add_argument("--overload-policy", default="shed",
                    choices=["shed", "degrade", "block"],
                    help="what an over-cap submit does (--queue-cap): "
                         "'shed' refuses terminally (status='shed'), "
                         "'degrade' admits one K-bucket coarser under "
                         "pressure, 'block' raises to the caller")
    ap.add_argument("--profile-dir", default=None,
                    help="wrap the serving loop in torch.profiler and write "
                         "a Chrome trace (serve.pt.trace.json) here")
    ap.add_argument("--refine", action="store_true",
                    help="attach the online refinery (--inflight only): "
                         "capture serving-time residuals into a ledger, "
                         "fit a candidate correction between scheduler "
                         "ticks, shadow-score it on held-out prompts and "
                         "hot-swap it in only on non-regression "
                         "(launch/refinery.py). The shadow prompts are "
                         "drawn by numpy's RandomState(seed + 1000), not "
                         "the reference's jax.random draw")
    ap.add_argument("--refine-dir", default=None,
                    help="checkpoint directory for async candidate "
                         "checkpoints (--refine); restorable via --g-ckpt "
                         "on a later run")
    ap.add_argument("--capture-rate", type=float, default=1.0,
                    help="fraction of capture events the residual ledger "
                         "keeps (--refine); 0 disables capture entirely")
    ap.add_argument("--ledger-cap", type=int, default=512,
                    help="residual-ledger reservoir capacity in samples "
                         "(--refine)")
    ap.add_argument("--refine-steps", type=int, default=2,
                    help="candidate fit steps per scheduler tick "
                         "(--refine)")
    ap.add_argument("--shadow-every", type=int, default=50,
                    help="candidate steps between shadow-gate evaluations "
                         "(--refine)")
    ap.add_argument("--ledger-out", default=None,
                    help="flush the residual ledger to this .npz on exit "
                         "or graceful drain (--refine)")
    ap.add_argument("--progress-every", type=int, default=0,
                    help="print a progress line every N scheduler ticks "
                         "(--inflight): hardening counters, plus the flow "
                         "tier's and the refinery's state; 0 = off")
    return ap


def _check_flags(args) -> None:
    """The reference CLI's flag checks: a knob of the scheduler, the
    refinery or the flow tier without what it needs exits with the
    reference's message."""
    if args.mesh and not args.inflight:
        raise SystemExit("--mesh shards the in-flight slot pool; pass "
                         "--inflight with it (the drain engine has no "
                         "slot pool to shard)")
    if args.overlap and not args.inflight:
        raise SystemExit("--overlap pipelines the in-flight segment loop; "
                         "pass --inflight with it (the drain engine has "
                         "no segment loop to overlap)")
    if (args.deadline or args.queue_cap) and not args.inflight:
        raise SystemExit("--deadline/--queue-cap harden the in-flight "
                         "scheduler's admission; pass --inflight with "
                         "them")
    if args.overload_policy != "shed" and not args.queue_cap:
        raise SystemExit(f"--overload-policy {args.overload_policy} is "
                         "meaningless without --queue-cap (an unbounded "
                         "queue never overloads)")
    if args.refine and not args.inflight:
        raise SystemExit("--refine interleaves with the in-flight "
                         "scheduler's ticks; pass --inflight with it")
    if args.refine and args.solver == "discrete":
        raise SystemExit("--refine fits a hypersolver correction; pass a "
                         "continuous --solver (e.g. euler/hyper_euler)")
    if not args.refine and (
            args.refine_dir or args.ledger_out
            or args.capture_rate != 1.0 or args.ledger_cap != 512
            or args.refine_steps != 2 or args.shadow_every != 50):
        raise SystemExit("--refine-dir/--capture-rate/--ledger-cap/"
                         "--refine-steps/--shadow-every/--ledger-out "
                         "tune the online refinery; pass --refine with "
                         "them (a silently ignored knob would mislabel "
                         "the run)")
    if args.progress_every and not args.inflight:
        raise SystemExit("--progress-every reports the in-flight "
                         "scheduler's tick counters; pass --inflight "
                         "with it")
    if args.flow_threshold and not args.multirate:
        raise SystemExit("--flow-threshold routes off the multi-rate "
                         "admission probe; pass --multirate with it "
                         "(fixed-K serving has no probe to route from)")
    if args.flow_threshold and not args.flow_ckpt:
        raise SystemExit("--flow-threshold needs --flow-ckpt (a trained "
                         "flow head): a fresh zero-init head is exactly "
                         "one full-span Euler step, which would mislabel "
                         "the K=0 tier's numbers")
    if args.flow_ckpt and not args.flow_threshold:
        raise SystemExit("--flow-ckpt is only read by the flow tier; "
                         "pass --flow-threshold > 0 with it")


@contextlib.contextmanager
def _profiled(profile_dir: Optional[str], device: torch.device):
    """``torch.profiler`` around the serving loop when --profile-dir is set
    (CPU activity, and CUDA on a card); writes
    ``profile_dir/serve.pt.trace.json`` when the loop ends."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir,
                                          "serve.pt.trace.json"))


@contextlib.contextmanager
def _graceful_drain():
    """A first SIGTERM/SIGINT sets the yielded flag (admission stops, the
    in-flight slots drain); a second raises KeyboardInterrupt. Installed
    only on the main thread; the previous handlers come back on exit."""
    draining = [False]
    if threading.current_thread() is not threading.main_thread():
        yield draining
        return

    def on_signal(signum, frame):
        if draining[0]:
            raise KeyboardInterrupt  # second signal: give up the drain
        draining[0] = True
        print(f"[serve] caught signal {signum}: admission stopped, "
              "draining in-flight slots", flush=True)

    prev = {sig: signal.signal(sig, on_signal)
            for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        yield draining
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve_inflight(args, sched, prompt, device, refinery=None):
    """Drive the scheduler over the prompt rows: all at once, or replayed
    on a seeded arrival trace (and tick by tick when a progress line or
    the refinery asks for it). Returns (records in uid order, the trace
    report or None, wall seconds, whether a signal drained the run)."""
    from repro_torch.launch.workload import (
        Arrival, bursty_trace, latency_stats, poisson_trace,
        replay_scheduler)

    def on_tick(s):
        if refinery is not None:
            refinery.tick([s])
        if args.progress_every and s.ticks % args.progress_every == 0:
            parts = [f"t={s.now:.1f}", f"ticks={s.ticks}",
                     f"inflight={len(s)}",
                     f"quarantined={s.total_quarantined}",
                     f"deadline_evicted={s.total_deadline_evicted}",
                     f"requeued={s.total_requeued}", f"shed={s.total_shed}"]
            if args.flow_threshold:
                parts += [f"flow={s.total_flow_served}",
                          f"escalated={s.total_escalated}"]
            if refinery is not None:
                st = refinery.status()
                parts += [f"ledger={st['ledger_fill']}/"
                          f"{refinery.ledger.capacity}",
                          f"cand_step={st['candidate_step']}",
                          f"promotions={st['promotions']}",
                          f"last_promotion={st['last_promotion']}"]
            print("[progress] " + " ".join(parts), flush=True)

    report = None
    with _graceful_drain() as draining, \
            _profiled(args.profile_dir, device):
        _synchronize(device)
        t0 = time.perf_counter()
        if args.arrival_trace == "none" and refinery is None \
                and not args.progress_every:
            results = sched.run(prompt)
        else:
            if args.arrival_trace == "none":
                trace = [Arrival(t=0.0, x=row) for row in prompt]
            elif args.arrival_trace == "poisson":
                trace = poisson_trace(prompt, rate=args.arrival_rate,
                                      seed=args.seed)
            else:
                trace = bursty_trace(prompt, burst=args.slots,
                                     gap=args.slots / args.arrival_rate,
                                     seed=args.seed)
            report = replay_scheduler(
                sched, trace, on_tick=on_tick,
                should_admit=lambda: not draining[0])
            # uid is submission order = prompt-row order
            results = sorted(report.records, key=lambda r: r.uid)
            if args.arrival_trace != "none":
                print(f"[inflight {args.arrival_trace}] "
                      f"{latency_stats(report)}")
        _synchronize(device)
        dt = time.perf_counter() - t0
    return results, report, dt, draining[0]


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the CLI; returns what it served (params, prompt and timings,
    with the tokens of the discrete path, or the engine or scheduler and
    the results of a solver) for programmatic callers."""
    args = build_parser().parse_args(argv)
    _check_flags(args)
    device = resolve_device(args.device)
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_serving_mesh
        try:
            mesh = make_serving_mesh(args.mesh, device=args.device)
        except ValueError as e:
            raise SystemExit(str(e)) from e

    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_lm(gen, cfg, device=device)
    prompt = np.random.RandomState(1).randint(
        0, cfg.vocab, size=(args.batch, args.prompt_len)).astype(np.int32)

    if args.solver == "discrete":
        with torch.no_grad(), _profiled(args.profile_dir, device):
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
    if args.solver.startswith("hyper_") and g_params is None \
            and not args.refine:
        raise SystemExit(f"--solver {args.solver} needs --g-ckpt "
                         "(a trained correction checkpoint) — or "
                         "--refine to fit one from live traffic, "
                         "starting at a zero correction")
    flow_params = None
    if args.flow_ckpt:
        flow_params = load_flow_params(args.flow_ckpt, cfg,
                                       rank=args.flow_rank, device=device)
    if args.inflight and args.arrival_trace != "none" \
            and args.arrival_rate <= 0:
        raise SystemExit("--arrival-rate must be > 0 for "
                         f"--arrival-trace {args.arrival_trace}")

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
        flow_threshold=args.flow_threshold,
    )
    # a mesh of several devices serves a loaded correction on the
    # parametric path: each device gets its own copy of its params
    spread = mesh is not None and len(set(mesh.devices)) > 1
    model = lm_depth_model(params, cfg, solver=args.solver,
                           g_params=g_params, fused=args.fused,
                           refinable=args.refine or (
                               spread and g_params is not None),
                           rank=args.g_rank, flow_params=flow_params)
    mode = "multirate" if args.multirate else f"K={K_fixed}"
    # the roofline clock prices the served arch at the prompt's context;
    # reported latency and wait switch to its unit (device-us) with it
    oracle = make_oracle(args.cost_oracle, cfg, ctx=args.prompt_len)

    with torch.no_grad():
        full, _ = lm_forward(params, cfg, torch.as_tensor(prompt,
                                                          device=device))
        full_top = full.argmax(-1).cpu().numpy()
        del full

    if args.inflight:
        from repro_torch.launch.scheduler import InflightScheduler
        ledger = refinery = None
        if args.refine:
            from repro_torch.launch.refinery import (Refinery,
                                                     RefineryConfig,
                                                     ResidualLedger)
            ledger = ResidualLedger(model, capacity=args.ledger_cap,
                                    capture_rate=args.capture_rate,
                                    seed=args.seed)
        sched = InflightScheduler(model, ecfg, slots=args.slots,
                                  seg=args.seg, mesh=mesh,
                                  overlap=args.overlap,
                                  deadline=args.deadline or None,
                                  queue_cap=args.queue_cap or None,
                                  overload_policy=args.overload_policy,
                                  ledger=ledger, oracle=oracle)
        if args.refine:
            # held-out seeded prompts the live trace never serves: the
            # shadow gate's replay set
            shadow = np.random.RandomState(args.seed + 1000).randint(
                0, cfg.vocab, size=(max(2, min(args.max_batch, 4)),
                                    args.prompt_len)).astype(np.int32)
            with torch.no_grad():
                refinery = Refinery(
                    model, ledger,
                    RefineryConfig(steps_per_tick=args.refine_steps,
                                   shadow_every=args.shadow_every,
                                   min_fill=min(32, args.ledger_cap),
                                   ref_K=max(n_groups, max(buckets)),
                                   seed=args.seed),
                    ecfg=ecfg, shadow_xs=shadow, ckpt_dir=args.refine_dir)
        results, report, dt, drained = _serve_inflight(args, sched, prompt,
                                                       device, refinery)
        if drained:
            print(f"[serve] drained: {len(results)} completions flushed, "
                  f"{len(prompt) - len(results)} arrivals never admitted")
        if refinery is not None:
            refinery.flush()   # a pending async candidate checkpoint
            print(f"[refinery] {refinery.status()}")
        if ledger is not None and args.ledger_out:
            n_rows = ledger.flush(args.ledger_out)
            print(f"[ledger] flushed {n_rows} residual rows -> "
                  f"{args.ledger_out}")
        # shed and expired requests carry no outputs: agreement is over
        # the requests actually served (their status says why)
        agree = {r.uid: float(np.mean(np.argmax(r.outputs, -1)
                                      == full_top[r.uid - 1]))
                 for r in results if r.outputs is not None}
        nfes = [r.nfe for r in results if r.outputs is not None]
        where = device if mesh is None else \
            f"mesh of {mesh.size}: " + ",".join(map(str, mesh.devices))
        print(f"[{args.solver} {mode} inflight slots={args.slots} "
              f"seg={args.seg} {where}] scored {len(agree)}/{args.batch} "
              f"of {args.batch}x{args.prompt_len} in {dt:.3f}s; mean NFE "
              f"{np.mean(nfes) if nfes else 0.0:.2f}/{n_groups} (probe "
              f"{sched.probe_nfe}); mean argmax agreement vs full depth: "
              f"{np.mean(list(agree.values())) if agree else 0.0:.3f}")
        for r in results:
            a = f"{agree[r.uid]:.3f}" if r.uid in agree else "-"
            print(f"  req {r.uid}: K={r.K} nfe={r.nfe} agree={a} "
                  f"wait={r.queue_wait:.1f} lat={r.latency:.1f} "
                  f"status={r.status}")
        return dict(cfg=cfg, params=params, prompt=prompt, sched=sched,
                    results=results, report=report, agree=agree,
                    full_top=full_top, seconds=dt, device=device,
                    refinery=refinery, ledger=ledger)

    engine = MultiRateEngine(model, ecfg, oracle=oracle)
    with torch.no_grad(), _profiled(args.profile_dir, device):
        _synchronize(device)
        t0 = time.perf_counter()
        results = engine.run(prompt)
        _synchronize(device)
        dt = time.perf_counter() - t0
    agree = [float(np.mean(np.argmax(r.outputs, -1) == full_top[i]))
             for i, r in enumerate(results)]
    nfes = [r.nfe for r in results]
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
