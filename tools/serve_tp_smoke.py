"""Nemotron-4-340B served across four H100s of one host, deeper than one
card holds: the sharded weight draw and the tensor-parallel prefill and
decode steps of ``launch/steps.py`` over a (data 1, model 4) mesh.

    python3 tools/serve_tp_smoke.py                          # 4 cards, nccl
    python3 tools/serve_tp_smoke.py --device cpu --reduced   # 4 gloo ranks

Four processes, one per card (``torch.multiprocessing``, nccl over
``tcp://127.0.0.1`` and a free port). Every model's weights come from
``init_params_sharded`` (seed 0): each card draws only its own blocks.
The prompt is chip_smoke.py's (8 x 128, numpy ``RandomState(1)``). Three
parts:

  (a) Parity at full width, nemotron_4_340b at 2 layers (32.7 GB): rank 0
      gathers the weights (``full_tensor()``, leaf by leaf) and runs
      ``make_prefill_step(cfg, settings)``, ``lm_prefill`` and PARITY_STEPS
      steps of ``make_serve_step(cfg)`` unsharded on its card, greedy;
      then every rank runs the same over the mesh (``make_prefill_step
      (mesh=)``, ``lm_prefill`` into DTensor caches under
      ``sharded_context``, ``make_serve_step(mesh=)``), fed the one-card
      greedy tokens. Each pair of logits (the prefill step's (B, S, V),
      the prefill's last position, each decode step) gives a relative L2
      error and an argmax agreement; the worst error must lie within
      PARITY_TOL[arch]. Then one card's block of a ``wo`` (group 0's, on
      rank 1) is zeroed and the sharded runs repeated: a planted fault,
      whose worst error must lie above the limit.
  (b) The same at mistral_nemo_12b's full 40 layers (24.5 GB): its
      attention, 4,096 wide under a 5,120 stream, is cut by heads across
      the cards.
  (c) nemotron_4_340b at --layers of 96 (36 by default: 267.6 GB, 66.9
      GB a card; at 32, 239.9 GB and 60.0 GB a card, the cards kept
      19.96 GB free at their peak on four H100s, so the depth rose to
      MAX_LAYERS), drawn sharded, then a greedy generate over the mesh: ``lm_prefill``
      of the prompt, GEN - 1 serve steps, each token the argmax of the
      gathered logits. The decode's logits are held to a teacher-forced
      sharded prefill step over the prompt and the generated tokens
      within DECODE_TOL of its largest |logit| (chip_smoke.py's measure),
      and the same generate under ``chip_smoke.lost_cache_writes`` (a
      planted fault) must read above it. Per card: the draw's seconds and
      peak memory, the prefill's ms, the decode's ms a token beside the
      weight-bytes bound of the card's blocks and the cost model's decode
      cell on a (1, 1, 4) ``Mesh2D``, the peak memory, the flash launches
      of the generate (one per layer, in the prefill), and the
      collectives of one more decode step by kind (``CommDebugMode``)
      beside the dry run's count for the same step on a fake (1, 4) mesh
      (``launch/dryrun.py::run_cell``, in a process of its own on the
      host's CPU), and PROFILE_STEPS more decode steps under
      ``torch.profiler``: device kernel ms a step, the share of it in
      nccl kernels, the device's busy share of the steps' wall time and
      the top kernels. A run deepens (c) only while a shallower one left
      more than 15 GB free a card, and never past MAX_LAYERS.

Then the card's name and power limit and a last ``{"ok": true, ...}``
line. Exits non-zero without four CUDA devices (the CPU rehearsal aside)
or on any failed check; nothing falls back to a whole draw or the CPU.
"""
import argparse
import contextlib
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from repro_torch.kernels import LAUNCHES, _build  # noqa: E402

WORLD, SEED = 4, 0
B, S, GEN = 8, 128, 32
PARITY_STEPS = 8
# (a) and (b): (arch, layers; None keeps the model's own depth)
PARITY = (("nemotron_4_340b", 2), ("mistral_nemo_12b", None))
# The largest relative L2 error of the mesh's logits to one card's over a
# parity run (the prefill step, the prefill's last position, each decode
# step), between the sound reading and the planted fault's: on four
# H100s sound 8.1e-3 (Nemotron) and 2.18e-2 (Mistral-NeMo), fault 0.126
# and 0.470 (PERF.md section 6).
PARITY_TOL = {"nemotron_4_340b": 5e-2, "mistral_nemo_12b": 5e-2}
# (c)'s teacher-forced limit, a share of the largest |logit| at the worst
# generated position (chip_smoke.BF16_DECODE_TOL's measure): on four
# H100s sound 2.30e-2 at 32 layers and 2.36e-2 at 36, fault 0.211 and
# 0.203
DECODE_TOL = 5e-2
TP_LAYERS = MAX_LAYERS = 36
PROFILE_STEPS = 2
OUT = os.path.join(ROOT, "build", "serve_tp_smoke")


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    b = b.float()
    return float(torch.linalg.vector_norm(a.float() - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def agree(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.argmax(-1) == b.argmax(-1)).float().mean())


def config(arch: str, layers, reduced: bool):
    from repro_torch.configs import get
    cfg = get(arch).reduced() if reduced else get(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


class Card:
    """This rank's device, its sync and its memory readings."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.cuda = dev.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def timed(self, fn):
        """(fn(), synced seconds)."""
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        return out, time.perf_counter() - t0

    def reset_peak(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)

    def peak_gb(self):
        return torch.cuda.max_memory_allocated(self.dev) / 1e9 \
            if self.cuda else None

    def headroom_gb(self):
        """The card's memory less the peak allocated since the reset."""
        if not self.cuda:
            return None
        total = torch.cuda.get_device_properties(self.dev).total_memory
        return (total - torch.cuda.max_memory_allocated(self.dev)) / 1e9

    def release(self):
        import gc
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def local_bytes(params) -> int:
    from torch.utils import _pytree as pytree
    return sum(t.to_local().numel() * t.element_size()
               for t in pytree.tree_leaves(params))


def sharded_run(cfg, params, mesh, prompt, tokens, n_steps):
    """The mesh's prefill step logits (B, S, V), and the logits of
    ``lm_prefill`` and of one serve step per token of ``tokens`` (n, B),
    fed those tokens: all gathered, float32."""
    from repro_torch.launch import steps
    from repro_torch.models import lm
    s = steps.StepSettings()
    pre = steps.make_prefill_step(cfg, s, mesh=mesh)(
        params, {"tokens": prompt}).full_tensor()
    caches = steps.place_caches(mesh, cfg, lm.init_lm_cache(
        cfg, B, S + n_steps + 1, device=prompt.device))
    with steps.sharded_context(mesh, s, "prefill"):
        last, caches = lm.lm_prefill(params, cfg,
                                     steps.place_batch(mesh, prompt), caches)
    outs = [last.full_tensor()]
    serve = steps.make_serve_step(cfg, mesh=mesh)
    for i in range(n_steps):
        logits, caches = serve(params, tokens[i], caches, S + i)
        outs.append(logits.full_tensor())
    return pre, outs


def parity(rank, card, mesh, arch, layers, reduced):
    """Part (a)/(b): one card against the mesh, sound and under a planted
    fault. Returns the readings (rank 0's; the others' keep timings)."""
    import torch.distributed as dist
    from torch.utils import _pytree as pytree
    from repro_torch.launch import steps
    from repro_torch.models import lm
    cfg = config(arch, layers, reduced)
    card.reset_peak()
    params, draw_s = card.timed(lambda: steps.init_params_sharded(
        SEED, cfg, mesh))
    prompt = torch.as_tensor(np.random.RandomState(1).randint(
        0, cfg.vocab, size=(B, S)).astype(np.int32), device=card.dev)
    out = {"arch": arch, "layers": cfg.n_layers, "draw_s": draw_s,
           "draw_peak_gb": card.peak_gb(), "local_gb": local_bytes(params)
           / 1e9}
    # one card: rank 0 gathers the whole tree, leaf by leaf
    whole = None
    leaves, spec = pytree.tree_flatten(params)
    gathered = []
    for t in leaves:
        full = t.full_tensor()
        gathered.append(full if rank == 0 else None)
        del full
    if rank == 0:
        whole = pytree.tree_unflatten(gathered, spec)
    del gathered
    tokens = torch.zeros((PARITY_STEPS + 1, B), dtype=torch.long,
                         device=card.dev)
    if rank == 0:
        s = steps.StepSettings()
        with torch.no_grad():
            pre1 = steps.make_prefill_step(cfg, s)(whole, {"tokens": prompt})
            caches = lm.init_lm_cache(cfg, B, S + PARITY_STEPS + 1,
                                      device=card.dev)
            last, caches = lm.lm_prefill(whole, cfg, prompt, caches)
            one = [last]
            tokens[0] = last.argmax(-1)
            serve = steps.make_serve_step(cfg)
            for i in range(PARITY_STEPS):
                logits, caches = serve(whole, tokens[i], caches, S + i)
                one.append(logits)
                tokens[i + 1] = logits.argmax(-1)
        del whole, caches
    card.release()
    dist.broadcast(tokens, src=0)
    dist.barrier()

    def readings(pre, outs):
        if rank:
            return None
        errs = [rel_l2(pre, pre1)] + [rel_l2(a, b) for a, b in zip(outs, one)]
        agrees = [agree(pre, pre1)] + [agree(a, b) for a, b in zip(outs, one)]
        return {"prefill_step_rel_l2": errs[0],
                "prefill_step_argmax_agree": agrees[0],
                "prefill_last_rel_l2": errs[1],
                "decode_rel_l2": errs[2:], "decode_argmax_agree": agrees[2:],
                "max_rel_l2": max(errs), "min_argmax_agree": min(agrees)}

    with torch.no_grad():
        (pre, outs), run_s = card.timed(lambda: sharded_run(
            cfg, params, mesh, prompt, tokens, PARITY_STEPS))
        out["sound"] = readings(pre, outs)
        out["sharded_run_s"] = run_s
        del pre, outs
        # the planted fault: rank 1's heads of group 0's attention output
        if rank == 1:
            params["groups"]["b0"]["attn"]["wo"]["kernel"].to_local()[0] \
                .zero_()
        pre, outs = sharded_run(cfg, params, mesh, prompt, tokens,
                                PARITY_STEPS)
        out["fault"] = readings(pre, outs)
        del pre, outs
    out["peak_gb"] = card.peak_gb()
    if rank == 0:
        del pre1, one
    del params
    card.release()
    return out


def profiled(step, n: int, cuda: bool) -> dict:
    """``step()`` run ``n`` times under ``torch.profiler``: wall ms a step,
    device kernel ms a step (all, and in nccl kernels: an all-reduce
    kernel runs until every rank has reached it, so its time includes
    waiting for the slowest rank), the busy share (kernel time over the
    wall time), kernels a step and the top five kernels; the device
    fields are None where no kernel was recorded."""
    import collections
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        if cuda:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    us, calls = collections.Counter(), collections.Counter()
    for e in prof.events():
        # a collective's range ("nccl:all_reduce") is a device event
        # beside its kernel: a user annotation, not a kernel
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(
                e, "is_user_annotation", False) or e.name.startswith("nccl:"):
            continue
        us[e.name] += e.time_range.elapsed_us()
        calls[e.name] += 1
    device_ms = sum(us.values()) / 1e3 / n if us else None
    return dict(
        steps=n, wall_ms_per_step=wall_ms, device_kernel_ms_per_step=device_ms,
        nccl_kernel_ms_per_step=sum(v for k, v in us.items() if "nccl" in
                                    k.lower()) / 1e3 / n if us else None,
        device_busy_share=device_ms / wall_ms if us else None,
        kernels_per_step=sum(calls.values()) / n if us else None,
        top_kernels=[dict(name=k[:60], ms_per_step=v / 1e3 / n)
                     for k, v in us.most_common(5)])


def comm_counts(comm) -> dict:
    from repro_torch.launch.dryrun import _comm_counts
    return {k: v for k, v in _comm_counts(comm).items() if v}


def serve_deep(rank, card, mesh, layers, reduced, bandwidth):
    """Part (c): the sharded draw, greedy generate and teacher-forced
    check of nemotron_4_340b at ``layers`` layers."""
    from torch.distributed.tensor.debug import CommDebugMode
    import chip_smoke as cs
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.roofline.costmodel import Mesh2D, cell_cost, predicted
    from repro_torch.configs import ShapeSpec
    cfg = config("nemotron_4_340b", layers, reduced)
    s = steps.StepSettings()
    card.reset_peak()
    params, draw_s = card.timed(lambda: steps.init_params_sharded(
        SEED, cfg, mesh, s))
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "full_layers": config("nemotron_4_340b", None, reduced).n_layers,
           "draw_s": draw_s, "draw_peak_gb": card.peak_gb(),
           "local_weight_gb": local_bytes(params) / 1e9}
    prompt = torch.as_tensor(np.random.RandomState(1).randint(
        0, cfg.vocab, size=(B, S)).astype(np.int32), device=card.dev)
    serve = steps.make_serve_step(cfg, mesh=mesh)

    def generate():
        """(logits (B, GEN, V) gathered, tokens (B, GEN), prefill s,
        decode s a token)."""
        caches = steps.place_caches(mesh, cfg, lm.init_lm_cache(
            cfg, B, S + GEN + PROFILE_STEPS, device=card.dev))
        with steps.sharded_context(mesh, s, "prefill"):
            (last, caches), pre_s = card.timed(lambda: lm.lm_prefill(
                params, cfg, steps.place_batch(mesh, prompt), caches))
        logits = [last.full_tensor()]
        toks = [logits[-1].argmax(-1)]
        card.sync()
        t0 = time.perf_counter()
        for t in range(S, S + GEN - 1):
            lg, caches = serve(params, toks[-1], caches, t)
            logits.append(lg.full_tensor())
            toks.append(logits[-1].argmax(-1))
        card.sync()
        step_s = (time.perf_counter() - t0) / (GEN - 1)
        return (torch.stack(logits, 1), torch.stack(toks, 1), pre_s,
                step_s, caches)

    def teacher_forced_err(logits, toks):
        seq = torch.cat([prompt, toks[:, :-1].to(prompt.dtype)], dim=1)
        full = steps.make_prefill_step(cfg, s, mesh=mesh)(
            params, {"tokens": seq})[:, S - 1:].full_tensor()
        return float((logits - full).abs().amax() / full.abs().max())

    card.reset_peak()
    with torch.no_grad():
        LAUNCHES.clear()
        logits, toks, pre_s, step_s, caches = generate()
        launches = {k: v for k, v in LAUNCHES.items() if v}
        out["peak_gb"] = card.peak_gb()
        out["headroom_gb"] = card.headroom_gb()
        out["prefill_ms"] = pre_s * 1e3
        out["decode_ms_per_token"] = step_s * 1e3
        out["launches"] = launches
        out["finite"] = bool(torch.isfinite(logits).all())
        out["tokens_in_range"] = bool((toks >= 0).all()
                                      and (toks < cfg.vocab).all())
        out["sample"] = toks[0, :8].tolist()
        # one more decode step, its collectives counted
        comm = CommDebugMode()
        with comm:
            serve(params, toks[:, -1], caches, S + GEN - 1)
        out["decode_step_collectives"] = comm_counts(comm)
        pos = iter(range(S + GEN, S + GEN + PROFILE_STEPS))
        out["decode_profile"] = profiled(
            lambda: serve(params, toks[:, -1], caches, next(pos)),
            PROFILE_STEPS, card.cuda)
        del caches
        out["teacher_forced_rel_err"] = teacher_forced_err(logits, toks)
        del logits
        with cs.lost_cache_writes():
            f_logits, f_toks, _, _, caches = generate()
        del caches
        out["planted_fault_rel_err"] = teacher_forced_err(f_logits, f_toks)
        del f_logits
    weight_bytes = local_bytes(params)
    mesh2d = Mesh2D(1, 1, WORLD)
    cost_s, dominant = predicted(cell_cost(cfg, ShapeSpec(
        f"decode_{B}x{S + GEN}", "decode", S + GEN, B), mesh2d), mesh2d)
    out["weight_bytes_bound_ms"] = weight_bytes / bandwidth * 1e3
    out["cost_model_ms"] = cost_s * 1e3
    out["cost_model_dominant"] = dominant
    del params
    card.release()
    return out


def rank_main(rank: int, port: int, device: str, reduced: bool,
              layers: int) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.roofline.costmodel import H100

    cuda = device == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD,
                            **({"device_id": dev} if cuda else {}))
    card = Card(dev)
    out = {"rank": rank, "device": str(dev)}
    try:
        mesh = make_debug_mesh(1, WORLD, device_type=dev.type)
        for arch, n in PARITY:
            out[f"parity/{arch}"] = parity(rank, card, mesh, arch, n,
                                           reduced)
            dist.barrier()
        out["deep"] = serve_deep(rank, card, mesh, layers, reduced,
                                 H100.hbm_bw)
        dist.barrier()
    finally:
        with open(os.path.join(OUT, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()


_DRYRUN = """
import json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.steps import StepSettings
sys.path.insert(0, {tools!r})
from serve_tp_smoke import config
cfg = config("nemotron_4_340b", {layers}, {reduced})
with dryrun.fake_world({world}):
    mesh = init_device_mesh("cpu", (1, {world}),
                            mesh_dim_names=("data", "model"))
    res = dryrun.run_cell(cfg.name, None, False, StepSettings(),
                          verbose=False, mesh=mesh, cfg=cfg,
                          shape=ShapeSpec("decode_{b}x{n}", "decode", {n},
                                          {b}))
print(json.dumps(res))
"""


def dry_run(layers: int, reduced: bool) -> subprocess.Popen:
    """The dry run's decode step of (c)'s model on a fake (1, WORLD) mesh,
    in a process of its own (the fake group is process-global)."""
    code = _DRYRUN.format(tools=os.path.join(ROOT, "tools"), layers=layers,
                          reduced=reduced, world=WORLD, b=B, n=S + GEN)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=ROOT)


def check(results, dry) -> None:
    """Raises on any failed check of the four ranks' results."""
    r0 = results[0]
    for arch, _ in PARITY:
        got = r0[f"parity/{arch}"]
        sound, fault = got["sound"]["max_rel_l2"], got["fault"]["max_rel_l2"]
        if not sound <= PARITY_TOL[arch] < fault:
            raise AssertionError(
                f"{arch}: mesh against one card {sound}, planted fault "
                f"{fault}, limit {PARITY_TOL[arch]}")
    deep = r0["deep"]
    if not deep["teacher_forced_rel_err"] <= DECODE_TOL \
            < deep["planted_fault_rel_err"]:
        raise AssertionError(f"deep decode: {deep['teacher_forced_rel_err']}"
                             f", planted fault "
                             f"{deep['planted_fault_rel_err']}, limit "
                             f"{DECODE_TOL}")
    for r in results:
        d = r["deep"]
        if not (d["finite"] and d["tokens_in_range"]):
            raise AssertionError(f"rank {r['rank']}: logits or tokens off")
        if d["sample"] != deep["sample"]:
            raise AssertionError("ranks disagree on the tokens")
        if r["device"].startswith("cuda") and \
                d["launches"].get("flash_attention") != d["layers"]:
            raise AssertionError(f"rank {r['rank']}: flash launches "
                                 f"{d['launches']}, {d['layers']} layers")
    if dry.get("status") != "OK":
        raise AssertionError(f"dry run: {dry}")


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=TP_LAYERS,
                    help=f"(c)'s depth (at most {MAX_LAYERS})")
    args = ap.parse_args()
    if args.layers > MAX_LAYERS:
        ap.error(f"--layers {args.layers} > {MAX_LAYERS}")
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
            print(f"serve_tp_smoke: needs {WORLD} CUDA devices",
                  file=sys.stderr)
            return 2
        t0 = time.perf_counter()
        _build.build_all()
        print(json.dumps({"phase": "build",
                          "seconds": time.perf_counter() - t0}), flush=True)
    os.makedirs(OUT, exist_ok=True)
    for r in range(WORLD):
        with contextlib.suppress(FileNotFoundError):
            os.remove(os.path.join(OUT, f"rank{r}.json"))
    import torch.multiprocessing as mp
    dry_proc = dry_run(args.layers, args.reduced)
    t0 = time.perf_counter()
    mp.spawn(rank_main, args=(free_port(), args.device, args.reduced,
                              args.layers), nprocs=WORLD)
    seconds = time.perf_counter() - t0
    dry_out, dry_err = dry_proc.communicate(timeout=1800)
    try:
        dry = json.loads(dry_out.strip().splitlines()[-1])
    except (IndexError, ValueError):
        dry = {"status": "FAIL", "error": dry_err[-3000:]}
    results = []
    for r in range(WORLD):
        with open(os.path.join(OUT, f"rank{r}.json")) as f:
            results.append(json.load(f))
    for r in results:
        print(json.dumps({"phase": "serve_tp_card", **r}), flush=True)
    print(json.dumps({"phase": "serve_tp_dryrun", "mesh": [1, WORLD],
                      "status": dry.get("status"),
                      "collective_counts": dry.get("collective_counts"),
                      "trace_s": dry.get("trace_s")}), flush=True)
    check(results, dry)
    print(json.dumps({"phase": "serve_tp", "reduced": args.reduced,
                      "mesh": [1, WORLD], "layers": args.layers,
                      "parity_tol": PARITY_TOL, "decode_tol": DECODE_TOL,
                      "seconds": seconds}), flush=True)
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        print("\n".join(smi))
        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu" if args.device == "cuda" else "cpu",
        "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
