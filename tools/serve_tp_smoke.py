"""Models served across four H100s of one host, deeper than one card
holds: the sharded weight draw and the tensor-parallel prefill and
decode steps of ``launch/steps.py`` over a (data 1, model 4) mesh, for
Nemotron-4-340B (dense, the default) or Llama-4 Maverick (a mixture of
experts, ``--arch llama4_maverick_400b_a17b``: each card holds 32 of
each MoE layer's 128 experts).

    python3 tools/serve_tp_smoke.py                          # 4 cards, nccl
    python3 tools/serve_tp_smoke.py --device cpu --reduced   # 4 gloo ranks
    python3 tools/serve_tp_smoke.py --arch llama4_maverick_400b_a17b
    python3 tools/serve_tp_smoke.py --arch llama4_maverick_400b_a17b \
        --device cpu --reduced --layers 4                    # its rehearsal

Four processes, one per card (``torch.multiprocessing``, nccl over
``tcp://127.0.0.1`` and a free port). Every model's weights come from
``init_params_sharded`` (seed 0): each card draws only its own blocks.
The prompt is chip_smoke.py's (8 x 128, numpy ``RandomState(1)``; more
prompt seeds with ``--seeds``). Nemotron's run has three parts:

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

Maverick's run has two, each MoE block routing every token on every card
and running the card's own experts (``nn/moe.py::_dispatch_sharded``),
the combine one all-reduce of their partial sum:

  (d) Parity at 2 layers (one (dense, moe) group, 37.1 GB), as (a): the
      one-card steps on rank 0 against the mesh's, fed the one-card
      greedy tokens, for each prompt seed. Every dispatch's routing is
      recorded on both sides (``chip_smoke.routed_experts``: each token's
      expert, or a drop past capacity): the share of (token, MoE layer)
      top-1 experts equal on both sides, and each logits pair's relative
      L2 error over all rows and over the rows whose routing agrees at
      every MoE layer (a flipped expert, from bf16 partial sums reduced
      in another order at a near-tie, moves a token's whole expert
      output). MOE_PARITY_STAT's reading must lie within MOE_PARITY_TOL
      and the share of agreeing rows above MOE_AGREE_FLOOR. The top-1
      indices of every dispatch are gathered from the four ranks, which
      must route every token alike. The planted fault is
      ``chip_smoke.dropped_combine`` (the combine's all-reduce skipped:
      each card keeps its own experts' share), read above the limit.
  (e) The deep generate at --layers of 48 (18 by default: 300.9 GB, 75.2
      GB a card; at 16, 267.9 GB and 67.0 GB a card, the cards kept 16.45
      GB free at their peak on four H100s, more than the 8.24 GB two more
      layers take and a 5 GB margin, so the depth rose to MOE_MAX_LAYERS),
      as (c): drawn sharded, ``lm_prefill`` and GEN - 1 serve steps,
      tokens equal on the four ranks. The decode's logits are held to a
      teacher-forced run of the same function, ``lm_prefill``'s stack over
      the prompt and the generated tokens (each position routed as a
      decode step) with every position read out: the sharded prefill step
      routes all B·S tokens at once at the training capacity, another
      function wherever a slot drops (its reading is printed beside,
      unchecked). Per generated position the error is chip_smoke.py's
      share of the largest |logit|; the median position's
      (MOE_DECODE_STAT) must lie within MOE_DECODE_TOL, and under
      ``lost_cache_writes`` above it. Printed per card as (c), with two
      decode bounds: every local weight byte (a decode step multiplies
      every local expert's stack) and the cost model's active-parameter
      cell.

The routing recorder runs each router a second time, so (d)'s and (e)'s
times, launches, peaks, collectives and profile come from a run with the
recorder off; the recorded runs that follow feed the checks.
``--reduced`` prints (d)'s and (e)'s readings without holding their
limits (they are full width's in bf16; the structural checks still
raise).
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
# Llama-4 Maverick: (d) at MOE_PARITY_LAYERS, (e) at MOE_LAYERS of 48
# (18: 75.2 GB a card; 20 would be 83.5 GB)
MOE_ARCH = "llama4_maverick_400b_a17b"
MOE_PARITY_LAYERS, MOE_LAYERS = 2, 18
MOE_MAX_LAYERS = MOE_LAYERS
# (d)'s limit: the worst relative L2 error of the mesh's logits to one
# card's over the rows whose routing agrees at every MoE layer, and the
# least share of such rows. On four H100s over prompt seeds 1-3 (PERF.md
# section 6): sound 7.24e-3-7.29e-3 with 0.989-0.998 of the rows
# agreeing, the planted fault 0.312-0.315; over all rows the sound runs
# read up to 0.179 (a decode step with one flipped token) against the
# fault's 0.312, too close to hold.
MOE_PARITY_STAT = "max_rel_l2_agreeing"
MOE_PARITY_TOL, MOE_AGREE_FLOOR = 5e-2, 0.95
# (e)'s: the teacher-forced error at the median generated position
# (``position_stats``' "median"). On four H100s over seeds 1-3 at 16 and
# 18 layers: sound 0.0251-0.0378, fault 0.228-0.312; the worst position
# (printed) sound 0.655-0.783 against fault 0.743-0.828 (flipped
# experts); the worst position whose routing agrees with the
# teacher-forced run's at every MoE layer (printed) sound 0.040-0.053
# over 0.69-0.80 of the positions, fault 0.129-0.153.
MOE_DECODE_STAT, MOE_DECODE_TOL = "median", 0.1
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


def prompt_of(cfg, seed: int, dev) -> torch.Tensor:
    """chip_smoke.py's prompt (seed 1) or another seed's: 8 x 128 token
    ids from numpy's ``RandomState``."""
    return torch.as_tensor(np.random.RandomState(seed).randint(
        0, cfg.vocab, size=(B, S)).astype(np.int32), device=dev)


def routes(cfg, record=True):
    """``chip_smoke.routed_experts`` for a MoE model, else (or with
    ``record`` off) a context that records nothing."""
    import chip_smoke as cs
    return cs.routed_experts() if cfg.n_experts and record else \
        contextlib.nullcontext([])


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


def decode_bounds(cfg, params, bandwidth) -> dict:
    """A decode token's two bounds on one card: its blocks' bytes over the
    memory rate (each read once a step; a MoE step multiplies every local
    expert's stack), and the cost model's decode cell on a (1, 1, WORLD)
    ``Mesh2D`` (active parameters)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.roofline.costmodel import Mesh2D, cell_cost, predicted
    mesh2d = Mesh2D(1, 1, WORLD)
    cost_s, dominant = predicted(cell_cost(cfg, ShapeSpec(
        f"decode_{B}x{S + GEN}", "decode", S + GEN, B), mesh2d), mesh2d)
    return {"weight_bytes_bound_ms": local_bytes(params) / bandwidth * 1e3,
            "cost_model_ms": cost_s * 1e3, "cost_model_dominant": dominant}


def ranks_alike(t: torch.Tensor) -> bool:
    """Whether ``t`` (a plain tensor of one shape on every rank) holds the
    same values on every rank: all of them gathered."""
    import torch.distributed as dist
    every = [torch.empty_like(t) for _ in range(WORLD)]
    dist.all_gather(every, t.contiguous())
    return all(torch.equal(e, every[0]) for e in every)


def routing_tensor(calls) -> torch.Tensor:
    """Every recorded dispatch's routing, flat, in call order."""
    flat = [r["routed"].flatten() for call in calls for r in call]
    return torch.cat(flat) if flat else torch.zeros(0, dtype=torch.long)


def one_card_run(cfg, whole, prompt, tokens, n_steps):
    """The unsharded steps on one card: the prefill step's logits (B, S,
    V), ``lm_prefill``'s last position and ``n_steps`` greedy serve steps,
    the greedy tokens written into ``tokens`` (n + 1, B); returns (logits
    list, routing records a call)."""
    from repro_torch.launch import steps
    from repro_torch.models import lm
    s = steps.StepSettings()
    calls = []
    with torch.no_grad():
        with routes(cfg) as r:
            outs = [steps.make_prefill_step(cfg, s)(whole,
                                                    {"tokens": prompt})]
        calls.append(r)
        caches = lm.init_lm_cache(cfg, B, S + n_steps + 1,
                                  device=prompt.device)
        with routes(cfg) as r:
            last, caches = lm.lm_prefill(whole, cfg, prompt, caches)
        calls.append(r)
        outs.append(last)
        tokens[0] = last.argmax(-1)
        serve = steps.make_serve_step(cfg)
        for i in range(n_steps):
            with routes(cfg) as r:
                logits, caches = serve(whole, tokens[i], caches, S + i)
            calls.append(r)
            outs.append(logits)
            tokens[i + 1] = logits.argmax(-1)
    return outs, calls


def sharded_run(cfg, params, mesh, prompt, tokens, n_steps, card,
                record=True):
    """The mesh's prefill step logits (B, S, V), and the logits of
    ``lm_prefill`` and of one serve step per token of ``tokens`` (n, B),
    fed those tokens: all gathered, float32; with the routing records of
    each call (none with ``record`` off) and the serve steps' synced
    seconds a step."""
    from repro_torch.launch import steps
    from repro_torch.models import lm
    s = steps.StepSettings()
    calls = []
    with routes(cfg, record) as r:
        outs = [steps.make_prefill_step(cfg, s, mesh=mesh)(
            params, {"tokens": prompt}).full_tensor()]
    calls.append(r)
    caches = steps.place_caches(mesh, cfg, lm.init_lm_cache(
        cfg, B, S + n_steps + 1, device=prompt.device))
    with routes(cfg, record) as r, \
            steps.sharded_context(mesh, s, "prefill"):
        last, caches = lm.lm_prefill(params, cfg,
                                     steps.place_batch(mesh, prompt), caches)
    calls.append(r)
    outs.append(last.full_tensor())
    serve = steps.make_serve_step(cfg, mesh=mesh)
    card.sync()
    t0 = time.perf_counter()
    for i in range(n_steps):
        with routes(cfg, record) as r:
            logits, caches = serve(params, tokens[i], caches, S + i)
        calls.append(r)
        outs.append(logits.full_tensor())
    card.sync()
    return outs, calls, (time.perf_counter() - t0) / n_steps


def row_agreement(one, mesh_calls):
    """For each call, the (rows,) mask of output rows whose routing (each
    token's expert, or its drop) is the same on both sides at every MoE
    layer: the prefill step's (B, S) tokens, the prefill's last position,
    each serve step's token; and the share of (token, MoE layer) top-1
    experts equal on both sides."""
    masks, same, total = [], 0, 0
    for i, (a, b) in enumerate(zip(one, mesh_calls)):
        m = torch.ones(a[0]["routed"].shape, dtype=torch.bool,
                       device=a[0]["routed"].device)
        for ra, rb in zip(a, b):
            m &= ra["routed"] == rb["routed"]
            same += int((ra["expert"] == rb["expert"]).sum())
            total += ra["expert"].numel()
        masks.append(m if i == 0 else m[:, -1])
    return masks, same / max(total, 1)


def readings(outs, ref, masks=None, top1_share=None) -> dict:
    """The mesh's logits ``outs`` against one card's ``ref`` (the prefill
    step, the prefill's last position, each decode step): relative L2
    errors and argmax agreements, and with ``masks`` (``row_agreement``)
    the same errors over the rows whose routing agrees."""
    errs = [rel_l2(a, b) for a, b in zip(outs, ref)]
    agrees = [agree(a, b) for a, b in zip(outs, ref)]
    out = {"prefill_step_rel_l2": errs[0],
           "prefill_step_argmax_agree": agrees[0],
           "prefill_last_rel_l2": errs[1],
           "decode_rel_l2": errs[2:], "decode_argmax_agree": agrees[2:],
           "max_rel_l2": max(errs), "min_argmax_agree": min(agrees)}
    if masks is None:
        return out
    errs_in = [rel_l2(a[m], b[m]) if bool(m.any()) else None
               for a, b, m in zip(outs, ref, masks)]
    rows = sum(int(m.sum()) for m in masks)
    out.update(rel_l2_agreeing=errs_in,
               max_rel_l2_agreeing=max(e for e in errs_in if e is not None),
               agreeing_row_share=rows / sum(m.numel() for m in masks),
               top1_equal_share=top1_share)
    return out


def parity(rank, card, mesh, arch, layers, reduced, seeds, bandwidth):
    """Parts (a), (b) and (d): one card against the mesh for each prompt
    seed, sound and under a planted fault. Returns the readings (rank
    0's; the others' keep timings)."""
    import torch.distributed as dist
    from torch.utils import _pytree as pytree
    import chip_smoke as cs
    from repro_torch.launch import steps
    cfg = config(arch, layers, reduced)
    moe = bool(cfg.n_experts)
    card.reset_peak()
    params, draw_s = card.timed(lambda: steps.init_params_sharded(
        SEED, cfg, mesh))
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
    ones, tokens = [], []
    for seed in seeds:
        prompt = prompt_of(cfg, seed, card.dev)
        toks = torch.zeros((PARITY_STEPS + 1, B), dtype=torch.long,
                           device=card.dev)
        one = one_card_run(cfg, whole, prompt, toks, PARITY_STEPS) \
            if rank == 0 else None
        dist.broadcast(toks, src=0)
        ones.append(one)
        tokens.append((prompt, toks))
    del whole
    card.release()
    dist.barrier()

    def read(i, outs, calls):
        if rank:
            return None
        if not moe:
            return readings(outs, ones[i][0])
        masks, top1 = row_agreement(ones[i][1], calls)
        return readings(outs, ones[i][0], masks, top1)

    out["seeds"] = list(seeds)
    out["sound"], out["fault"] = [], []
    with torch.no_grad():
        for i, (prompt, toks) in enumerate(tokens):
            if i == 0:   # timed and counted with the recorder off
                LAUNCHES.clear()
                (outs, calls, step_s), run_s = card.timed(
                    lambda: sharded_run(cfg, params, mesh, prompt, toks,
                                        PARITY_STEPS, card, record=False))
                out["launches"] = {k: v for k, v in LAUNCHES.items() if v}
                out["sharded_run_s"] = run_s
                out["decode_ms_per_token"] = step_s * 1e3
            if i or moe:
                outs, calls, _ = sharded_run(cfg, params, mesh, prompt, toks,
                                             PARITY_STEPS, card)
            out["sound"].append(read(i, outs, calls))
            if moe:   # every rank must have routed every token alike
                out.setdefault("ranks_route_alike", []).append(
                    ranks_alike(routing_tensor(calls).to(card.dev)))
                out.setdefault("min_router_margin", []).append(min(
                    float(r["margin"]) for call in calls for r in call))
            del outs, calls
        # the planted fault: for a dense model, rank 1's heads of group
        # 0's attention output; for a MoE model, the combine's all-reduce
        if moe:
            fault = cs.dropped_combine()
        else:
            fault = contextlib.nullcontext()
            if rank == 1:
                params["groups"]["b0"]["attn"]["wo"]["kernel"].to_local()[
                    0].zero_()
        with fault:
            for i, (prompt, toks) in enumerate(tokens):
                outs, calls, _ = sharded_run(cfg, params, mesh, prompt,
                                             toks, PARITY_STEPS, card)
                out["fault"].append(read(i, outs, calls))
                del outs, calls
    out["peak_gb"] = card.peak_gb()
    out.update(decode_bounds(cfg, params, bandwidth))
    del ones, params
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


def position_stats(per: torch.Tensor, agree_mask=None) -> dict:
    """A (B, GEN) teacher-forced error's worst and median position, and
    with ``agree_mask`` the worst over the positions whose routing agrees
    with the teacher-forced run's at every MoE layer and their share."""
    out = {"max": float(per.max()), "median": float(per.median())}
    if agree_mask is not None:
        out["agreeing"] = float(per[agree_mask].max()) \
            if bool(agree_mask.any()) else None
        out["agreeing_share"] = float(agree_mask.float().mean())
    return out


def serve_deep(rank, card, mesh, arch, layers, reduced, bandwidth, seeds):
    """Parts (c) and (e): the sharded draw, greedy generate and
    teacher-forced check of ``arch`` at ``layers`` layers, for each
    prompt seed (the first timed, counted and profiled)."""
    from torch.distributed.tensor.debug import CommDebugMode
    import chip_smoke as cs
    from repro_torch.launch import steps
    from repro_torch.models import lm
    cfg = config(arch, layers, reduced)
    moe = bool(cfg.n_experts)
    s = steps.StepSettings()
    card.reset_peak()
    params, draw_s = card.timed(lambda: steps.init_params_sharded(
        SEED, cfg, mesh, s))
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "full_layers": config(arch, None, reduced).n_layers,
           "draw_s": draw_s, "draw_peak_gb": card.peak_gb(),
           "local_weight_gb": local_bytes(params) / 1e9}
    serve = steps.make_serve_step(cfg, mesh=mesh)

    def generate(prompt, record=True):
        """(logits (B, GEN, V) gathered, tokens (B, GEN), prefill s,
        decode s a token, caches, routing (GEN, MoE layers, B): each
        generated position's token's routing; None for a dense model or
        with ``record`` off)."""
        caches = steps.place_caches(mesh, cfg, lm.init_lm_cache(
            cfg, B, S + GEN + PROFILE_STEPS, device=card.dev))
        with routes(cfg, record) as pre, \
                steps.sharded_context(mesh, s, "prefill"):
            (last, caches), pre_s = card.timed(lambda: lm.lm_prefill(
                params, cfg, steps.place_batch(mesh, prompt), caches))
        logits = [last.full_tensor()]
        toks = [logits[-1].argmax(-1)]
        routed = [[r["routed"][:, -1] for r in pre]]
        card.sync()
        t0 = time.perf_counter()
        for t in range(S, S + GEN - 1):
            with routes(cfg, record) as step:
                lg, caches = serve(params, toks[-1], caches, t)
            routed.append([r["routed"][:, 0] for r in step])
            logits.append(lg.full_tensor())
            toks.append(logits[-1].argmax(-1))
        card.sync()
        step_s = (time.perf_counter() - t0) / (GEN - 1)
        routed = torch.stack([torch.stack(r) for r in routed]) \
            if moe and record else None
        return (torch.stack(logits, 1), torch.stack(toks, 1), pre_s,
                step_s, caches, routed)

    def stack_logits(seq):
        """``lm_prefill``'s stack over ``seq`` (each MoE position routed
        as a decode step) with positions S - 1.. read out, gathered; and
        the routing of those positions (MoE layers, B, GEN)."""
        caches = steps.place_caches(mesh, cfg, lm.init_lm_cache(
            cfg, B, seq.shape[1], device=card.dev))
        with routes(cfg) as rec, steps.sharded_context(mesh, s, "prefill"):
            h = lm.add_positions(params, cfg, lm._embed(
                params, cfg, steps.place_batch(mesh, seq)))
            h, _ = lm._blocks(params, cfg, h, caches)
            full = lm._readout(params, cfg, h[:, S - 1:]).full_tensor()
        return full, torch.stack([r["routed"][:, S - 1:] for r in rec])

    def per_position(logits, full):
        return (logits - full).abs().amax(-1) / full.abs().max()

    def teacher_forced(logits, toks, routed):
        """The generate's per-position errors against the teacher-forced
        run: a dense model's sharded prefill step; a MoE model's
        ``stack_logits`` (checked) and prefill step (printed)."""
        seq = torch.cat([prompt, toks[:, :-1].to(prompt.dtype)], dim=1)
        step = steps.make_prefill_step(cfg, s, mesh=mesh)(
            params, {"tokens": seq})[:, S - 1:].full_tensor()
        if not moe:
            return position_stats(per_position(logits, step))
        full, tf_routed = stack_logits(seq)
        agreeing = (routed.permute(1, 2, 0) == tf_routed).all(0)
        return dict(position_stats(per_position(logits, full), agreeing),
                    prefill_step=position_stats(per_position(logits, step)),
                    tokens_alike_on_ranks=ranks_alike(toks),
                    routing_alike_on_ranks=ranks_alike(routed))

    out["checks"] = []
    for i, seed in enumerate(seeds):
        prompt = prompt_of(cfg, seed, card.dev)
        with torch.no_grad():
            if i == 0:   # timed, counted and profiled with the recorder off
                card.reset_peak()
                LAUNCHES.clear()
            logits, toks, pre_s, step_s, caches, routed = generate(
                prompt, record=not (moe and i == 0))
            if i == 0:
                out["launches"] = {k: v for k, v in LAUNCHES.items() if v}
                out["peak_gb"] = card.peak_gb()
                out["headroom_gb"] = card.headroom_gb()
                out["prefill_ms"] = pre_s * 1e3
                out["decode_ms_per_token"] = step_s * 1e3
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
                if moe:   # the same generate recorded, for the checks
                    del caches, logits
                    timed_toks = toks
                    logits, toks, _, _, caches, routed = generate(prompt)
                    out["recorded_tokens_equal"] = bool(
                        torch.equal(toks, timed_toks))
            del caches
            sound = teacher_forced(logits, toks, routed)
            del logits
            with cs.lost_cache_writes():
                f_logits, f_toks, _, _, caches, f_routed = generate(prompt)
            del caches
            fault = teacher_forced(f_logits, f_toks, f_routed)
            del f_logits
        out["checks"].append({"seed": seed, "sound": sound, "fault": fault})
        if i == 0:
            out["teacher_forced_rel_err"] = sound["max"]
            out["planted_fault_rel_err"] = fault["max"]
    out["run_peak_gb"] = card.peak_gb()
    out["run_headroom_gb"] = card.headroom_gb()
    out.update(decode_bounds(cfg, params, bandwidth))
    del params
    card.release()
    return out


def rank_main(rank: int, port: int, device: str, reduced: bool,
              arch: str, layers: int, seeds) -> None:
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
        for name, n in ((arch, MOE_PARITY_LAYERS),) if arch == MOE_ARCH \
                else PARITY:
            out[f"parity/{name}"] = parity(rank, card, mesh, name, n,
                                           reduced, seeds, H100.hbm_bw)
            dist.barrier()
        out["deep"] = serve_deep(rank, card, mesh, arch, layers, reduced,
                                 H100.hbm_bw, seeds)
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
cfg = config({arch!r}, {layers}, {reduced})
with dryrun.fake_world({world}):
    mesh = init_device_mesh("cpu", (1, {world}),
                            mesh_dim_names=("data", "model"))
    res = dryrun.run_cell(cfg.name, None, False, StepSettings(),
                          verbose=False, mesh=mesh, cfg=cfg,
                          shape=ShapeSpec("decode_{b}x{n}", "decode", {n},
                                          {b}))
print(json.dumps(res))
"""


def dry_run(arch: str, layers: int, reduced: bool) -> subprocess.Popen:
    """The dry run's decode step of ``arch`` at ``layers`` on a fake (1,
    WORLD) mesh, in a process of its own (the fake group is
    process-global)."""
    code = _DRYRUN.format(tools=os.path.join(ROOT, "tools"), arch=arch,
                          layers=layers, reduced=reduced, world=WORLD, b=B,
                          n=S + GEN)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=ROOT)


def dry_result(proc: subprocess.Popen) -> dict:
    dry_out, dry_err = proc.communicate(timeout=1800)
    try:
        return json.loads(dry_out.strip().splitlines()[-1])
    except (IndexError, ValueError):
        return {"status": "FAIL", "error": dry_err[-3000:]}


def check(results, dry) -> None:
    """Raises on any failed check of the four ranks' results (parts (a)
    to (c))."""
    r0 = results[0]
    for arch, _ in PARITY:
        got = r0[f"parity/{arch}"]
        sound = got["sound"][0]["max_rel_l2"]
        fault = got["fault"][0]["max_rel_l2"]
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


def check_moe(results, dry, hold_limits: bool) -> None:
    """Raises on any failed check of parts (d) and (e); the limits only
    with ``hold_limits`` (the readings are printed either way)."""
    fails = []
    r0 = results[0]
    par = r0[f"parity/{MOE_ARCH}"]
    for i, seed in enumerate(par["seeds"]):
        sound, fault = par["sound"][i], par["fault"][i]
        if hold_limits and not (
                sound[MOE_PARITY_STAT] <= MOE_PARITY_TOL
                < fault[MOE_PARITY_STAT]
                and sound["agreeing_row_share"] >= MOE_AGREE_FLOOR):
            fails.append(f"(d) seed {seed}: {MOE_PARITY_STAT} "
                         f"{sound[MOE_PARITY_STAT]}, fault "
                         f"{fault[MOE_PARITY_STAT]}, limit {MOE_PARITY_TOL};"
                         f" agreeing rows {sound['agreeing_row_share']}, "
                         f"floor {MOE_AGREE_FLOOR}")
        if not par["ranks_route_alike"][i]:
            fails.append(f"(d) seed {seed}: the ranks route differently")
    for r in results:
        cuda = r["device"].startswith("cuda")
        launches = r[f"parity/{MOE_ARCH}"]["launches"]
        if cuda and launches.get("flash_attention") != 2 * MOE_PARITY_LAYERS:
            fails.append(f"(d) rank {r['rank']}: flash launches {launches}")
        d = r["deep"]
        if not (d["finite"] and d["tokens_in_range"]):
            fails.append(f"(e) rank {r['rank']}: logits or tokens off")
        if cuda and d["launches"].get("flash_attention") != d["layers"]:
            fails.append(f"(e) rank {r['rank']}: flash launches "
                         f"{d['launches']}, {d['layers']} layers")
    if dry.get("status") != "OK":
        fails.append(f"dry run: {dry}")
    for c in r0["deep"]["checks"]:
        sound, fault = c["sound"], c["fault"]
        if not (sound["tokens_alike_on_ranks"]
                and sound["routing_alike_on_ranks"]):
            fails.append(f"(e) seed {c['seed']}: the ranks' tokens or "
                         "routing differ")
        stat = MOE_DECODE_STAT
        if hold_limits and not sound[stat] <= MOE_DECODE_TOL < fault[stat]:
            fails.append(f"(e) seed {c['seed']}: {stat} {sound[stat]}, "
                         f"fault {fault[stat]}, limit {MOE_DECODE_TOL}")
    if fails:
        raise AssertionError("; ".join(fails))


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--arch", default="nemotron_4_340b",
                    choices=("nemotron_4_340b", MOE_ARCH))
    ap.add_argument("--layers", type=int, default=None,
                    help=f"(c)'s depth (at most {MAX_LAYERS}; default "
                    f"{TP_LAYERS}) or (e)'s (at most {MOE_MAX_LAYERS}; "
                    f"default {MOE_LAYERS})")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1],
                    help="(d)'s and (e)'s prompt seeds")
    args = ap.parse_args()
    moe = args.arch == MOE_ARCH
    top = MOE_MAX_LAYERS if moe else MAX_LAYERS
    layers = args.layers or (MOE_LAYERS if moe else TP_LAYERS)
    if layers > top:
        ap.error(f"--layers {layers} > {top}")
    if not moe and args.seeds != [1]:
        ap.error("--seeds are (d)'s and (e)'s")
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
    dry_proc = dry_run(args.arch, layers, args.reduced)
    t0 = time.perf_counter()
    mp.spawn(rank_main, args=(free_port(), args.device, args.reduced,
                              args.arch, layers, tuple(args.seeds)),
             nprocs=WORLD)
    seconds = time.perf_counter() - t0
    dry = dry_result(dry_proc)
    results = []
    for r in range(WORLD):
        with open(os.path.join(OUT, f"rank{r}.json")) as f:
            results.append(json.load(f))
    for r in results:
        print(json.dumps({"phase": "serve_tp_card", **r}), flush=True)
    print(json.dumps({"phase": "serve_tp_dryrun", "arch": args.arch,
                      "layers": layers, "mesh": [1, WORLD],
                      "status": dry.get("status"),
                      "collective_counts": dry.get("collective_counts"),
                      "trace_s": dry.get("trace_s")}), flush=True)
    if moe:
        # the MoE limits are full width's in bf16: a reduced float32
        # model reads on another scale, so its rehearsal prints them
        check_moe(results, dry, hold_limits=not args.reduced)
        limits = {"parity_stat": MOE_PARITY_STAT,
                  "parity_tol": MOE_PARITY_TOL,
                  "agree_floor": MOE_AGREE_FLOOR,
                  "decode_stat": MOE_DECODE_STAT,
                  "decode_tol": MOE_DECODE_TOL,
                  "limits_held": not args.reduced}
    else:
        check(results, dry)
        limits = {"parity_tol": PARITY_TOL, "decode_tol": DECODE_TOL}
    print(json.dumps({"phase": "serve_tp", "arch": args.arch,
                      "reduced": args.reduced, "mesh": [1, WORLD],
                      "layers": layers, "seeds": args.seeds, **limits,
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
