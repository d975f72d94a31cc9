"""Fault-tolerant training loop and CLI — the port of
``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b \\
        --steps 50 --batch 8 --seq 128 [--ckpt-dir DIR]
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b \\
        --reduced --device cpu --steps 3 --batch 2 --seq 16
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen3_8b --mesh 2x2 --steps 3 --batch 8 --seq 128

The reference's flags, plus ``--device`` (default ``cuda``; ``cpu`` on
request, never as a fallback), ``--mesh DxM`` and its settings
(``remat="none"``, ``zero_opt=False``). Loop skeleton: restore the
latest step -> skip the data stream ahead to it -> each step under a
watchdog -> periodic checkpoints -> on failure, a bounded
restore-and-retry.

``--mesh DxM`` trains over a (data D, model M) ``DeviceMesh``, one
process per device under ``torchrun`` (which sets ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``, and the rendezvous address): nccl and
``cuda:LOCAL_RANK`` on the cards, gloo with ``--device cpu``. D·M must be
the world size. Every rank draws the same global batch from
``token_batches`` (one seed) and ``data/loader.py`` places it over the
batch axes; the params and moments are DTensors (``launch/steps.py``).
Only rank 0 logs; every rank joins a checkpoint (rank 0 writes it).

An encoder-decoder config (``whisper_base``) trains through
``train_loop`` on batches of ``frames``, ``tokens`` and ``targets``. The
CLI streams tokens only, as the reference's does, and the reference's
CLI then fails inside ``encdec_loss`` for want of frames: the port's
CLI refuses such a config up front, naming what is missing. A frontend
config (``paligemma_3b``) trains text-only through the CLI, as in the
reference.

The step updates params and optimizer state in place
(``launch/steps.py``), so a restore copies the checkpoint into those
same tensors: a failed step's partial update is overwritten, and the
card never holds two copies of the model. ``CheckpointManager.save``
copies every leaf to the host before it returns, so the next step may
write them at once.
"""
from __future__ import annotations

import argparse
import logging
import time
from typing import List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import flatten_sorted
from repro_torch.configs import get
from repro_torch.data import token_batches
from repro_torch.distributed.fault import (FailureInjector, StepFailure,
                                           StepWatchdog, WatchdogConfig)
from repro_torch.data.loader import ShardedLoader
from repro_torch.launch.steps import (StepSettings, make_train_step,
                                      shard_state)
from repro_torch.models.encdec import init_encdec
from repro_torch.models.lm import init_lm

log = logging.getLogger("repro_torch.train")


def _restore_into(ckpt: CheckpointManager, step: int, params, opt_state):
    """Checkpoint ``step`` copied into the live params and moments."""
    live = {"params": params, "opt": opt_state}
    state = ckpt.restore(step, live)
    with torch.no_grad():
        for dst, src in zip(flatten_sorted(live)[0],
                            flatten_sorted(state)[0]):
            dst.copy_(src)


def _skip(batch_iter, n: int):
    """A fresh iterator over ``batch_iter``, ``n`` batches in."""
    it = iter(batch_iter)
    for _ in range(n):
        next(it)
    return it


def train_loop(cfg, settings: StepSettings, steps: int, batch_iter,
               ckpt: Optional[CheckpointManager] = None,
               ckpt_every: int = 25,
               injector: Optional[FailureInjector] = None,
               watchdog: Optional[StepWatchdog] = None, seed: int = 0,
               device=None, mesh=None):
    """Returns (params, opt_state, history of ``{step, loss,
    grad_norm}``). Params are ``init_lm``'s (``init_encdec``'s for an
    encoder-decoder config) from a generator seeded ``seed`` on
    ``resolve_device(device)``. Restartable: if ``ckpt`` has a
    latest step, resumes from it (params, optimizer state, step index).
    ``batch_iter`` must restart its stream on each ``iter()`` (a rewind
    after a failure replays it from the start). Over ``mesh`` (a
    ``DeviceMesh``, ``launch/mesh.py``) every rank calls this with the
    same arguments and the same global batches; params and moments are
    DTensors placed by ``shard_state`` from rank 0's draw."""
    dev = resolve_device(device)
    step_fn, opt = make_train_step(cfg, settings, mesh=mesh)
    watchdog = watchdog or StepWatchdog(WatchdogConfig())

    init = init_encdec if cfg.is_encdec else init_lm
    params = init(torch.Generator(device=dev).manual_seed(seed), cfg,
                  device=dev)
    if mesh is None:
        opt_state = opt.init(params)
    else:
        params, opt_state = shard_state(mesh, settings, params, opt)
    start = 0
    if ckpt is not None:
        latest = ckpt.latest_step()
        if latest is not None:
            _restore_into(ckpt, latest, params, opt_state)
            start = latest
            log.info("resumed from step %d", latest)

    history: List[dict] = []
    # data skip-ahead keeps the stream aligned with the resumed step
    it = _skip(batch_iter, start)
    step = start
    while step < steps:
        batch = next(it)
        try:
            if injector is not None:
                injector.maybe_fail(step)
            # the watchdog owns the NaN screen (WatchdogConfig.
            # nan_is_failure): loss_of names the scalar to vet
            params, opt_state, metrics = watchdog.run(
                step_fn, params, opt_state, step, batch,
                loss_of=lambda out: out[2]["loss"])
            loss = float(metrics["loss"])
        except StepFailure as e:
            log.warning("step %d failed: %s", step, e)
            if ckpt is None or not watchdog.record_failure():
                raise
            latest = ckpt.latest_step()
            if latest is None:
                raise StepFailure("no checkpoint to restore from") from e
            _restore_into(ckpt, latest, params, opt_state)
            # rewind the data stream to the restored step
            it = _skip(batch_iter, latest)
            step = latest
            continue
        history.append({"step": step, "loss": loss,
                        "grad_norm": float(metrics["grad_norm"])})
        step += 1
        if ckpt is not None and (step % ckpt_every == 0 or step == steps):
            ckpt.save(step, {"params": params, "opt": opt_state})
    if ckpt is not None:
        ckpt.wait()
    return params, opt_state, history


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; a missing card is an "
                         "error, never a fallback")
    ap.add_argument("--mesh", default=None,
                    help="DxM: train over a (data D, model M) mesh, one "
                         "process per device under torchrun")
    return ap


def init_mesh(spec: str, device):
    """The (data, model) ``DeviceMesh`` of ``--mesh DxM`` over a process
    group made from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``): nccl with this
    rank's card, gloo on the CPU. Returns (mesh, this rank's device).
    A product D·M that is not the world size is refused."""
    import os
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    try:
        d, m = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh {spec!r}: want DxM, e.g. 2x2") from None
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if d * m != world:
        raise SystemExit(f"--mesh {spec} asks for {d * m} devices; the run "
                         f"has {world} processes (WORLD_SIZE): launch it "
                         f"with torchrun --nproc-per-node {d * m}")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            rank=int(os.environ.get("RANK", "0")), world_size=world,
            **({"device_id": device} if device.type == "cuda" else {}))
    return make_debug_mesh(d, m, device_type=device.type), device


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the CLI; returns the trained params, the history and the
    wall seconds for programmatic callers."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encdec:
        raise SystemExit(
            f"--arch {args.arch}: an encoder-decoder model trains on frames, "
            "tokens and targets, and this CLI streams tokens and targets "
            "only; call train_loop with batches that carry frames")
    device = resolve_device(args.device)
    mesh = None
    if args.mesh is not None:
        mesh, device = init_mesh(args.mesh, device)
    lead = mesh is None or torch.distributed.get_rank() == 0
    settings = StepSettings(microbatches=args.microbatches, remat="none",
                            lr=args.lr, zero_opt=False)

    batches = ({"tokens": t, "targets": y}
               for t, y in token_batches(cfg.vocab, args.batch, args.seq,
                                         device=device))
    if mesh is not None:     # every rank draws the same global batches
        batches = ShardedLoader(batches, mesh=mesh)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3, async_save=True) \
        if args.ckpt_dir else None

    t0 = time.time()
    params, _, hist = train_loop(cfg, settings, args.steps, batches, ckpt,
                                 args.ckpt_every, device=device, mesh=mesh)
    seconds = time.time() - t0
    if lead:
        for h in hist[::args.log_every] + hist[-1:]:
            print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
                  f"gnorm {h['grad_norm']:.3f}")
        print(f"total {seconds:.1f}s; final loss {hist[-1]['loss']:.4f}")
    return dict(cfg=cfg, params=params, history=hist, seconds=seconds,
                device=device, mesh=mesh)


if __name__ == "__main__":
    main()
