"""Full-width Qwen3-8B trained over a (data 2, model 2) mesh of four cards
of one host: the sharded train step of ``launch/steps.py`` where one card
cannot hold it (bf16 params 16.4 GB, bf16 grads 16.4 GB and float32
moments 65.6 GB make 98.4 GB against 80).

    python3 tools/train_mesh_smoke.py                       # 4 cards, nccl
    python3 tools/train_mesh_smoke.py --device cpu --reduced  # 4 gloo ranks

Four processes, one per card (``torch.multiprocessing``, nccl over
``tcp://127.0.0.1`` and a free port), each drawing the same seeded
weights and the same 8 x 128-token batches. Rank 0 first computes step 0
on one card, unsharded: the loss, the gradients and the grad norm of a
value-and-grad of the whole model (32.8 GB of params and grads fit), and
every param's first AdamW update, leaf by leaf (a first update needs
only the leaf's gradient and the clip scale), the gradients and the
updated params kept on the host. Then every rank takes the sharded
step's gradients of batch 0 (``make_value_and_grad(mesh=)``, the step's
own gradient half) and trains 3 steps of ``make_train_step(cfg,
StepSettings(remat="none", zero_opt=True), mesh=)``. Step 0 is held to
the one-card computation:
  * each leaf's gradient to a relative L2 error of GRAD_RTOL (the two
    sum the model's bf16 products in different orders, tensor
    parallelism splitting each; a gradient of half the batch, or one
    that misses a reduce over an axis, is off by the order of itself);
  * the loss and the grad norm to a relative LOSS_RTOL (the gaps read on
    four H100s were 7e-5 and 2e-4);
  * each updated param within two first-step learning rates (lr/200;
    AdamW's first step moves a weight by at most about that, in its
    gradient's sign, which a reordered sum may flip where the gradient
    is near zero) plus one bf16 ulp. Such a step is below half a bf16
    ulp for almost every weight, so rounding absorbs it and most params
    come out unchanged on both sides: this check sees little, the
    gradients' does the work.
The shares and the worst gaps are printed. With ``--fp32-ref-layers N``
the model is cut to N layers at full width (the 36 layers' float32
gradient does not fit one card) and rank 0 also takes step 0's gradient
of a float32 copy of the same weights on one card; both bf16 gradients,
one card's and the (2, 2) mesh's, are held to it leaf by leaf by relative
L2, and their worst and median leaves printed, with the verdict: a mesh
gap within FP32_REF_RATIO times the one-card gap on both is bf16
reordering, a larger one a fault of the sharded step:

    python3 tools/train_mesh_smoke.py --fp32-ref-layers 8

Then
``compressed_allreduce_mean`` over 'data', and a checkpoint of the params
saved on (2, 2) and restored onto (4, 1), equal.
Each card prints its synced ms a step, its peak memory and its flash,
RG-LRU and WKV6 launches; then the card's name and power limit. Exits
non-zero without four CUDA devices (the CPU rehearsal aside) or on a
failed check.
"""
import argparse
import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import LAUNCHES, _build  # noqa: E402

WORLD, STEPS, B, S = 4, 3, 8, 128
LR = 3e-4
LOSS_RTOL = 1e-3
GRAD_RTOL = 5e-2
# the four-card bf16 gradient's gap to float32 over the one-card gap, on
# the worst and the median leaf, within which the two differ only by the
# order of their bf16 sums
FP32_REF_RATIO = 2.0
OUT = os.path.join(ROOT, "build", "train_mesh_smoke")


def rel_l2_by_leaf(got, want):
    """Each leaf's relative L2 gap of ``got`` to ``want`` (float32)."""
    return [float(torch.linalg.vector_norm(a.float() - b.float())
                  / torch.linalg.vector_norm(b.float()).clamp_min(1e-30))
            for a, b in zip(got, want)]


def gap_summary(errs, names):
    worst = max(range(len(errs)), key=errs.__getitem__)
    return dict(max_rel_l2=errs[worst], worst_leaf=names[worst],
                median_rel_l2=sorted(errs)[len(errs) // 2])


def rank_main(rank: int, port: int, device: str, reduced: bool,
              fp32_ref_layers: int) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import empty as dempty
    from torch.utils import _pytree as pytree

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get
    from repro_torch.data import token_batches
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.lm import init_lm, lm_loss
    from repro_torch.optim import (AdamState, clip_scale, global_norm,
                                   linear_warmup_cosine)
    from repro_torch.optim.grad_compress import compressed_allreduce_mean

    cuda = device == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD,
                            **({"device_id": dev} if cuda else {}))
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    out = {"rank": rank, "device": str(dev)}
    try:
        cfg = get("qwen3_8b")
        if reduced:
            cfg = cfg.reduced()
        if fp32_ref_layers:
            cfg = dataclasses.replace(cfg, n_layers=fp32_ref_layers)
        settings = steps.StepSettings(remat="none", zero_opt=True, lr=LR)
        it = token_batches(cfg.vocab, B, S, seed=0, device=dev)
        batches = [dict(zip(("tokens", "targets"), next(it)))
                   for _ in range(STEPS)]
        params0 = init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                          device=dev)
        opt = steps.make_optimizer(settings)

        # step 0 on one card (rank 0), unsharded
        ref = None
        if rank == 0:
            t0 = time.perf_counter()
            loss, _, grads = steps._value_and_grad(
                lambda p, b: lm_loss(p, cfg, b["tokens"], b["targets"]),
                params0, batches[0])
            gnorm = global_norm(grads)
            scale = clip_scale(gnorm, settings.grad_clip)
            p_ref = []
            for p, g in zip(pytree.tree_leaves(params0), grads):
                p = p.clone()
                z = lambda: torch.zeros(p.shape, dtype=torch.float32,
                                        device=dev)
                opt.update_in_place([g], AdamState(mu=[z()], nu=[z()]),
                                    [p], 0, scale)
                p_ref.append(p.cpu())
            g_ref = [g.cpu() for g in grads]
            del grads, p
            names = [shd.path_str(path) for path, _ in
                     pytree.tree_leaves_with_path(params0)]
            if fp32_ref_layers:
                cfg32 = dataclasses.replace(cfg, dtype="float32",
                                            param_dtype="float32")
                _, _, g32 = steps._value_and_grad(
                    lambda p, b: lm_loss(p, cfg32, b["tokens"],
                                         b["targets"]),
                    pytree.tree_map(lambda l: l.float(), params0),
                    batches[0])
                g32 = [g.cpu() for g in g32]
                out["fp32_ref"] = dict(
                    layers=fp32_ref_layers,
                    one_card=gap_summary(rel_l2_by_leaf(g_ref, g32), names))
            ref = {"loss": float(loss), "grad_norm": float(gnorm)}
            sync()
            out["one_card_s"] = time.perf_counter() - t0
            if cuda:
                out["one_card_peak_gb"] = \
                    torch.cuda.max_memory_allocated(dev) / 1e9
                torch.cuda.empty_cache()
        dist.barrier()

        # the sharded step on a (2, 2) mesh
        mesh = make_debug_mesh(2, 2, device_type=dev.type)
        step, _ = steps.make_train_step(cfg, settings, mesh=mesh)
        params, state = steps.shard_state(mesh, settings, params0, opt,
                                          src_data_rank=None)
        del params0
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        # the sharded gradients of batch 0, leaf by leaf (untimed)
        loss, _, grads = steps.make_value_and_grad(cfg, settings, mesh=mesh)(
            params, batches[0])
        grad_err, fp32_err = [], []
        for j, g in enumerate(grads):
            full = g.full_tensor()
            if rank == 0:
                grad_err += rel_l2_by_leaf([full], [g_ref[j].to(dev)])
                if fp32_ref_layers:
                    fp32_err += rel_l2_by_leaf([full], [g32[j].to(dev)])
            del full
        del grads
        if rank == 0:
            del g_ref
            out["grads"] = dict(loss=float(loss),
                                **gap_summary(grad_err, names))
            if fp32_ref_layers:
                del g32
                ref32 = out["fp32_ref"]
                ref32["four_card"] = gap_summary(fp32_err, names)
                keys = ("max_rel_l2", "median_rel_l2")
                one, four = ref32["one_card"], ref32["four_card"]
                ref32["ratio"] = {k: four[k] / one[k] if one[k] else None
                                  for k in keys}
                ref32["verdict"] = (
                    "bf16 reordering" if all(
                        four[k] <= FP32_REF_RATIO * one[k] for k in keys)
                    else "fault of the sharded step")
        dist.barrier()
        # the bound of a first update: two learning rates of step 0
        lr0 = float(linear_warmup_cosine(LR, LR * 0.1, 200, 10_000)(
            torch.tensor(1.0)))
        LAUNCHES.clear()
        ms, hist = [], []
        for i, b in enumerate(batches):
            sync()
            t0 = time.perf_counter()
            params, state, m = step(params, state, i, b)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            hist.append({k: float(m[k]) for k in ("loss", "grad_norm")})
            if i == 0:
                equal = near = total = 0
                worst = 0.0
                leaves = pytree.tree_leaves(params)
                for j, leaf in enumerate(leaves):
                    full = leaf.full_tensor()
                    if rank == 0:
                        a, b = full.cpu().float(), p_ref[j].float()
                        d = (a - b).abs()
                        ulp = torch.maximum(a.abs(), b.abs()) * 2.0 ** -7
                        equal += int((d == 0).sum())
                        near += int((d <= 2 * lr0 + ulp).sum())
                        total += d.numel()
                        worst = max(worst, float(d.max()))
                    del full
                dist.barrier()   # rank 0 compared on the host: untimed
                if rank == 0:
                    del p_ref
                    out["step0"] = dict(
                        sharded=hist[0], one_card=ref,
                        params_equal_share=equal / total,
                        params_within_bound_share=near / total,
                        lr0=lr0,
                        params_max_abs_diff=worst)
        out["ms_per_step"] = ms
        out["history"] = hist
        out["launches"] = {k: LAUNCHES[k] for k in
                           ("flash_attention", "rglru_scan", "rwkv6_scan")}
        if cuda:
            out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9

        # int8 mean over 'data': the same x everywhere, then each rank's own
        g = torch.Generator(device=dev)
        x = torch.randn(4096, 256, generator=g.manual_seed(5), device=dev)
        same = compressed_allreduce_mean(x, mesh, axis="data")
        own = torch.randn(4096, 256, generator=g.manual_seed(6 + rank),
                          device=dev)
        mean = own.clone()
        dist.all_reduce(mean, group=mesh.get_group("data"))
        mean /= mesh.size(0)
        mixed = compressed_allreduce_mean(own, mesh, axis="data")
        out["compressed_allreduce_max_err"] = [
            float((same - x).abs().max()), float((mixed - mean).abs().max())]

        # the params saved on (2, 2), restored onto (4, 1)
        ckpt_dir = os.path.join(OUT, "ckpt")
        ck = CheckpointManager(ckpt_dir, keep=1, codec="raw")
        t0 = time.perf_counter()
        ck.save(1, params)
        mesh41 = init_device_mesh(dev.type, (4, 1),
                                  mesh_dim_names=("data", "model"))
        like = pytree.tree_map(
            lambda l, pl: dempty(
                tuple(l.shape), dtype=l.dtype, device_mesh=mesh41,
                placements=pl),
            params, shd.grad_shardings(mesh41, params),
            is_leaf=lambda l: isinstance(l, torch.Tensor))
        back = ck.restore(1, like)
        # restore gives dicts in sorted key order: compare path by path
        saved = {shd.path_str(p): l for p, l in
                 pytree.tree_leaves_with_path(params)}
        unequal = [shd.path_str(p) for p, a in
                   pytree.tree_leaves_with_path(back)
                   if not torch.equal(a.full_tensor(),
                                      saved[shd.path_str(p)].full_tensor())]
        out["restore_4x1_equal"] = not unequal
        out["restore_4x1_unequal"] = unequal or None
        out["checkpoint_s"] = time.perf_counter() - t0
        dist.barrier()
        if rank == 0:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    finally:
        with open(os.path.join(OUT, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()


def check(results) -> None:
    r0 = results[0]
    s0 = r0["step0"]
    for k in ("loss", "grad_norm"):
        a, b = s0["sharded"][k], s0["one_card"][k]
        if abs(a - b) > LOSS_RTOL * abs(b):
            raise AssertionError(f"step 0 {k}: sharded {a}, one card {b}")
    if r0["grads"]["max_rel_l2"] > GRAD_RTOL:
        raise AssertionError(f"step 0 gradients: {r0['grads']}")
    if s0["params_within_bound_share"] != 1.0:
        raise AssertionError(f"step 0 params: {s0}")
    for r in results:
        if r["device"].startswith("cuda") and \
                r["launches"]["flash_attention"] == 0:
            raise AssertionError(f"rank {r['rank']}: no flash launch")
        if max(r["compressed_allreduce_max_err"]) > 0.03:
            raise AssertionError(f"rank {r['rank']}: int8 mean off by "
                                 f"{r['compressed_allreduce_max_err']}")
        if not r["restore_4x1_equal"]:
            raise AssertionError(f"rank {r['rank']}: restore onto (4, 1) "
                                 "differs")
        if r["history"] != r0["history"]:
            raise AssertionError("ranks disagree on the metrics")


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--fp32-ref-layers", type=int, default=0,
                    help="cut the model to this many layers and hold both "
                    "bf16 gradients of step 0 to a float32 one-card "
                    "gradient (0: off)")
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
            print(f"train_mesh_smoke: needs {WORLD} CUDA devices",
                  file=sys.stderr)
            return 2
        t0 = time.perf_counter()
        _build.build_all()
        print(json.dumps({"phase": "build",
                          "seconds": time.perf_counter() - t0}), flush=True)
    os.makedirs(OUT, exist_ok=True)
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    mp.spawn(rank_main, args=(free_port(), args.device, args.reduced,
                              args.fp32_ref_layers), nprocs=WORLD)
    results = []
    for r in range(WORLD):
        with open(os.path.join(OUT, f"rank{r}.json")) as f:
            results.append(json.load(f))
    for r in results:
        print(json.dumps({"phase": "train_mesh_card", **r}), flush=True)
    check(results)
    if args.fp32_ref_layers:
        print(json.dumps({"phase": "grad_gap_fp32",
                          **results[0]["fp32_ref"]}), flush=True)
    print(json.dumps({"phase": "train_mesh", "arch": "qwen3_8b",
                      "reduced": args.reduced,
                      "layers": args.fp32_ref_layers or None, "mesh": [2, 2],
                      "batch": [B, S], "steps": STEPS,
                      "seconds": time.perf_counter() - t0}), flush=True)
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
