"""RWKV6's float32 gradient gap held against a float64 plain route, leaf
by leaf: does the kernel route's gap come from the model's conditioning
or from a fault?

    python3 tools/rwkv6_fp32_gap.py
    python3 tools/rwkv6_fp32_gap.py --device cpu --layers 2 --batch 2 \\
        --seq 16 --reduced --seeds 13

from the repository root. ``chip_smoke.py::train_fp32_step`` holds the
float32 kernel route of one train step to the all-plain float32 route;
on RWKV6 (4 layers, full width, 8 x 128 tokens) the two gradient trees
differ by ~2e-3 of the tree's largest value, where the other models read
1e-7 to 5e-7. Here, for each params seed (``init_lm`` from a seeded
generator, as ``train_fp32_step`` draws them) and the same batch
(``chip_smoke``'s first training batch), the gradient of ``lm_loss``
goes through three routes:

- ``kernel``: float32, the port as it runs (the WKV6 operator, its CUDA
  forward and backward kernels on the card);
- ``plain``: float32, every kernel swapped for its plain version
  (``chip_smoke.plain_kernels``);
- ``float64``: the plain route with the params in float64, the model's
  activations in float64 (``lm.dtype_of`` and ``Tensor.float`` patched
  while it runs, so no layer rounds to float32) and a float64 WKV6
  recurrence: the reference both float32 routes are held against.

Per seed it prints one JSON line: for each float32 route, the largest
|difference| to the float64 gradient tree over that tree's largest
value, the three leaves where it is largest, and each route's gap on
the other's leading leaves (the difference over that leaf's own largest
float64 value); and the kernel route against the plain one (the reading
``chip_smoke.TRAIN_FP32_TOL`` bounds). Then a summary line: the largest
ratio of the kernel route's gap to the plain route's, and whether the
two routes' leading leaves agree. A kernel route within ~10x of the
plain route's gap, led by the same leaves, is float32 rounding
amplified by the model, not a fault of the kernels. Then the card's
name and power limit and a last ``{"ok": true, ...}`` line. Exits
non-zero without a CUDA device unless ``--device cpu`` is given.
"""
import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch
from torch.utils import _pytree as pytree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.data import token_batches  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.nn import rwkv6 as nn_rwkv6  # noqa: E402

ARCH = "rwkv6_1p6b"


def wkv6_float64(r, k, v, w, u, S0=None, *, want_state=False):
    """The WKV6 recurrence of ``kernels/rwkv6_scan/ref.py`` in the inputs'
    own type (float64 here), differentiated by autograd."""
    B, T, H, D = r.shape
    u = u[None, :, :, None]
    S = (torch.zeros((B, H, D, D), dtype=r.dtype, device=r.device)
         if S0 is None else S0)
    outs = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhi,bhij->bhj", r[:, t], S + u * kv))
        S = w[:, t, :, :, None] * S + kv
    o = torch.stack(outs, 1)
    return (o, S) if want_state else o


@contextlib.contextmanager
def float64_model():
    """While open, the model computes in float64: ``cfg.dtype`` "float32"
    gives float64 activations, ``.float()`` leaves a float64 tensor as it
    is, and the WKV6 layer runs ``wkv6_float64``."""
    dtype_of, to_float = lm.dtype_of, torch.Tensor.float

    def dtype64(name):
        return torch.float64 if name == "float32" else dtype_of(name)

    def keep64(self, *a, **kw):
        return self if self.dtype == torch.float64 else to_float(self, *a,
                                                                 **kw)

    lm.dtype_of, torch.Tensor.float = dtype64, keep64
    try:
        with cs.plain_kernels(), cs.attributes_swapped(
                [(nn_rwkv6, "wkv6", wkv6_float64)]):
            yield
    finally:
        lm.dtype_of, torch.Tensor.float = dtype_of, to_float


def gradients(cfg, params, batch):
    def loss_fn(p, mb):
        return lm.lm_loss(p, cfg, mb["tokens"], mb["targets"])

    loss, _, grads = steps._value_and_grad(loss_fn, params, batch)
    return float(loss), grads


def gap(grads, ref, names):
    """``grads`` against the float64 ``ref``: the largest |difference| over
    ref's largest |value|, and per leaf the difference over the leaf's own
    largest |value|."""
    diffs = [float((g.double() - r).abs().max()) for g, r in zip(grads, ref)]
    maxes = [float(r.abs().max()) for r in ref]
    per_leaf = {n: d / m if m > 0 else d
                for n, d, m in zip(names, diffs, maxes)}
    top = sorted(zip(diffs, names), reverse=True)[:3]
    return dict(rel=max(diffs) / max(maxes), top=[n for _, n in top],
                per_leaf=per_leaf)


def one_seed(dev, cfg, batch, seed):
    params0 = lm.init_lm(torch.Generator(device=dev).manual_seed(seed), cfg,
                         device=dev)
    names = cs.leaf_names(params0)
    out = {}
    for route, ctx in (("kernel", contextlib.nullcontext),
                       ("plain", cs.plain_kernels)):
        with ctx():
            out[route] = gradients(cfg, pytree.tree_map(torch.clone,
                                                        params0), batch)
    with float64_model():
        out["float64"] = gradients(
            cfg, pytree.tree_map(lambda t: t.double(), params0), batch)
    ref = out["float64"][1]
    gaps = {route: gap(out[route][1], ref, names)
            for route in ("kernel", "plain")}
    report = dict(seed=seed, loss={r: v[0] for r, v in out.items()},
                  kernel_vs_plain=cs.tree_diff(out["kernel"][1],
                                               out["plain"][1], names))
    lead = list(dict.fromkeys(gaps["kernel"]["top"] + gaps["plain"]["top"]))
    for route, g in gaps.items():
        report[route] = dict(rel=g["rel"], top=g["top"],
                             leading_leaves={n: g["per_leaf"][n]
                                             for n in lead})
    report["ratio"] = gaps["kernel"]["rel"] / gaps["plain"]["rel"]
    report["same_leader"] = gaps["kernel"]["top"][0] in gaps["plain"]["top"]
    del out, params0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return report


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[13, 14, 15, 16, 17])
    ap.add_argument("--layers", type=int,
                    default=cs.FP32_DECODE_LAYERS[ARCH])
    ap.add_argument("--batch", type=int, default=cs.B)
    ap.add_argument("--seq", type=int, default=cs.S)
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args()
    if args.device is None and not torch.cuda.is_available():
        print("rwkv6_fp32_gap: torch.cuda.is_available() is False; this "
              "script needs a CUDA device (or --device cpu)",
              file=sys.stderr)
        return 2
    dev = resolve_device(args.device)
    base = get(ARCH).reduced() if args.reduced else get(ARCH)
    cfg = dataclasses.replace(base, n_layers=args.layers, dtype="float32",
                              param_dtype="float32")
    if dev.type == "cuda":
        t0 = time.perf_counter()
        cs._build.build_all()
        cs.emit(phase="build", seconds=time.perf_counter() - t0)
    tokens, targets = next(token_batches(cfg.vocab, args.batch, args.seq,
                                         seed=0, device="cpu"))
    batch = {"tokens": tokens.to(dev), "targets": targets.to(dev)}
    reports = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = one_seed(dev, cfg, batch, seed)
        r["seconds"] = time.perf_counter() - t0
        cs.emit(phase="rwkv6_fp32_gap", arch=ARCH, layers=args.layers,
                batch=[args.batch, args.seq], **r)
        reports.append(r)
    cs.emit(phase="rwkv6_fp32_gap_summary",
            kernel_rel=[r["kernel"]["rel"] for r in reports],
            plain_rel=[r["plain"]["rel"] for r in reports],
            kernel_vs_plain=[r["kernel_vs_plain"]["max_abs_diff"]
                             / r["kernel_vs_plain"]["max_abs"]
                             for r in reports],
            largest_ratio=max(r["ratio"] for r in reports),
            same_leader=all(r["same_leader"] for r in reports))
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)
        device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                      count=torch.cuda.device_count())
    else:
        device = dict(platform="cpu", kind="cpu", count=1)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
