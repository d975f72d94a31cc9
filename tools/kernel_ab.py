"""Times the RG-LRU scan, the fused hypersolver update and the two scans'
backward kernels beside other sources of their ``extern "C"``
interfaces on one GPU, at ``chip_smoke.py``'s cases of each kernel.

    python3 tools/kernel_ab.py [NAME=KERNELS_DIR ...]

from the repository root. ``this`` is the checkout's own kernels (the
sources ``kernels/_build.py::SOURCES`` names for ``rglru_scan``,
``hyper_step``, ``rglru_scan_backward`` and ``rwkv6_scan_backward``);
each NAME names a directory laid out like ``src/repro_torch/kernels``,
holding any of those sources (each kernel is timed across the libraries
that have it), for example an earlier commit's:

    mkdir -p build/parent && git archive HEAD \\
        src/repro_torch/kernels/rglru_scan/csrc \\
        src/repro_torch/kernels/rwkv6_scan/csrc \\
        src/repro_torch/kernels/hyper_step/csrc | tar -x -C build/parent
    python3 tools/kernel_ab.py parent=build/parent/src/repro_torch/kernels

Every source is built with the flags of ``kernels/_build.py`` (one nvcc
each, all started together) and its ptxas lines printed; every library
is held against the plain version on the inputs ``chip_smoke.py`` makes
(``rglru_scan`` and its backward bit for bit; ``hyper_step`` 1e-6 abs +
1e-6 rel in fp32, one ulp in 16 bits, frozen rows equal to z; the WKV6
backward through its operator, dS0 bit for bit and the other gradients
within ``chip_smoke.RWKV6_GRAD_TOL`` by ``chip_smoke.grad_gap``) and
timed cold-L2 in the order A B .. B A in this one process, so each gets
two timings on the same card: ``ms`` under ``chip_smoke.time_ms``'s own
flush (the L2 rewritten before the sleep, as the kernels line is timed)
and ``ms_clean`` under its clean one (the buffer read after the sleep).
Prints the card's name and power limit first, then one JSON line per
library and per case. Exits non-zero without a CUDA device or
when a library disagrees. The WKV6 backward's workspace is sized for
either layout (``wkv6_workspace_floats``), so a source that stores every
forward state and the checkout's, which stores one every 16 tokens, run
through the same operator and the same buffers.
"""
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.hyper_step import ops as hs_ops  # noqa: E402
from repro_torch.kernels.hyper_step.ref import fused_rk_update_ref  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as rg_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    rglru_scan_backward_ref, rglru_scan_ref)
from repro_torch.kernels.rwkv6_scan import ops as rw_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import (  # noqa: E402
    wkv6_scan_backward_ref)

# kernel -> (its ops module, the module's bind function and the name of
# its cached library getter)
KERNELS = {"rglru_scan": (rg_ops, rg_ops.bind, "_library"),
           "hyper_step": (hs_ops, hs_ops.bind, "_library"),
           "rglru_scan_backward": (rg_ops, rg_ops.bind_backward,
                                   "_backward_library"),
           "rwkv6_scan_backward": (rw_ops, rw_ops.bind_backward,
                                   "_backward_library")}


def build(source: str):
    """nvcc ``source`` into build/ab/ (keyed by the bytes of every file
    beside it); returns the library's path and the ptxas lines of each
    entry function's registers and spills."""
    csrc = os.path.dirname(source)
    key = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for f in sorted(os.listdir(csrc)):
        with open(os.path.join(csrc, f), "rb") as fh:
            key.update(f.encode() + b"\0" + fh.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    out = os.path.join(ROOT, "build", "ab",
                       f"{stem}-{key.hexdigest()[:16]}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                           "-o", out, source], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return out, [line.strip() for line in (proc.stdout + proc.stderr)
                 .splitlines() if "Used" in line or "spill" in line
                 or "Compiling entry" in line]


def launch_with(ops, lib: ctypes.CDLL, *args) -> None:
    """``ops.launch`` through library ``lib`` instead of the package's."""
    ops._library = lambda: lib
    ops.launch(*args)


def call_with(kernel, lib: ctypes.CDLL, fn, *args):
    """``fn(*args)`` with kernel ``kernel``'s library getter returning
    ``lib`` instead of the package's."""
    ops, _, getter = KERNELS[kernel]
    setattr(ops, getter, lambda: lib)
    return fn(*args)


def ab_times(libs, fn, flush):
    """Each library's cold-L2 times of ``fn(lib)`` in the order A B .. B A,
    under ``chip_smoke.time_ms``'s default flush (``ms``, the kernels
    line's) and its clean one (``ms_clean``)."""
    ms = {n: [] for n in libs}
    ms_clean = {n: [] for n in libs}
    for name in [*libs, *reversed(libs)]:
        ms[name].append(cs.time_ms(lambda: fn(libs[name]), flush))
        ms_clean[name].append(cs.time_ms(lambda: fn(libs[name]), flush,
                                         clean=True))
    return dict(ms=ms, ms_clean=ms_clean)


def run_rglru(libs, dev, flush) -> bool:
    gen = torch.Generator(device=dev).manual_seed(5)   # chip_smoke's inputs
    ok = True
    for case, shape, dtype in cs.RGLRU_CASES:
        a, b = cs.rglru_inputs(shape, dtype, gen, dev)
        ref = rglru_scan_ref(a, b)
        h = torch.empty_like(ref)
        equal = {}
        for name, lib in libs.items():
            h.fill_(float("nan"))
            launch_with(rg_ops, lib, h, a, b)
            torch.cuda.synchronize()
            equal[name] = bool(torch.equal(h, ref))
            ok &= equal[name]
        times = ab_times(libs, lambda lib: launch_with(rg_ops, lib, h, a, b),
                         flush)
        print(json.dumps(dict(kernel="rglru_scan", case=case,
                              shape=list(shape),
                              dtype=str(dtype).replace("torch.", ""),
                              **times, equal=equal)), flush=True)
    return ok


def run_hyper_step(libs, dev, flush) -> bool:
    gen = torch.Generator(device=dev).manual_seed(0)   # chip_smoke's inputs
    ok = True
    for case in cs.hs_cases():
        z, stages, g, eps, act = cs.hs_inputs(case, gen, dev)
        ref = fused_rk_update_ref(z, stages, g, eps, case.b, case.order,
                                  active=act)
        rows = hs_ops.row_operands(z, eps, case.order, act)
        out = torch.empty_like(z)
        err = {}
        for name, lib in libs.items():
            out.fill_(float("nan"))
            launch_with(hs_ops, lib, out, z, stages, g, *rows, case.b)
            torch.cuda.synchronize()
            try:
                err[name] = cs.hs_check(case, out, ref, z, act)
            except AssertionError as e:
                print(f"kernel_ab: {name}: {e}", file=sys.stderr)
                err[name], ok = None, False
        times = ab_times(libs, lambda lib: launch_with(
            hs_ops, lib, out, z, stages, g, *rows, case.b), flush)
        print(json.dumps(dict(kernel="hyper_step", case=case.name,
                              shape=list(case.shape),
                              dtypes=[str(t).replace("torch.", "")
                                      for t in case.dtypes],
                              **times, max_abs_err=err)), flush=True)
        del z, stages, g, ref, out
    return ok


def run_rglru_backward(libs, dev, flush) -> bool:
    gen = torch.Generator(device=dev).manual_seed(7)   # chip_smoke's inputs
    ok = True
    for row in cs.RGLRU_BACKWARD_CASES:
        case, shape, dtype, kind = row
        g, a, h = cs.rglru_backward_inputs(row, gen, dev)
        want = rglru_scan_backward_ref(g, a, h, dtype)
        da, db = (torch.empty_like(x) for x in want)
        equal = {}
        for name, lib in libs.items():
            da.fill_(float("nan"))
            db.fill_(float("nan"))
            call_with("rglru_scan_backward", lib, rg_ops.launch_backward,
                      da, db, g, a, h)
            torch.cuda.synchronize()
            equal[name] = torch.equal(da, want[0]) and torch.equal(db,
                                                                  want[1])
            ok &= equal[name]
        times = ab_times(libs, lambda lib: call_with(
            "rglru_scan_backward", lib, rg_ops.launch_backward, da, db, g, a,
            h), flush)
        print(json.dumps(dict(kernel="rglru_scan_backward", case=case,
                              shape=list(shape),
                              dtype=str(dtype).replace("torch.", ""),
                              grad=kind, **times, equal=equal)), flush=True)
    return ok


_CHECKOUT_WORKSPACE = rw_ops._workspace_floats


def wkv6_workspace_floats(B: int, T: int, H: int, D: int):
    """The checkout's WKV6 backward workspace (``rw_ops._workspace_floats``)
    with its first part, the states the kernel keeps, grown to B H T D^2
    floats: room for a kernel of the same interface that stores the state
    before every token as well as for one that stores a checkpoint every
    16 tokens. du's partials and their sums keep their layout."""
    n_states, n_part, n_sums = _CHECKOUT_WORKSPACE(B, T, H, D)
    return max(n_states, B * H * T * D * D), n_part, n_sums


def run_wkv6_backward(libs, dev, flush) -> bool:
    gen = torch.Generator(device=dev).manual_seed(8)   # chip_smoke's inputs
    rw_ops._workspace_floats = wkv6_workspace_floats  # the operator's too
    ok = True
    for row in cs.RWKV6_BACKWARD_CASES:
        case, shape, xdt, s0, gs, go_on = row
        b, t, h, d = shape
        args = cs.rwkv6_backward_inputs(row, gen, dev)
        S0 = args[-1]
        want = wkv6_scan_backward_ref(*args)
        rel = {}
        for name, lib in libs.items():
            got = call_with("rwkv6_scan_backward", lib,
                            torch.ops.repro_torch.wkv6_backward, *args)
            torch.cuda.synchronize()
            gaps = [cs.grad_gap(x, y, cs.RWKV6_GRAD_TOL)
                    for x, y in zip(got[:5], want)]
            rel[name] = max(g[0] for g in gaps)
            ok &= all(g[1] for g in gaps) and (
                not s0 or torch.equal(got[5], want[5]))
        grads = [torch.empty_like(x) for x in want[:4]]
        dS0 = torch.empty_like(S0) if s0 else None
        n_states, _, _ = wkv6_workspace_floats(b, t, h, d)
        states = torch.empty(n_states, dtype=torch.float32, device=dev)
        part = torch.empty(shape, dtype=torch.float32, device=dev)
        times = ab_times(libs, lambda lib: call_with(
            "rwkv6_scan_backward", lib, rw_ops.launch_backward, grads, dS0,
            states, part, *args), flush)
        print(json.dumps(dict(kernel="rwkv6_scan_backward", case=case,
                              shape=list(shape),
                              dtype=str(xdt).replace("torch.", ""), S0=s0,
                              gS=gs, go=go_on, **times, max_rel_err=rel)),
              flush=True)
        del S0, args, want, grads, dS0, states, part
    return ok


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 2
    dirs = {"this": os.path.join(ROOT, "src", "repro_torch", "kernels")}
    for arg in argv:
        name, _, path = arg.partition("=")
        if not path or name in dirs:
            print(f"kernel_ab: expected distinct NAME=KERNELS_DIR, got "
                  f"{arg!r}", file=sys.stderr)
            return 2
        dirs[name] = os.path.abspath(path)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    sources = {(k, n): os.path.join(d, _build.SOURCES[k])
               for k in KERNELS for n, d in dirs.items()
               if os.path.exists(os.path.join(d, _build.SOURCES[k]))}
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = dict(zip(sources, pool.map(
            lambda kn: build(sources[kn]), sources)))
    libs = {k: {} for k in KERNELS}
    for (kernel, name), (path, ptxas) in built.items():
        libs[kernel][name] = KERNELS[kernel][1](ctypes.CDLL(path))
        print(json.dumps(dict(kernel=kernel, library=name,
                              source=os.path.relpath(sources[kernel, name],
                                                     ROOT),
                              ptxas=ptxas)),
              flush=True)

    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ok = run_rglru(libs["rglru_scan"], dev, flush)
    ok &= run_hyper_step(libs["hyper_step"], dev, flush)
    ok &= run_rglru_backward(libs["rglru_scan_backward"], dev, flush)
    ok &= run_wkv6_backward(libs["rwkv6_scan_backward"], dev, flush)
    if not ok:
        print("kernel_ab: a library disagrees with the plain version",
              file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
