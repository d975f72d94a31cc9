"""Times the flash attention kernel beside other builds of its ``extern "C"``
interface on one GPU, at ``chip_smoke.py``'s flash cases.

    python3 tools/flash_ab.py [--cases NAME ...] [NAME=CSRC_DIR ...]

from the repository root. ``this`` is the checkout's own kernel,
``src/repro_torch/kernels/flash_attention/csrc/``; each NAME names
another directory holding a ``flash_attention.cu`` of the same entry
points and the headers it includes (for example a copy with one tile
size edited, or an earlier commit's sources unpacked with ``git
archive`` under ``build/``). Every source is built with the flags of
``kernels/_build.py`` (one nvcc each, all started together) and its
ptxas lines printed; every library is held against the plain version on
``chip_smoke.FLASH_CASES``'s inputs (within ``chip_smoke.FLASH_TOL``)
and timed cold-L2 in the order A B .. B A in this one process, so each
gets two timings on the same card. ``--cases`` keeps the named cases.
Prints the card's name and power limit, then one JSON line per library
and per case. Exits non-zero without a CUDA device or when a library
disagrees.
"""
import argparse
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
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

THIS = os.path.join(ROOT, "src/repro_torch/kernels/flash_attention/csrc")


def build(csrc: str):
    """nvcc ``csrc/flash_attention.cu`` into build/ab/ (keyed by the bytes
    of every file in ``csrc``); returns the library's path and the ptxas
    lines of registers, shared memory and spills."""
    key = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for name in sorted(os.listdir(csrc)):
        with open(os.path.join(csrc, name), "rb") as f:
            key.update(name.encode() + b"\0" + f.read())
    out = os.path.join(ROOT, "build", "ab",
                       f"flash-{key.hexdigest()[:16]}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out,
                           os.path.join(csrc, "flash_attention.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {csrc}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return out, [line.strip() for line in (proc.stdout + proc.stderr)
                 .splitlines() if "Used" in line or "spill" in line
                 or "Compiling entry" in line]


def load(path: str) -> ctypes.CDLL:
    """The library at ``path`` with ``ops._library``'s signatures."""
    fa_ops._library.cache_clear()
    build_load = _build.load
    _build.load = lambda name: ctypes.CDLL(path)
    try:
        return fa_ops._library()
    finally:
        _build.load = build_load
        fa_ops._library.cache_clear()


def launch_with(lib: ctypes.CDLL, *args) -> None:
    """``ops.launch`` through library ``lib`` instead of the package's."""
    saved = fa_ops._library
    fa_ops._library = lambda: lib
    try:
        fa_ops.launch(*args)
    finally:
        fa_ops._library = saved


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", nargs="+", default=None)
    ap.add_argument("sources", nargs="*")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ab: needs a CUDA device", file=sys.stderr)
        return 2
    sources = {"this": THIS}
    for arg in args.sources:
        name, _, path = arg.partition("=")
        if not path or name in sources:
            print(f"flash_ab: expected distinct NAME=CSRC_DIR, got {arg!r}",
                  file=sys.stderr)
            return 2
        sources[name] = os.path.abspath(path)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources.values())))
    libs = {}
    for name, (path, ptxas) in built.items():
        libs[name] = load(path)
        print(json.dumps(dict(library=name, source=os.path.relpath(
            sources[name], ROOT), ptxas=ptxas)), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)   # chip_smoke's inputs
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ok = True
    for case, (b, sq, sk, h, kv, hd), dtype, causal, window in \
            cs.FLASH_CASES:
        def draw(s, n):
            return torch.randn((b, s, n, hd), generator=gen,
                               device=dev).to(dtype)
        q, k, v = draw(sq, h), draw(sk, kv), draw(sk, kv)
        if args.cases and case not in args.cases:
            continue
        ref = attention_ref(q, k, v, causal=causal, window=window).float()
        out = torch.empty_like(q)
        tol = cs.FLASH_TOL[dtype]
        err, ms = {}, {n: [] for n in libs}
        for name, lib in libs.items():
            out.fill_(float("nan"))
            launch_with(lib, out, q, k, v, causal, window)
            torch.cuda.synchronize()
            err[name] = float((out.float() - ref).abs().max())
            ok &= bool(torch.allclose(out.float(), ref, rtol=tol, atol=tol))
        for name in [*libs, *reversed(libs)]:
            ms[name].append(cs.time_ms(
                lambda: launch_with(libs[name], out, q, k, v, causal,
                                    window), flush))
        print(json.dumps(dict(case=case, shape=[b, sq, sk, h, kv, hd],
                              dtype=str(dtype).replace("torch.", ""),
                              causal=causal, window=window, ms=ms,
                              max_abs_err=err)), flush=True)
    if not ok:
        print("flash_ab: a library disagrees with the plain version",
              file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
