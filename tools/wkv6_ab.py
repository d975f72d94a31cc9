"""Times the WKV6 kernel beside other sources of its ``extern "C"``
interface on one GPU, at ``chip_smoke.py``'s WKV6 cases.

    python3 tools/wkv6_ab.py [NAME=SOURCE.cu ...]

from the repository root. ``this`` is the checkout's own kernel,
``src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu``; each NAME
names another source of the same entry points, for example an earlier
commit's (unpacked with ``git archive`` under ``build/``) or
``tools/wkv6_quad.cu`` (4 threads per state column, one column each).
Every source is built with the flags of ``kernels/_build.py`` (one nvcc
each, all started together) and its ptxas lines printed; every library
is held against the plain version on the inputs ``chip_smoke.py`` makes
(max abs error at most 2e-6 of the largest plain output, the final state
bit for bit) and timed cold-L2 in the order A B .. B A in this one
process, so each gets two timings on the same card. Prints the card's
name and power limit, then one JSON line per library and per case.
Exits non-zero without a CUDA device or when a library disagrees.
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
from repro_torch.kernels.rwkv6_scan import ops as rw_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import wkv6_scan_ref  # noqa: E402

THIS = os.path.join(ROOT, "src/repro_torch/kernels", _build.SOURCES["rwkv6_scan"])


def build(source: str):
    """nvcc ``source`` into build/ab/ (keyed by its bytes); returns the
    library's path and the ptxas lines of registers and spills."""
    with open(source, "rb") as f:
        key = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode() + f.read())
    out = os.path.join(ROOT, "build", "ab", f"wkv6-{key.hexdigest()[:16]}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out,
                           source], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return out, [line.strip() for line in (proc.stdout + proc.stderr)
                 .splitlines() if "Used" in line or "spill" in line]


def load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_scan_launch.argtypes = [P] * 10 + [I] * 4 + [P]
    lib.rwkv6_scan_launch.restype = ctypes.c_int
    lib.rwkv6_scan_error_string.argtypes = [ctypes.c_int]
    lib.rwkv6_scan_error_string.restype = ctypes.c_char_p
    return lib


def launch_with(lib: ctypes.CDLL, *args) -> None:
    """``ops.launch`` through library ``lib`` instead of the package's."""
    rw_ops._library = lambda: lib
    rw_ops.launch(*args)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("wkv6_ab: needs a CUDA device", file=sys.stderr)
        return 2
    sources = {"this": THIS}
    for arg in argv:
        name, _, path = arg.partition("=")
        if not path or name in sources:
            print(f"wkv6_ab: expected distinct NAME=SOURCE.cu, got {arg!r}",
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
    gen = torch.Generator(device=dev).manual_seed(6)   # chip_smoke's inputs
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ok = True
    for case, (b, t, h, d), xdt, wdt, udt, state in cs.RWKV6_CASES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        r, k, v = (randn(b, t, h, d).to(xdt) for _ in range(3))
        w0 = torch.linspace(-6.0, -1.0, h * d, device=dev).reshape(h, d)
        w = torch.exp(-torch.exp(w0 + 0.1 * randn(b, t, h, d))).to(wdt)
        u = (0.3 * randn(h, d)).to(udt)
        S0 = randn(b, h, d, d) if state else None
        o_ref, s_ref = wkv6_scan_ref(r, k, v, w, u, S0)
        scale = float(o_ref.abs().max())
        o = torch.empty((b, t, h, d), dtype=torch.float32, device=dev)
        s = torch.empty_like(S0) if state else None
        err, same, ms = {}, {}, {n: [] for n in libs}
        for name, lib in libs.items():
            o.fill_(float("nan"))
            launch_with(lib, o, r, k, v, w, u, S0, s)
            torch.cuda.synchronize()
            err[name] = float((o - o_ref).abs().max()) / scale
            same[name] = bool(torch.equal(s, s_ref)) if state else None
            ok &= err[name] <= cs.RWKV6_TOL and same[name] is not False
        for name in [*libs, *reversed(libs)]:
            ms[name].append(cs.time_ms(
                lambda: launch_with(libs[name], o, r, k, v, w, u, S0, s),
                flush))
        print(json.dumps(dict(case=case, shape=[b, t, h, d], ms=ms,
                              err_over_max_plain=err, state_equal=same)),
              flush=True)
    if not ok:
        print("wkv6_ab: a library disagrees with the plain version",
              file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
