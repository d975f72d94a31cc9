"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one ``csrc/*.cu`` file with a plain ``extern "C"``
interface (no PyTorch headers, so a build takes seconds), with any
headers it includes beside it in ``csrc/``, compiled as

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -Xptxas -v -o <lib>.so <source>.cu

into ``build/kernels/`` at the repository root (listed in .gitignore).
The library's file name carries a hash of the sources and the flags, so
a build runs at first use, an edited source or header rebuilds, and an
unchanged one loads the library already built. Nothing here runs at
import time: this module imports on a machine without nvcc or a GPU,
where only the plain versions of the kernels run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> its CUDA source, relative to this directory
SOURCES: Dict[str, str] = {
    "hyper_step": "hyper_step/csrc/hyper_step.cu",
    "flash_attention": "flash_attention/csrc/flash_attention.cu",
    "rglru_scan": "rglru_scan/csrc/rglru_scan.cu",
    "rwkv6_scan": "rwkv6_scan/csrc/rwkv6_scan.cu",
    "rglru_scan_backward": "rglru_scan/csrc/rglru_scan_backward.cu",
    "rwkv6_scan_backward": "rwkv6_scan/csrc/rwkv6_scan_backward.cu",
}

# kernel name -> what nvcc/ptxas printed for its last build in this process
# (registers, shared memory and spills per kernel)
BUILD_LOG: Dict[str, str] = {}

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin (default "
        "/usr/local/cuda): the port's CUDA kernels are built from source at "
        "first use")


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library is built: the file name carries a
    hash of the flags and of every file in the source's directory (names
    and contents), so an edited header beside the ``.cu`` rebuilds too."""
    csrc = (KERNELS_DIR / SOURCES[name]).parent
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(p for p in csrc.rglob("*") if p.is_file()):
        h.update(f.relative_to(csrc).as_posix().encode() + b"\0")
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile kernel ``name`` unless its library is already built; returns
    the library's path. Writes to a temporary name and renames, so
    concurrent builders never load a half-written library."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(KERNELS_DIR / SOURCES[name])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name} ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOG[name] = proc.stdout + proc.stderr
    return out


def build_all() -> Dict[str, Path]:
    """Build every kernel, one nvcc process per source, all started
    together. Returns name -> library path."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        futures = {name: pool.submit(build, name) for name in SOURCES}
        return {name: fut.result() for name, fut in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        if name not in _LOADED:
            _LOADED[name] = ctypes.CDLL(str(build(name)))
        return _LOADED[name]
