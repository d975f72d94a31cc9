"""Public wrapper of the RG-LRU scan ``h_t = a_t * h_{t-1} + b_t``.

``rglru_scan`` is what ``nn/rglru.py::rglru_apply`` calls on the gates of
every Griffin recurrent block. A tensor on the CPU takes the plain
version (``ref.py``); a tensor on a CUDA device launches the CUDA kernel
(``csrc/rglru_scan.cu``, built by ``kernels/_build.py`` at first use) or
raises — there is no fallback. ``LAUNCHES["rglru_scan"]`` counts kernel
launches, and nothing else.

Training: the kernel has no backward, and neither has the reference's
(``repro/nn/rglru.py`` differentiates a plain scan). So where autograd
needs one — grad enabled and ``a`` or ``b`` requiring it — the wrapper
goes through ``_RGLRUScan``: the kernel's forward, and in the backward
the plain version differentiated at the saved inputs (one launch per
forward, none in the backward).

DTensors (a train step over a device mesh) run per shard: batch over the
batch axes and width over ``"model"``; time is never sharded, so each
shard's recurrence is whole and every shard's launch counts.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

MAX_BATCH = 65535   # grid.y limit: one grid row per batch row

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return bind(_build.load("rglru_scan"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a library built from ``csrc/rglru_scan.cu``
    (or another source of the same entry points) on ``lib``."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan_launch.argtypes = [P, P, P, I, I, I, I, P]
    lib.rglru_scan_launch.restype = ctypes.c_int
    lib.rglru_scan_error_string.argtypes = [ctypes.c_int]
    lib.rglru_scan_error_string.restype = ctypes.c_char_p
    return lib


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, T, W) of one float type -> fp32 (B, T, W) recurrence
    outputs, the carry starting from zero (fold an initial state into
    ``b[:, 0]``)."""
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be one (B, T, W) shape")
    if shd.is_dtensor(a):
        pl = shd.shard_layout(a.device_mesh, a.shape, 0, 2)
        return shd.on_local_shards(rglru_scan, (pl,), (pl, pl),
                                   a.device_mesh)(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return rglru_scan_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {a.device}")
    if b.device != a.device:
        raise ValueError(f"rglru_scan: b on {b.device}, a on {a.device}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError(f"rglru_scan: no kernel for dtypes {a.dtype}, "
                        f"{b.dtype} (one of {sorted(map(str, _DTYPE_CODE))})")
    if a.shape[0] > MAX_BATCH:
        raise ValueError(f"rglru_scan: batch {a.shape[0]} > {MAX_BATCH}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _RGLRUScan.apply(a, b)
    return _forward(a, b)


def _forward(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    h = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    if h.numel():
        launch(h, a.contiguous(), b.contiguous())
    return h


class _RGLRUScan(torch.autograd.Function):
    """The kernel's forward with the plain version's gradient."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _forward(a, b)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need) for t, need in
                   zip(ctx.saved_tensors, ctx.needs_input_grad)]
            out = rglru_scan_ref(*ins)
            want = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(out, want, grad))
        return tuple(next(got) if t.requires_grad else None for t in ins)


def launch(h: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> None:
    """One launch of the CUDA kernel on its operands' device and that device's
    current stream, writing the fp32 ``h`` (contiguous operands).
    ``rglru_scan`` validates and prepares them; benchmarks call this directly
    to time the kernel."""
    B, T, W = a.shape
    lib = _library()
    with torch.cuda.device(a.device):
        err = lib.rglru_scan_launch(
            a.data_ptr(), b.data_ptr(), h.data_ptr(), _DTYPE_CODE[a.dtype],
            B, T, W, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError("rglru_scan launch failed: "
                           + lib.rglru_scan_error_string(err).decode())
    LAUNCHES["rglru_scan"] += 1
