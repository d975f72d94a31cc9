"""Public wrapper of the RG-LRU scan ``h_t = a_t * h_{t-1} + b_t``, and
the operators it calls.

``rglru_scan`` is what ``nn/rglru.py::rglru_apply`` calls on the gates of
every Griffin recurrent block. It checks its operands and calls the
PyTorch operator ``torch.ops.repro_torch.rglru_scan``, for CPU and CUDA
tensors alike. The operator's implementations:
  * CUDA: one launch of the CUDA kernel (``csrc/rglru_scan.cu``, built by
    ``kernels/_build.py`` at first use) or an error; there is no
    fallback. ``LAUNCHES["rglru_scan"]`` counts launches, and nothing
    else;
  * CPU: the plain version (``ref.py::rglru_scan_ref``);
  * fake (``register_fake``): the fp32 output's shape and dtype only, so
    a trace on fake tensors (``launch/dryrun.py``) launches and loops
    over nothing.

Training: the reference has no Pallas backward (``repro/nn/rglru.py``
differentiates a plain scan, which XLA compiles into one loop on the
device). The operator's gradient (``register_autograd``) is a second
operator, ``repro_torch::rglru_scan_backward``, with implementations:
  * CUDA: one launch of the backward kernel
    (``csrc/rglru_scan_backward.cu``, the plain version's recurrence
    backward in time, bit for bit) or an error; no fallback.
    ``LAUNCHES["rglru_scan_backward"]`` counts its launches;
  * CPU: the plain version (``ref.py::rglru_scan_backward_ref``);
  * fake: da and db's shapes and dtypes.
A training step launches the forward kernel once per forward and the
backward kernel once per backward. Both operators carry a FLOP formula
for ``torch.utils.flop_counter`` (0: the recurrence is elementwise, and
the counter counts matrix products), and the backward the bytes of its
CUDA implementation's workspace (``kernels.WORKSPACE``, 0: the kernel
writes da and db directly); the dry run meters both.

DTensors (a train step over a device mesh) run per shard: batch over the
batch axes and width over ``"model"``; time is never sharded, so each
shard's recurrence is whole and every shard's launch counts.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.distributed import sharding as shd
from repro_torch.kernels import LAUNCHES, WORKSPACE, _build
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_backward_ref,
                                                rglru_scan_ref)

MAX_BATCH = 65535   # grid.y limit: one grid row per batch row

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return bind(_build.load("rglru_scan"))


@functools.lru_cache(maxsize=1)
def _backward_library() -> ctypes.CDLL:
    return bind_backward(_build.load("rglru_scan_backward"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a library built from ``csrc/rglru_scan.cu``
    (or another source of the same entry points) on ``lib``."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan_launch.argtypes = [P, P, P, I, I, I, I, P]
    lib.rglru_scan_launch.restype = ctypes.c_int
    lib.rglru_scan_error_string.argtypes = [ctypes.c_int]
    lib.rglru_scan_error_string.restype = ctypes.c_char_p
    return lib


def bind_backward(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a library built from
    ``csrc/rglru_scan_backward.cu`` (or another source of the same entry
    points) on ``lib``."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan_backward_launch.argtypes = [P] * 7 + [I] * 3 + [P]
    lib.rglru_scan_backward_launch.restype = ctypes.c_int
    lib.rglru_scan_backward_error_string.argtypes = [ctypes.c_int]
    lib.rglru_scan_backward_error_string.restype = ctypes.c_char_p
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
        return _scan(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {a.device}")
    if b.device != a.device:
        raise ValueError(f"rglru_scan: b on {b.device}, a on {a.device}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError(f"rglru_scan: no kernel for dtypes {a.dtype}, "
                        f"{b.dtype} (one of {sorted(map(str, _DTYPE_CODE))})")
    if a.shape[0] > MAX_BATCH:
        raise ValueError(f"rglru_scan: batch {a.shape[0]} > {MAX_BATCH}")
    return _scan(a, b)


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=(),
                         device_types="cuda",
                         schema="(Tensor a, Tensor b) -> Tensor")
def _scan(a, b):
    """The kernel: one launch writing the contiguous fp32 h."""
    h = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    if h.numel():
        launch(h, a.contiguous(), b.contiguous())
    return h


@_scan.register_kernel("cpu")
def _(a, b):
    return rglru_scan_ref(a, b)


@_scan.register_fake
def _(a, b):
    return a.new_empty(a.shape, dtype=torch.float32)


@torch.library.custom_op(
    "repro_torch::rglru_scan_backward", mutates_args=(),
    device_types="cuda",
    schema="(Tensor grad, Tensor a, Tensor h, ScalarType b_dtype) "
           "-> (Tensor, Tensor)")
def _scan_backward(grad, a, h, b_dtype):
    """(da, db) of the scan at its gates ``a`` and fp32 output ``h``: the
    backward kernel, one launch writing da in a's dtype and db in
    ``b_dtype``, contiguous; grad, a and h are read through their
    strides."""
    bad = [t for t in (grad.dtype, a.dtype, h.dtype, b_dtype)
           if t not in _DTYPE_CODE]
    if bad:
        raise TypeError(f"rglru_scan_backward: no kernel for dtypes {bad} "
                        f"(one of {sorted(map(str, _DTYPE_CODE))})")
    if any(t.device != a.device for t in (grad, h)):
        raise ValueError("rglru_scan_backward: operands on "
                         f"{[str(t.device) for t in (grad, a, h)]}, not "
                         "one device")
    da = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    db = torch.empty(a.shape, dtype=b_dtype, device=a.device)
    if da.numel():
        launch_backward(da, db, grad, a, h)
    return da, db


@_scan_backward.register_kernel("cpu")
def _(grad, a, h, b_dtype):
    return rglru_scan_backward_ref(grad, a, h, b_dtype)


@_scan_backward.register_fake
def _(grad, a, h, b_dtype):
    return a.new_empty(a.shape), a.new_empty(a.shape, dtype=b_dtype)


def _setup_context(ctx, inputs, output):
    a, b = inputs
    ctx.save_for_backward(a, output)
    ctx.b_dtype = b.dtype


def _backward(ctx, grad):
    a, h = ctx.saved_tensors
    da, db = _scan_backward(grad, a, h, ctx.b_dtype)
    return tuple(g if need else None
                 for g, need in zip((da, db), ctx.needs_input_grad))


_scan.register_autograd(_backward, setup_context=_setup_context)


@register_flop_formula([torch.ops.repro_torch.rglru_scan,
                        torch.ops.repro_torch.rglru_scan_backward])
def _scan_flops(*args, **kwargs) -> int:
    """The plain version's count: its loop multiplies elementwise only."""
    return 0


def backward_workspace(grad, a, h, b_dtype) -> int:
    """Bytes the backward's CUDA implementation holds beyond its inputs and
    outputs: none, since the kernel reads its operands in place and writes
    da and db directly."""
    return 0


WORKSPACE[torch.ops.repro_torch.rglru_scan_backward] = backward_workspace


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


def launch_backward(da: torch.Tensor, db: torch.Tensor, grad: torch.Tensor,
                    a: torch.Tensor, h: torch.Tensor) -> None:
    """One launch of the backward kernel on its operands' device and that
    device's current stream, writing the contiguous ``da`` and ``db`` (each
    in its own dtype); grad, a and h (B, T, W) are read through their
    strides. The operator validates them; benchmarks call this directly to
    time the kernel."""
    B, T, W = a.shape
    strides = (ctypes.c_longlong * 9)(*(s for t in (grad, a, h)
                                        for s in t.stride()))
    codes = (ctypes.c_int * 5)(*(_DTYPE_CODE[t.dtype]
                                 for t in (grad, a, h, da, db)))
    lib = _backward_library()
    with torch.cuda.device(a.device):
        err = lib.rglru_scan_backward_launch(
            grad.data_ptr(), a.data_ptr(), h.data_ptr(), da.data_ptr(),
            db.data_ptr(), ctypes.cast(strides, ctypes.c_void_p),
            ctypes.cast(codes, ctypes.c_void_p), B, T, W,
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError("rglru_scan_backward launch failed: "
                           + lib.rglru_scan_backward_error_string(err)
                           .decode())
    LAUNCHES["rglru_scan_backward"] += 1
