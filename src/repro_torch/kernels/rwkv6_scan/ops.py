"""Public wrapper of the WKV6 recurrence of RWKV-6's time mix.

``wkv6`` is what ``nn/rwkv6.py::rwkv6_time_mix`` calls on every ``rwkv``
block. Tensors on the CPU take the plain version (``ref.py``); tensors
on a CUDA device launch the CUDA kernel (``csrc/rwkv6_scan.cu``, built by
``kernels/_build.py`` at first use) or raise — there is no fallback.
``LAUNCHES["rwkv6_scan"]`` counts kernel launches, and nothing else.

The kernel reads r, k, v, w in (B, T, H, D) through their strides, each
operand in its own float type (the serving path gives bf16 r, k, v, u
and fp32 w), and converts to fp32 on load: nothing is upcast, padded or
transposed here, and only an operand whose last axis is not contiguous
is copied.

Training: the kernel has no backward, and neither has the reference's
(``repro/nn/rwkv6.py`` differentiates a plain scan). So where autograd
needs one — grad enabled and any of r, k, v, w, u, S0 requiring it —
the wrapper goes through ``_WKV6``: the kernel's forward, and in the
backward the plain version differentiated at the saved inputs, through
``o`` and, with ``want_state``, ``S_T`` (one launch per forward, none in
the backward).

DTensors (a train step over a device mesh) run per shard: batch over the
batch axes and heads over ``"model"`` (u and the state with them); time
is never sharded, so each shard's recurrence is whole and every shard's
launch counts.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.rwkv6_scan.ref import wkv6_scan_ref

HEAD_SIZES = (8, 16, 32, 64, 128)   # D values the kernel is built for
MAX_BATCH = 65535                   # grid.y limit: one grid row per batch row
MAX_HEADS = 2 ** 31 - 1             # grid.x limit: one grid column per head

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load("rwkv6_scan")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_scan_launch.argtypes = [P] * 10 + [I] * 4 + [P]
    lib.rwkv6_scan_launch.restype = ctypes.c_int
    lib.rwkv6_scan_error_string.argtypes = [ctypes.c_int]
    lib.rwkv6_scan_error_string.restype = ctypes.c_char_p
    return lib


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, S0: Optional[torch.Tensor] = None, *,
         want_state: bool = False
         ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """r, k, v, w: (B, T, H, D); u: (H, D); S0: optional (B, H, D, D)
    initial state (zeros if None). Returns the fp32 output o (B, T, H, D),
    or ``(o, S_T)`` with the fp32 final state when ``want_state``."""
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"wkv6: r, k, v, w {[tuple(t.shape) for t in (r, k, v, w)]}"
                         " must be one (B, T, H, D) shape")
    B, T, H, D = r.shape
    if u.shape != (H, D):
        raise ValueError(f"wkv6: u {tuple(u.shape)} is not (H, D) = {(H, D)}")
    if S0 is not None and S0.shape != (B, H, D, D):
        raise ValueError(f"wkv6: S0 {tuple(S0.shape)} is not (B, H, D, D) = "
                         f"{(B, H, D, D)}")
    if shd.is_dtensor(r):
        return _sharded(r, k, v, w, u, S0, want_state)
    tensors = [t for t in (r, k, v, w, u, S0) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        o, S_T = wkv6_scan_ref(r, k, v, w, u, S0)
        return (o, S_T) if want_state else o
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: no kernel for device {r.device}")
    if any(t.device != r.device for t in tensors):
        raise ValueError(f"wkv6: operands on {[str(t.device) for t in tensors]}"
                         ", not one device")
    bad = [t.dtype for t in (r, k, v, w, u) if t.dtype not in _DTYPE_CODE]
    if bad:
        raise TypeError(f"wkv6: no kernel for dtypes {bad} (one of "
                        f"{sorted(map(str, _DTYPE_CODE))})")
    if D not in HEAD_SIZES:
        raise ValueError(f"wkv6: no kernel for head size {D} (one of "
                         f"{HEAD_SIZES})")
    if B > MAX_BATCH or H > MAX_HEADS:
        raise ValueError(f"wkv6: grid (H {H}, B {B}) exceeds ({MAX_HEADS}, "
                         f"{MAX_BATCH})")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _WKV6.apply(want_state, r, k, v, w, u, S0)
    return _forward(want_state, r, k, v, w, u, S0)


def _sharded(r, k, v, w, u, S0, want_state):
    """``wkv6`` of DTensors on each device's local shards."""
    from torch.distributed.tensor import Partial, Shard
    mesh = r.device_mesh
    x = shd.shard_layout(mesh, r.shape, 0, 2)
    up = shd.shard_layout(mesh, u.shape, None, 0)
    sp = shd.shard_layout(mesh, (r.shape[0], r.shape[2]), 0, 1)
    outs = (x, sp) if want_state else (x,)

    def local(r, k, v, w, u, S0):
        return wkv6(r, k, v, w, u, S0, want_state=want_state)

    # u is whole over the batch axes, so each batch shard's gradient for
    # it is a partial sum over them
    ug = tuple(Partial() if p == Shard(0) else q for p, q in zip(x, up))
    ins = (x, x, x, x, up, None if S0 is None else sp)
    return shd.on_local_shards(
        local, outs, ins, mesh, in_grad_placements=ins[:4] + (ug, ins[5]),
    )(r, k, v, w, u, S0)


def _forward(want_state, r, k, v, w, u, S0):
    B, T, H, D = r.shape
    o = torch.empty((B, T, H, D), dtype=torch.float32, device=r.device)
    S_T = (torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
           if want_state else None)
    if S0 is not None:
        S0 = S0.float().contiguous()
    if o.numel() == 0:          # T = 0 (or B, H = 0): nothing to launch
        if want_state and S0 is not None:
            S_T.copy_(S0)
        elif want_state:
            S_T.zero_()
        return (o, S_T) if want_state else o
    r, k, v, w = (t if t.stride(-1) == 1 else t.contiguous()
                  for t in (r, k, v, w))
    launch(o, r, k, v, w, u.contiguous(), S0, S_T)
    return (o, S_T) if want_state else o


class _WKV6(torch.autograd.Function):
    """The kernel's forward with the plain version's gradient."""

    @staticmethod
    def forward(ctx, want_state, r, k, v, w, u, S0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, S0)
        return _forward(want_state, r, k, v, w, u, S0)

    @staticmethod
    def backward(ctx, *grads):
        if all(g is None for g in grads):
            return (None,) * 7
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors,
                                   ctx.needs_input_grad[1:])]
            want = [t for t in ins if t is not None and t.requires_grad]
            # (o, S_T) of the plain version against (grad o[, grad S_T])
            outs = [(o, g) for o, g in zip(wkv6_scan_ref(*ins), grads)
                    if g is not None]
            got = iter(torch.autograd.grad([o for o, _ in outs], want,
                                           [g for _, g in outs],
                                           allow_unused=True))
        return (None, *(next(got) if t is not None and t.requires_grad
                        else None for t in ins))


def launch(o: torch.Tensor, r: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
           S0: Optional[torch.Tensor], S_T: Optional[torch.Tensor]) -> None:
    """One launch of the CUDA kernel on its operands' device and that device's
    current stream, writing the contiguous fp32 ``o`` and, if given, ``S_T``.
    r, k, v, w are read through their strides (last axis contiguous), u and S0
    contiguous. ``wkv6`` validates and prepares them; benchmarks call this
    directly to time the kernel."""
    B, T, H, D = r.shape
    strides = (ctypes.c_longlong * 12)(*(s for t in (r, k, v, w)
                                         for s in t.stride()[:3]))
    codes = (ctypes.c_int * 5)(*(_DTYPE_CODE[t.dtype]
                                 for t in (r, k, v, w, u)))
    lib = _library()
    with torch.cuda.device(r.device):
        err = lib.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            None if S0 is None else S0.data_ptr(), o.data_ptr(),
            None if S_T is None else S_T.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p),
            ctypes.cast(codes, ctypes.c_void_p), B, T, H, D,
            torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError("rwkv6_scan launch failed: "
                           + lib.rwkv6_scan_error_string(err).decode())
    LAUNCHES["rwkv6_scan"] += 1
