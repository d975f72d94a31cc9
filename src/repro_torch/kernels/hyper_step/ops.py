"""Public wrappers of the fused hypersolver update.

``fused_rk_update`` is the entry point ``core/integrate.py::Integrator.step``
calls on the fused path: one pass for the b-weighted stage combination of
any explicit tableau, the optional eps^{p+1} correction, and the multi-rate
``active`` freeze mask. ``eps`` is a runtime operand — a Python float, a
0-d tensor or a per-sample ``(B,)`` row all take the same kernel.

A tensor on the CPU takes the plain version (``ref.py``); a tensor on a
CUDA device launches the CUDA kernel (``csrc/hyper_step.cu``, built by
``kernels/_build.py`` at first use) or raises — there is no fallback.
``LAUNCHES["hyper_step"]`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.hyper_step.ref import fused_rk_update_ref

MAX_STAGES = 6      # live stages the kernel's parameter struct holds
MAX_BATCH = 65535   # grid.y limit: one grid row per batch row
VEC = 8             # elements per thread; rows of a multiple of VEC vectorize

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return bind(_build.load("hyper_step"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a library built from ``csrc/hyper_step.cu``
    (or another source of the same entry points) on ``lib``."""
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hyper_step_launch.argtypes = [P, P, I, P, P, P, I, P, I, P, P, P,
                                      LL, LL, I, P]
    lib.hyper_step_launch.restype = ctypes.c_int
    lib.hyper_step_error_string.argtypes = [ctypes.c_int]
    lib.hyper_step_error_string.restype = ctypes.c_char_p
    return lib


def _eps_tensor(eps, dev) -> torch.Tensor:
    """eps as float32 on ``dev``. A Python number is filled there: a
    blocking host-to-device copy of it would cost a host sync per step."""
    if isinstance(eps, (int, float)):
        return torch.full((), float(eps), dtype=torch.float32, device=dev)
    return torch.as_tensor(eps, dtype=torch.float32, device=dev)


def row_operands(z: torch.Tensor, eps, order: int, active=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's per-row operands on z's device: float32 eps and
    eps**(order+1) rows and an int32 active row (all ones without a
    mask), one entry per batch row of ``_rows``."""
    dev = z.device
    eps_t = _eps_tensor(eps, dev)
    B, _ = _rows(z, eps_t, active)
    eps_row = eps_t.reshape(-1).expand(B).contiguous()
    act_row = (torch.ones(B, dtype=torch.int32, device=dev) if active is None
               else torch.as_tensor(active, device=dev).to(torch.int32)
               .reshape(B).contiguous())
    return eps_row, eps_row ** (order + 1), act_row


def _rows(z: torch.Tensor, eps: torch.Tensor, active) -> Tuple[int, int]:
    """(B, N): the batch rows the update runs over and the elements per
    row. A per-sample eps or an active mask makes the leading axis the
    batch; otherwise the whole leaf is one row."""
    if eps.ndim == 1 or active is not None:
        B = eps.shape[0] if eps.ndim == 1 else z.shape[0]
        if z.ndim == 0 or z.shape[0] != B:
            raise ValueError(
                f"per-sample eps/active of length {B} need a matching "
                f"leading batch axis, got leaf shape {tuple(z.shape)}")
        return B, int(np.prod(z.shape[1:], dtype=np.int64))
    if eps.ndim:
        raise ValueError(f"eps must be a scalar or a (B,) row, got shape "
                         f"{tuple(eps.shape)}")
    return 1, z.numel()


def fused_rk_update(z: torch.Tensor, stages: Sequence[torch.Tensor],
                    g: Optional[torch.Tensor], eps,
                    b: Tuple[float, ...], order: int = 1,
                    active=None) -> torch.Tensor:
    """``where(active, z + eps*sum_j b[j]*stages[j] + eps^{order+1}*g, z)``
    over any-shaped tensors, accumulated in fp32, returned in z's dtype.

    ``eps``: Python float, 0-d tensor, or per-sample ``(B,)`` row (then
    every tensor carries the leading batch axis B). ``g`` may be None;
    ``active`` is an optional ``(B,)`` bool/int row (None = every row
    steps). The stages and g may be stored in another float type than z.
    """
    if len(stages) != len(b):
        raise ValueError(f"{len(stages)} stages for {len(b)} weights b")
    if z.device.type == "cpu":
        return fused_rk_update_ref(z, stages, g, eps, b, order, active)
    if z.device.type != "cuda":
        raise ValueError(f"fused_rk_update: no kernel for device {z.device}")
    dev = z.device
    eps_t = _eps_tensor(eps, dev)
    B, n = _rows(z, eps_t, active)
    operands = [z, *stages] + ([g] if g is not None else [])
    for t in operands:
        if t.device != dev:
            raise ValueError(f"fused_rk_update: operand on {t.device}, "
                             f"state on {dev}")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"fused_rk_update: no kernel for dtype {t.dtype} "
                            f"(have {sorted(map(str, _DTYPE_CODE))})")
        if t.shape != z.shape:
            raise ValueError(f"fused_rk_update: operand shape "
                             f"{tuple(t.shape)} != state {tuple(z.shape)}")
    if len(stages) > MAX_STAGES:
        raise ValueError(f"fused_rk_update: {len(stages)} live stages, the "
                         f"kernel takes at most {MAX_STAGES}")
    if B > MAX_BATCH:
        raise ValueError(f"fused_rk_update: batch {B} > {MAX_BATCH}")
    if n == 0:
        return z.clone()
    eps_row, epsp_row, act_row = row_operands(z, eps_t, order, active)
    zc = z.contiguous()
    out = torch.empty_like(zc)
    launch(out, zc, [r.contiguous() for r in stages],
           g.contiguous() if g is not None else None,
           eps_row, epsp_row, act_row, b)
    return out


def launch(out: torch.Tensor, z: torch.Tensor, stages: Sequence[torch.Tensor],
           g: Optional[torch.Tensor], eps_row: torch.Tensor,
           epsp_row: torch.Tensor, act_row: torch.Tensor,
           b: Tuple[float, ...]) -> None:
    """One launch of the CUDA kernel on its operands' device and that device's
    current stream, writing ``out`` (contiguous operands; rows: float32 eps and
    eps**(order+1), int32 active). ``fused_rk_update`` validates and prepares
    the operands; benchmarks call this directly to time the kernel alone."""
    B = eps_row.shape[0]
    n = z.numel() // B
    ops = [z, out, *stages] + ([g] if g is not None else [])
    vec = int(n % VEC == 0 and all(t.data_ptr() % 16 == 0 for t in ops))
    lib = _library()
    k = max(len(stages), 1)
    stage_ptrs = (ctypes.c_void_p * k)(*[t.data_ptr() for t in stages])
    stage_codes = (ctypes.c_int * k)(*[_DTYPE_CODE[t.dtype] for t in stages])
    b_arr = (ctypes.c_float * k)(*[float(bj) for bj in b])
    with torch.cuda.device(z.device):
        err = lib.hyper_step_launch(
            z.data_ptr(), out.data_ptr(), _DTYPE_CODE[z.dtype],
            stage_ptrs, stage_codes, b_arr, len(stages),
            g.data_ptr() if g is not None else None,
            _DTYPE_CODE[g.dtype] if g is not None else 0,
            eps_row.data_ptr(), epsp_row.data_ptr(), act_row.data_ptr(),
            B, n, vec, torch.cuda.current_stream(z.device).cuda_stream)
    if err != 0:
        raise RuntimeError("hyper_step launch failed: "
                           + lib.hyper_step_error_string(err).decode())
    LAUNCHES["hyper_step"] += 1


def hyper_step(z: torch.Tensor, psi: torch.Tensor, g: torch.Tensor,
               eps, order: int = 1) -> torch.Tensor:
    """Fused z + eps*psi + eps^{order+1}*g — the single-stage case
    b = (1.0,) of ``fused_rk_update``."""
    return fused_rk_update(z, (psi,), g, eps, (1.0,), order)
