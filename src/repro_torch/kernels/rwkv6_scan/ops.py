"""Public wrapper of the WKV6 recurrence of RWKV-6's time mix, and the
operators it calls.

``wkv6`` is what ``nn/rwkv6.py::rwkv6_time_mix`` calls on every ``rwkv``
block. It checks its operands and calls the PyTorch operator
``torch.ops.repro_torch.wkv6(r, k, v, w, u, S0, want_state) -> (o, S_T)``
for CPU and CUDA tensors alike; an operator returns no None, so S_T is
an empty fp32 tensor of shape (0,) when ``want_state`` is false, and the
wrapper returns o alone. The operator's implementations:
  * CUDA: one launch of the CUDA kernel (``csrc/rwkv6_scan.cu``, built by
    ``kernels/_build.py`` at first use) or an error; there is no
    fallback. ``LAUNCHES["rwkv6_scan"]`` counts launches, and nothing
    else. The kernel reads r, k, v, w in (B, T, H, D) through their
    strides, each operand in its own float type (the serving path gives
    bf16 r, k, v, u and fp32 w), and converts to fp32 on load: nothing is
    upcast, padded or transposed here, and only an operand whose last
    axis is not contiguous is copied;
  * CPU: the plain version (``ref.py::wkv6_scan_ref``);
  * fake (``register_fake``): the fp32 outputs' shapes and dtypes only,
    so a trace on fake tensors (``launch/dryrun.py``) launches and loops
    over nothing.

Training: the reference has no Pallas backward (``repro/nn/rwkv6.py``
differentiates a plain scan, which XLA compiles into one loop on the
device). The operator's gradient (``register_autograd``), through o and
S_T to r, k, v, w, u and S0, is a second operator,
``repro_torch::wkv6_backward``, with implementations:
  * CUDA: one launch of the backward kernel
    (``csrc/rwkv6_scan_backward.cu``: a checkpoint of the forward state
    every ``CHECKPOINT_EVERY`` tokens in a workspace, then chunk by chunk
    from the last, the chunk's states recomputed on chip and the plain
    version's recurrences backward in time, dS0 bit for bit and the
    other gradients to a regrouping of their sums) or an error; no
    fallback. ``LAUNCHES["rwkv6_scan_backward"]`` counts its launches.
    u's gradient is the sum of the kernel's per-token partials, taken
    here over the batch and then over time;
  * CPU: the plain version (``ref.py::wkv6_scan_backward_ref``);
  * fake: the gradients' shapes and dtypes.
A training step launches the forward kernel once per forward and the
backward kernel once per backward. Both operators carry a FLOP formula
for ``torch.utils.flop_counter``, the plain loop's count (2 B T H D^2 in
the forward, 4 B T H D^2 in the backward: its matrix products), and the
backward the bytes of its CUDA implementation's workspace
(``backward_workspace``, in ``kernels.WORKSPACE``); the dry run meters
both.

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
from torch.utils.flop_counter import register_flop_formula

from repro_torch.distributed import sharding as shd
from repro_torch.kernels import LAUNCHES, WORKSPACE, _build
from repro_torch.kernels.rwkv6_scan.ref import (wkv6_scan_backward_ref,
                                                wkv6_scan_ref)

HEAD_SIZES = (8, 16, 32, 64, 128)   # D values the kernel is built for
MAX_BATCH = 65535                   # grid.y limit: one grid row per batch row
MAX_HEADS = 2 ** 31 - 1             # grid.x limit: one grid column per head
CHECKPOINT_EVERY = 16               # tokens a checkpoint: the .cu's WKV_CKPT

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.lru_cache(maxsize=1)
def _backward_library() -> ctypes.CDLL:
    return bind_backward(_build.load("rwkv6_scan_backward"))


def bind_backward(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a library built from
    ``csrc/rwkv6_scan_backward.cu`` (or another source of the same entry
    points) on ``lib``."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_scan_backward_launch.argtypes = [P] * 3 + [I] * 4 + [P]
    lib.rwkv6_scan_backward_launch.restype = ctypes.c_int
    lib.rwkv6_scan_backward_error_string.argtypes = [ctypes.c_int]
    lib.rwkv6_scan_backward_error_string.restype = ctypes.c_char_p
    return lib


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
        return _call(r, k, v, w, u, S0, want_state)
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
    return _call(r, k, v, w, u, S0, want_state)


def _call(r, k, v, w, u, S0, want_state):
    o, S_T = _wkv6(r, k, v, w, u, S0, want_state)
    return (o, S_T) if want_state else o


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


@torch.library.custom_op(
    "repro_torch::wkv6", mutates_args=(), device_types="cuda",
    schema="(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor? S0, "
           "bool want_state) -> (Tensor, Tensor)")
def _wkv6(r, k, v, w, u, S0, want_state):
    """The kernel: one launch writing the contiguous fp32 o (and S_T)."""
    B, T, H, D = r.shape
    o = torch.empty((B, T, H, D), dtype=torch.float32, device=r.device)
    S_T = torch.empty((B, H, D, D) if want_state else (0,),
                      dtype=torch.float32, device=r.device)
    if S0 is not None:
        S0 = S0.float().contiguous()
    if o.numel() == 0:          # T = 0 (or B, H = 0): nothing to launch
        if want_state and S0 is not None:
            S_T.copy_(S0)
        elif want_state:
            S_T.zero_()
        return o, S_T
    r, k, v, w = (t if t.stride(-1) == 1 else t.contiguous()
                  for t in (r, k, v, w))
    launch(o, r, k, v, w, u.contiguous(), S0, S_T if want_state else None)
    return o, S_T


@_wkv6.register_kernel("cpu")
def _(r, k, v, w, u, S0, want_state):
    o, S_T = wkv6_scan_ref(r, k, v, w, u, S0)
    if not want_state:
        return o, o.new_empty((0,))
    return o, S_T.clone() if r.shape[1] == 0 else S_T   # S_T is S0 at T 0


@_wkv6.register_fake
def _(r, k, v, w, u, S0, want_state):
    B, T, H, D = r.shape
    return (r.new_empty((B, T, H, D), dtype=torch.float32),
            r.new_empty((B, H, D, D) if want_state else (0,),
                        dtype=torch.float32))


@torch.library.custom_op(
    "repro_torch::wkv6_backward", mutates_args=(), device_types="cuda",
    schema="(Tensor? go, Tensor? gS, Tensor r, Tensor k, Tensor v, "
           "Tensor w, Tensor u, Tensor? S0) "
           "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
def _wkv6_backward(go, gS, r, k, v, w, u, S0):
    """(dr, dk, dv, dw, du, dS0) against the gradients of o and S_T: the
    backward kernel, one launch writing dr, dk, dv, dw (and dS0) in their
    inputs' dtypes, contiguous, and du's partials into the workspace;
    every operand is read through its strides."""
    B, T, H, D = r.shape
    given = [t for t in (go, gS, r, k, v, w, u, S0) if t is not None]
    bad = [t.dtype for t in given if t.dtype not in _DTYPE_CODE]
    if bad:
        raise TypeError(f"wkv6_backward: no kernel for dtypes {bad} (one of "
                        f"{sorted(map(str, _DTYPE_CODE))})")
    if any(t.device != r.device for t in given):
        raise ValueError(f"wkv6_backward: operands on "
                         f"{[str(t.device) for t in given]}, not one device")
    if D not in HEAD_SIZES or B > MAX_BATCH or H > MAX_HEADS:
        raise ValueError(f"wkv6_backward: no kernel for (B, H, D) "
                         f"{(B, H, D)} (D one of {HEAD_SIZES})")
    dev = r.device
    grads = [torch.empty(t.shape, dtype=t.dtype, device=dev)
             for t in (r, k, v, w)]
    du = torch.empty((H, D), dtype=u.dtype, device=dev)
    dS0 = (torch.empty((0,), dtype=torch.float32, device=dev) if S0 is None
           else torch.empty(S0.shape, dtype=S0.dtype, device=dev))
    if grads[0].numel() == 0:   # T = 0 (or B, H = 0): nothing to launch
        du.zero_()
        if S0 is not None and gS is not None:
            dS0.copy_(gS)
        elif S0 is not None:
            dS0.zero_()
        return (*grads, du, dS0)
    n_states, n_part, _ = _workspace_floats(B, T, H, D)
    ws = torch.empty(backward_workspace(go, gS, r, k, v, w, u, S0) // 4,
                     dtype=torch.float32, device=dev)
    part = ws[n_states:n_states + n_part].view(B, T, H, D)
    launch_backward(grads, dS0 if S0 is not None else None,
                    ws[:n_states], part, go, gS, r, k, v, w, u, S0)
    # u's gradient: the partials over the batch, then over the time rows
    # (the last step first) in order, the plain version's order
    rows = ws[n_states + n_part:].view(T, H, D)
    torch.sum(part, 0, out=rows)
    rows.cumsum_(0)
    du.copy_(rows[T - 1])
    return (*grads, du, dS0)


@_wkv6_backward.register_kernel("cpu")
def _(go, gS, r, k, v, w, u, S0):
    return wkv6_scan_backward_ref(go, gS, r, k, v, w, u, S0)


@_wkv6_backward.register_fake
def _(go, gS, r, k, v, w, u, S0):
    return (*(t.new_empty(t.shape) for t in (r, k, v, w, u)),
            r.new_empty((0,), dtype=torch.float32) if S0 is None
            else S0.new_empty(S0.shape))


def _setup_context(ctx, inputs, output):
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(*inputs[:6])


def _backward(ctx, go, gS):
    if gS is not None and gS.numel() == 0:      # S_T not asked for
        gS = None
    if go is None and gS is None:
        return (None,) * 7
    r, k, v, w, u, S0 = ctx.saved_tensors
    grads = _wkv6_backward(go, gS, r, k, v, w, u, S0)
    return (*(g if need else None
              for g, need in zip(grads, ctx.needs_input_grad)), None)


_wkv6.register_autograd(_backward, setup_context=_setup_context)


@register_flop_formula(torch.ops.repro_torch.wkv6)
def _wkv6_flops(r_shape, *args, **kwargs) -> int:
    """The plain loop's count: o_t = r_t M_t, a (1, D) x (D, D) product
    per batch row, head and token."""
    B, T, H, D = r_shape
    return 2 * B * T * H * D * D


@register_flop_formula(torch.ops.repro_torch.wkv6_backward)
def _wkv6_backward_flops(go_shape, gS_shape, r_shape, *args, **kwargs
                         ) -> int:
    """Autograd of the plain loop's count: the product's two gradients,
    dr_t = M_t go_t and dM = r_t^T go_t, where o has a gradient."""
    B, T, H, D = r_shape
    return 0 if go_shape is None else 4 * B * T * H * D * D


def _workspace_floats(B: int, T: int, H: int, D: int) -> Tuple[int, int, int]:
    """The backward's workspace in fp32 elements, in its order: the
    checkpoints (B, H, ceil(T / CHECKPOINT_EVERY), D, D), the forward
    state before every ``CHECKPOINT_EVERY``-th token; du's partials (B, T,
    H, D) and their sums over the batch (T, H, D)."""
    chunks = -(-T // CHECKPOINT_EVERY)
    return B * H * chunks * D * D, B * T * H * D, T * H * D


def backward_workspace(go, gS, r, k, v, w, u, S0) -> int:
    """Bytes the backward's CUDA implementation allocates beyond its
    inputs and outputs (``_workspace_floats``); its allocation and the
    dry run's ``kernels.WORKSPACE`` both read this."""
    B, T, H, D = r.shape
    return 4 * sum(_workspace_floats(B, T, H, D))


WORKSPACE[torch.ops.repro_torch.wkv6_backward] = backward_workspace


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


def launch_backward(grads, dS0: Optional[torch.Tensor], states: torch.Tensor,
                    part: torch.Tensor, go: Optional[torch.Tensor],
                    gS: Optional[torch.Tensor], r: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                    u: torch.Tensor, S0: Optional[torch.Tensor]) -> None:
    """One launch of the backward kernel on its operands' device and that
    device's current stream, writing ``grads`` (dr, dk, dv, dw: contiguous,
    in r, k, v, w's dtypes), ``dS0`` (contiguous, S0's dtype; None without
    S0), the checkpoints into ``states`` (``_workspace_floats``' first
    count of fp32) and du's partials into ``part`` (B, T, H, D fp32, time
    reversed). Every operand is read through its strides; go, gS and S0
    may be None. The operator validates them; benchmarks call this
    directly to time the kernel."""
    B, T, H, D = r.shape
    ins = (go, r, k, v, w, gS, S0, u)
    strides = (ctypes.c_longlong * 32)(*(
        s for t in ins for s in ((0,) * 4 if t is None else
                                 tuple(t.stride()) + (0,) * (4 - t.ndim))))
    codes = (ctypes.c_int * 8)(*(0 if t is None else _DTYPE_CODE[t.dtype]
                                 for t in ins))
    ptrs = (ctypes.c_void_p * 15)(*(
        None if t is None else t.data_ptr()
        for t in (*ins, *grads, dS0, states, part)))
    lib = _backward_library()
    with torch.cuda.device(r.device):
        err = lib.rwkv6_scan_backward_launch(
            ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(strides, ctypes.c_void_p),
            ctypes.cast(codes, ctypes.c_void_p), B, T, H, D,
            torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError("rwkv6_scan_backward launch failed: "
                           + lib.rwkv6_scan_backward_error_string(err)
                           .decode())
    LAUNCHES["rwkv6_scan_backward"] += 1
