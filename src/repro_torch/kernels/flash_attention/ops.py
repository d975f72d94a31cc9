"""Public wrapper of blocked attention with an online softmax.

``flash_attention`` is what ``nn/attention.py::mha`` calls for every
attention block, in the port's ``(B, S, heads, hd)`` layout. A tensor on
the CPU takes the plain version (``ref.py``); a tensor on a CUDA device
launches the CUDA kernel (``csrc/flash_attention.cu``, built by
``kernels/_build.py`` at first use) or raises — there is no fallback:
bf16 and fp16 run on the tensor cores, float32 on the CUDA cores, one
launch either way. Keys may be longer or shorter than the queries
(cross-attention: a decoder's queries over an encoder's frames); such a
call is non-causal and unwindowed, and a causal or windowed one raises.
``LAUNCHES["flash_attention"]`` counts kernel launches, and nothing else.

DTensors (a train step over a device mesh) run per shard
(``on_head_shards``): batch over the batch axes, heads over ``"model"``,
sequence whole, so the kernel on a card and the plain version on the CPU
each see one device's local block, and every shard's launch counts.

Gradients: the kernel has no backward. Where autograd needs one (an LM
trained on the card), the forward is the kernel and the backward
differentiates the plain version at the same inputs (``_Flash``), which
is what the reference's training differentiates (its ``mha`` attends
with plain einsums).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (64, 128, 192, 256)   # head widths the kernel is instantiated
                                  # for (whisper_base's; qwen3_4b's;
                                  # nemotron_4_340b's; paligemma_3b's and
                                  # recurrentgemma_2b's), and
FP32_HEAD_DIMS = (16,) + HEAD_DIMS   # the reduced LMs' in float32
MAX_GRID = 65535             # grid.y (heads) and grid.z (batch) limit
ALIGN_BYTES = 16             # one cp.async / vector load: 8 bf16 or fp16
                             # elements, 4 fp32

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [P, P, P, P, I, I, I, I, I, I,
                                           I, P, P, P, P, I, I,
                                           ctypes.c_float, P]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_shapes(q, k, v, causal, window) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: want q "
                         "(B, Sq, H, hd) and k, v (B, Sk, KV, hd)")
    B, Sq, H, hd = q.shape
    if (k.shape[0], k.shape[3]) != (B, hd) or H % k.shape[2]:
        raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)} (H % KV must be 0)")
    if k.shape[1] != Sq and (causal or window is not None):
        raise ValueError(f"flash_attention: {Sq} queries over {k.shape[1]} "
                         "keys (cross-attention) take no causal mask or "
                         "window")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read it in place (last axis
    contiguous, strides and address on 16-byte boundaries), else a fresh
    contiguous copy."""
    size = t.element_size()
    if t.stride(-1) == 1 \
            and all(s * size % ALIGN_BYTES == 0 for s in t.stride()[:3]) \
            and t.data_ptr() % ALIGN_BYTES == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with H % KV == 0 ->
    (B, Sq, H, hd) in q's dtype. Scores, softmax and P.V in fp32;
    ``window`` keeps keys with q_pos - k_pos < window. Sq != Sk only
    without a causal mask or window."""
    _check_shapes(q, k, v, causal, window)
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if shd.is_dtensor(q):
        return on_head_shards(functools.partial(
            flash_attention, causal=causal, window=window), q, k, v)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"flash_attention: operand on {t.device}, q "
                             f"on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: k/v {t.dtype}, q {q.dtype}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: no kernel for dtype {q.dtype} "
                        f"(one of {sorted(map(str, _DTYPE_CODE))})")
    B, _, H, hd = q.shape
    dims = FP32_HEAD_DIMS if q.dtype == torch.float32 else HEAD_DIMS
    if hd not in dims:
        raise ValueError(f"flash_attention: no kernel for head width {hd} "
                         f"in {q.dtype} (one of {dims})")
    if B > MAX_GRID or H > MAX_GRID:
        raise ValueError(f"flash_attention: batch {B} or heads {H} > "
                         f"{MAX_GRID}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window)


def on_head_shards(attend, q, k, v):
    """``attend(q, k, v)`` (an attention of (B, S, H, hd) blocks) run on
    each device's local blocks of the DTensors q, k, v: batch over the
    batch axes and heads over ``"model"`` where they divide, the sequence
    whole. When the query heads divide the model axis and the key/value
    heads do not (Qwen3-8B's 8 over 16), k and v stay whole over
    ``"model"`` (a small tensor; each block's gradient for them is then a
    partial sum) and each block attends over the key/value heads its
    query heads read."""
    from torch.distributed.tensor import Partial, Shard
    mesh = q.device_mesh
    H, KV = q.shape[2], k.shape[2]
    qp = shd.shard_layout(mesh, q.shape, 0, 2)
    q_split = shd.shard_index(mesh, qp, 2)[1] > 1
    kvp = shd.shard_layout(mesh, k.shape, 0, 2 if q_split else None)
    kv_whole = q_split and shd.shard_index(mesh, kvp, 2)[1] == 1
    group = H // KV

    def local(q, k, v):
        if kv_whole:    # the key/value heads this block of queries reads
            i, n = shd.shard_index(mesh, qp, 2)
            hl = H // n
            if hl % group and group % hl:
                raise ValueError(f"flash_attention: {H} query heads over "
                                 f"{n} shards do not map onto {KV} "
                                 "key/value heads")
            lo, hi = i * hl // group, ((i + 1) * hl - 1) // group + 1
            k, v = k[:, :, lo:hi], v[:, :, lo:hi]
        return attend(q, k, v)

    kvg = tuple(Partial() if p == Shard(2) else r for p, r in zip(qp, kvp))
    return shd.on_local_shards(
        local, (qp,), (qp, kvp, kvp), mesh,
        in_grad_placements=(qp, kvg, kvg) if kv_whole else None)(q, k, v)


def _forward(q, k, v, causal, window) -> torch.Tensor:
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel():
        launch(out, _aligned(q), _aligned(k), _aligned(v), causal, window)
    return out


class _Flash(torch.autograd.Function):
    """The kernel's forward with the plain version's gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window)
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad):
        causal, window = ctx.mask
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = attention_ref(*ins, causal=causal, window=window)
            grads = torch.autograd.grad(out, ins, grad)
        return (*grads, None, None)


def launch(out: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, causal: bool = True,
           window: Optional[int] = None) -> None:
    """One launch of the CUDA kernel on its operands' device and that device's
    current stream, writing ``out`` (operands already checked and aligned by
    ``flash_attention``; benchmarks call this directly to time the kernel
    alone)."""
    B, Sq, H, hd = q.shape
    lib = _library()
    strides = [(ctypes.c_longlong * 3)(*t.stride()[:3])
               for t in (q, k, v, out)]
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], B, Sq, k.shape[1], H, k.shape[2], hd,
            *strides,
            int(causal), 0 if window is None else int(window), hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    LAUNCHES["flash_attention"] += 1
