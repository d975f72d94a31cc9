"""int8 gradient compression with error feedback — the port of
``repro/optim/grad_compress.py`` (1-bit-Adam lineage).

``compress_with_feedback`` quantizes each gradient plus its carried error
to int8 blocks (``quantized_state.quantize_blockwise``), hands the
dequantized gradient to the optimizer and carries the residual into the
next step, so the scheme is unbiased in the long run.
``compressed_allreduce_mean``, the reference's collective across
devices (int8 payloads all-gathered over a mesh axis), waits for the
multi-device port (ROADMAP.md queue 1 item 12).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.optim.quantized_state import (dequantize_blockwise,
                                               quantize_blockwise)


def compress_with_feedback(grads: Any, error_fb: Any) -> Tuple[Any, Any]:
    """Quantize (g + e) to int8 blocks; carry the quantization residual.
    Returns (the dequantized gradients in each leaf's dtype, the new
    float32 error tree)."""

    def one(g, e):
        g32 = g.float() + e
        g_hat = dequantize_blockwise(quantize_blockwise(g32), g.shape)
        return g_hat.to(g.dtype), g32 - g_hat

    flat_g, spec = pytree.tree_flatten(grads)
    outs = [one(g, e) for g, e in zip(flat_g, pytree.tree_leaves(error_fb))]
    return (pytree.tree_unflatten([o[0] for o in outs], spec),
            pytree.tree_unflatten([o[1] for o in outs], spec))


def init_error_feedback(params: Any) -> Any:
    return pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def compressed_allreduce_mean(x: torch.Tensor, mesh, axis: str = "data"):
    """Mean over the mesh axis ``axis`` with int8 payloads: a collective
    across devices, not ported yet."""
    raise NotImplementedError(
        "compressed_allreduce_mean (an int8 all-gather across a device "
        "mesh) is not ported yet: ROADMAP.md queue 1 item 12")
