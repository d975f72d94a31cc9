"""8-bit block-quantized Adam moments — the port of
``repro/optim/quantized_state.py`` (Dettmers-style blockwise absmax).

A moment leaf is flattened, zero-padded to whole blocks of ``BLOCK``
elements and stored as an int8 payload (n_blocks, BLOCK) with one float32
scale per block (``nn/module.py::quantize_absmax``): 1 + 4/256 bytes an element where float32 moments
take 4, so AdamW's moments shrink 3.9x.

``adamw8bit(...).update`` is functional, as the reference's: each leaf's
moments are dequantized whole, updated in float32 as AdamW's, and
quantized again. ``update_in_place`` does the same arithmetic leaf by
leaf in chunks of whole blocks (``optimizers.IN_PLACE_CHUNK`` rounded
down to a multiple of BLOCK; the last chunk takes the leaf's zero
padding), writing payloads, scales and params into the old tensors: a
whole-leaf update of OLMoE-1B-7B's expert ``wi`` stack (4.3 B elements)
would hold 17 GB per float32 temporary. Its values equal ``update``
followed by ``apply_updates`` bit for bit, since blocks are quantized
independently.
"""
from __future__ import annotations

import math
from typing import Any, List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from repro_torch.distributed import sharding as shd
from repro_torch.nn.module import quantize_absmax
from repro_torch.optim import optimizers
from repro_torch.optim.optimizers import (Optimizer, adam_coefficients,
                                          as_schedule, scaled)

BLOCK = 256


class QTensor(NamedTuple):
    q: torch.Tensor       # int8 payload (n_blocks, BLOCK), padded flat
    scale: torch.Tensor   # float32 (n_blocks, 1) per-block amax / 127


def quantize_blockwise(x: torch.Tensor) -> QTensor:
    flat = x.float().reshape(-1)
    return QTensor(*quantize_absmax(
        F.pad(flat, (0, (-flat.numel()) % BLOCK)).reshape(-1, BLOCK)))


def dequantize_blockwise(qt: QTensor, shape,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    flat = (qt.q.float() * qt.scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape).to(dtype)


def zeros_blockwise(shape, device=None) -> QTensor:
    """``quantize_blockwise`` of a float32 zero tensor of ``shape``,
    without making that tensor."""
    n = -(-math.prod(shape) // BLOCK)
    return QTensor(q=torch.zeros((n, BLOCK), dtype=torch.int8,
                                 device=device),
                   scale=torch.full((n, 1), 1e-12, dtype=torch.float32,
                                    device=device))


class Adam8bitState(NamedTuple):
    mu: Any
    nu: Any


def _is_q(t) -> bool:
    return isinstance(t, QTensor)


def adamw8bit(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
              weight_decay: float = 0.0) -> Optimizer:
    """AdamW with int8 block-quantized moments. ``lr`` is a float or a
    schedule of the step."""
    sched = as_schedule(lr)

    def init(params):
        z = lambda p: zeros_blockwise(p.shape, p.device)
        return Adam8bitState(mu=pytree.tree_map(z, params),
                             nu=pytree.tree_map(z, params))

    def moments(g32, m_old, v_old):
        m = b1 * m_old + (1 - b1) * g32
        v = b2 * v_old + (1 - b2) * g32 * g32
        return m, v

    def direction(p, m, v, lr_t, bc1, bc2):
        d = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            d = d + weight_decay * p.float()
        return -lr_t * d

    def update(grads, state: Adam8bitState, params, step):
        flat_g, spec = pytree.tree_flatten(grads)
        flat_p = pytree.tree_leaves(params)
        flat_m = pytree.tree_leaves(state.mu, is_leaf=_is_q)
        flat_v = pytree.tree_leaves(state.nu, is_leaf=_is_q)
        lr_t, bc1, bc2 = adam_coefficients(sched, b1, b2, step,
                                           flat_g[0].device)
        upds, new_m, new_v = [], [], []
        for g, p, mq, vq in zip(flat_g, flat_p, flat_m, flat_v):
            m, v = moments(g.float(), dequantize_blockwise(mq, g.shape),
                           dequantize_blockwise(vq, g.shape))
            upds.append(direction(p, m, v, lr_t, bc1, bc2))
            new_m.append(quantize_blockwise(m))
            new_v.append(quantize_blockwise(v))
        unflat = lambda ls: pytree.tree_unflatten(ls, spec)
        return unflat(upds), Adam8bitState(mu=unflat(new_m),
                                           nu=unflat(new_v))

    def update_in_place(grads: List[Optional[torch.Tensor]],
                        state: Adam8bitState, params, step,
                        scale: Optional[torch.Tensor] = None) -> None:
        """``update`` then ``apply_updates``, one leaf at a time and a leaf
        in chunks of whole blocks, written into ``state``'s payloads and
        scales and ``params``' tensors (each contiguous). ``grads`` and
        ``scale`` as ``adamw``'s ``update_in_place``: the gradients in
        ``pytree.tree_leaves(params)`` order, consumed, each multiplied by
        ``scale`` when one is given."""
        leaves = pytree.tree_leaves(params)
        if len(grads) != len(leaves):
            raise ValueError(f"{len(grads)} gradients for {len(leaves)} "
                             "parameter leaves")
        if any(shd.is_dtensor(l) for l in leaves):
            raise NotImplementedError(
                "8-bit moments have no sharded update: train over a device "
                "mesh with float32 or bfloat16 moments (ROADMAP.md, what "
                "item 12 left out)")
        lr_t, bc1, bc2 = adam_coefficients(sched, b1, b2, step,
                                           leaves[0].device)
        chunk = max(BLOCK, optimizers.IN_PLACE_CHUNK // BLOCK * BLOCK)
        with torch.no_grad():
            for i, (p, mq, vq) in enumerate(zip(
                    leaves, pytree.tree_leaves(state.mu, is_leaf=_is_q),
                    pytree.tree_leaves(state.nu, is_leaf=_is_q))):
                if not p.is_contiguous():
                    raise ValueError("update_in_place needs contiguous "
                                     f"params; leaf {i} is not")
                g, grads[i] = grads[i].reshape(-1), None
                pf, n = p.view(-1), p.numel()
                for lo in range(0, n, chunk):
                    hi = min(lo + chunk, n)
                    rows = slice(lo // BLOCK, -(-hi // BLOCK))
                    gc = g[lo:hi]
                    if scale is not None:
                        gc = scaled(gc, scale)
                    pad = (0, (-(hi - lo)) % BLOCK)
                    m, v = moments(
                        F.pad(gc.float(), pad),
                        (mq.q[rows].float() * mq.scale[rows]).reshape(-1),
                        (vq.q[rows].float() * vq.scale[rows]).reshape(-1))
                    del gc
                    # the padding's moments are zeros, as quantize_blockwise
                    # pads the unpadded ones
                    m[hi - lo:], v[hi - lo:] = 0.0, 0.0
                    u = direction(pf[lo:hi], m[:hi - lo], v[:hi - lo],
                                  lr_t, bc1, bc2)
                    for qt, x in ((mq, m), (vq, v)):
                        qt.q[rows], qt.scale[rows] = quantize_absmax(
                            x.reshape(-1, BLOCK))
                    del m, v
                    pf[lo:hi].add_(u.to(p.dtype))
                del g

    return Optimizer(init=init, update=update,
                     update_in_place=update_in_place)
