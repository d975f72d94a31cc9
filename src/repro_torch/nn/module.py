"""Primitive layers: truncated-normal init, dense, RMSNorm, LayerNorm,
embeddings, small MLPs, and the int8 absmax quantizer.

Conventions (as in ``repro/nn/module.py``): params are nested dicts of
tensors with the reference's key names and layouts — a dense kernel is
``(in, out)`` — so weights carry across leaf for leaf
(``repro_torch/convert.py``). ``lead`` prepends stacking axes, the way the
reference ``vmap``s a group's init over ``n_groups``. Matmuls on a
low-precision activation accumulate in float32 and round once to the
activation's type, the reference's ``preferred_element_type=float32``
(``repro_torch.pin_cuda_numerics`` keeps cuBLAS from reducing in bf16).
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch

from repro_torch.distributed import sharding as shd

Params = Any


def _norm_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def truncated_normal_init(gen: torch.Generator, shape: Sequence[int],
                          scale: float, dtype: torch.dtype,
                          device=None) -> torch.Tensor:
    """Normal draws truncated to [-2, 2] (inverse-CDF of a uniform draw from
    ``gen``), times ``scale``, stored as ``dtype``."""
    lo, hi = _norm_cdf(-2.0), _norm_cdf(2.0)
    x = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    x.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=gen)
    x.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return x.mul_(scale).to(dtype)


def dense_init(gen, in_dim: int, out_dim: int,
               param_dtype=torch.float32, scale: Optional[float] = None,
               lead=(), device=None):
    scale = (in_dim ** -0.5) if scale is None else scale
    return {"kernel": truncated_normal_init(
        gen, (*lead, in_dim, out_dim), scale, param_dtype, device)}


def dense(params, x: torch.Tensor) -> torch.Tensor:
    w = params["kernel"]
    return shd.grad_like(torch.matmul(shd.matmul_ready(x, w), w.to(x.dtype)))


def rmsnorm_init(dim: int, param_dtype=torch.float32, lead=(), device=None):
    return {"scale": torch.ones((*lead, dim), dtype=param_dtype,
                                device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_init(dim: int, param_dtype=torch.float32, lead=(),
                   device=None):
    return {"scale": torch.ones((*lead, dim), dtype=param_dtype,
                                device=device),
            "bias": torch.zeros((*lead, dim), dtype=param_dtype,
                                device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """In float32 with the population variance (``jnp.var``), then cast
    back to x's type."""
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * params["scale"].float()
            + params["bias"].float()).to(x.dtype)


def quantize_absmax(x: torch.Tensor):
    """Symmetric int8 with one scale a row of the last axis, the
    reference's rule wherever it quantizes (the KV cache, the MoE
    dispatch, the 8-bit moments): x (..., n) -> (int8 payload (..., n),
    float32 scale (..., 1)), the scale the row's amax over 127 floored at
    1e-12, the payload x over it rounded half to even and clipped to
    +-127. The int8 cast carries no gradient; through the scale the
    gradient reaches x at the amax (split evenly between ties)."""
    x32 = x.float()
    scale = torch.clamp_min(
        torch.amax(torch.abs(x32), dim=-1, keepdim=True) / 127.0, 1e-12)
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def embedding_init(gen, vocab: int, dim: int, param_dtype=torch.float32,
                   device=None):
    return {"table": truncated_normal_init(gen, (vocab, dim), 1.0,
                                           param_dtype, device)}


def embedding_lookup(params, ids: torch.Tensor,
                     dtype=torch.float32) -> torch.Tensor:
    return embedding_rows(params["table"], ids.long()).to(dtype)


def embedding_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``. A DTensor table (vocabulary rows over the 'model'
    axis, ids over the batch axes) is read on each device's local
    blocks: each device takes the rows its block of the vocabulary
    holds and the rest count zero, a partial sum over the vocabulary's
    axes (the table gathered over any other axis first, FSDP's gather);
    its gradient is the local rows' own, summed over the batch axes."""
    if not shd.is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)
    mesh = table.device_mesh
    if not shd.is_dtensor(ids):
        ids = distribute_tensor(ids, mesh, (Replicate(),) * mesh.ndim,
                                src_data_rank=None)
    vocab = [i for i, p in enumerate(table.placements)
             if p == Shard(0) and mesh.size(i) > 1]
    tp = tuple(Shard(0) if i in vocab else Replicate()
               for i in range(mesh.ndim))
    ip = tuple(Replicate() if i in vocab else p
               for i, p in enumerate(ids.placements))
    out = tuple(Partial() if i in vocab else p for i, p in enumerate(ip))
    grad = tuple(Partial() if p == Shard(0) else q for p, q in zip(ip, tp))

    def local(t, ids):
        if not vocab:
            return t[ids]
        ids = ids - shd.shard_index(mesh, tp, 0)[0] * t.shape[0]
        hit = (ids >= 0) & (ids < t.shape[0])
        rows = t[torch.where(hit, ids, 0)]
        return torch.where(hit[..., None], rows,
                           torch.zeros((), dtype=t.dtype))

    return shd.on_local_shards(local, (out,), (tp, ip), mesh,
                               in_grad_placements=(grad, ip))(table, ids)


def embedding_logits(params, x: torch.Tensor) -> torch.Tensor:
    """Tied-embedding readout x @ table^T: the table rounded to x's type,
    products exact in float32 and summed there (the reference's
    ``preferred_element_type=float32``)."""
    return torch.matmul(x.float(), params["table"].to(x.dtype).T.float())


def mlp_init(gen, dims: Sequence[int], param_dtype=torch.float32,
             final_zero: bool = False, device=None):
    """Small bias-free MLP (hypersolver g nets, CNF and tracker fields):
    one ``dense`` layer per consecutive pair of ``dims``, drawn from
    ``gen`` in order. ``final_zero`` zeroes the last kernel, so a
    correction starts at exactly g == 0."""
    layers = []
    for i in range(len(dims) - 1):
        p = dense_init(gen, dims[i], dims[i + 1], param_dtype, device=device)
        if final_zero and i == len(dims) - 2:
            p = {"kernel": torch.zeros_like(p["kernel"])}
        layers.append(p)
    return {"layers": layers}


def mlp_apply(params, x: torch.Tensor, act=torch.tanh) -> torch.Tensor:
    """``dense`` layers with ``act`` between them (none after the last)."""
    layers = params["layers"]
    h = x
    for i, lp in enumerate(layers):
        h = dense(lp, h)
        if i < len(layers) - 1:
            h = act(h)
    return h
