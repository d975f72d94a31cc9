"""Grouped-query attention with RoPE and optional qk-norm — full-sequence
(training / prefill) path of ``repro/nn/attention.py``.

Layouts (the reference's): q proj ``(d_model, n_heads * d_head)`` "wq",
k/v ``(d_model, n_kv * d_head)`` "wk"/"wv", out ``(n_heads * d_head,
d_model)`` "wo". After the projections, qk-norm and RoPE, the attention
itself is ``kernels/flash_attention/ops.py::flash_attention``: the
hand-written CUDA kernel on the card, its plain version on the CPU. It
follows the Pallas flash kernel's contract, which differs from the
reference ``mha``'s einsums in one place: the softmax probabilities stay
float32 for P.V, where the reference rounds them to the activation type
first. In float32 the two agree up to the order of summation; in bf16
the port is the more precise. The decode KV cache and ``mha_decode``
wait for the decode slice (ROADMAP.md queue 1).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.nn.module import (dense_init, rmsnorm, rmsnorm_init,
                                   truncated_normal_init)


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, n, d_head); positions: (..., S) or (S,)."""
    d_head = x.shape[-1]
    freqs = rope_freqs(d_head, theta, device=x.device)      # (d_head/2,)
    angles = positions[..., None].float() * freqs           # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention_init(gen, d_model: int, n_heads: int, n_kv: int, d_head: int,
                   qk_norm: bool = False, param_dtype=torch.float32,
                   lead=(), device=None):
    kw = dict(lead=lead, device=device)
    p = {
        "wq": dense_init(gen, d_model, n_heads * d_head, param_dtype, **kw),
        "wk": dense_init(gen, d_model, n_kv * d_head, param_dtype, **kw),
        "wv": dense_init(gen, d_model, n_kv * d_head, param_dtype, **kw),
        "wo": {"kernel": truncated_normal_init(
            gen, (*lead, n_heads * d_head, d_model),
            (n_heads * d_head) ** -0.5, param_dtype, device)},
    }
    if qk_norm:
        p["q_norm"] = rmsnorm_init(d_head, param_dtype, **kw)
        p["k_norm"] = rmsnorm_init(d_head, param_dtype, **kw)
    return p


def _proj(w, x: torch.Tensor, n: int, d_head: int) -> torch.Tensor:
    y = torch.matmul(x, w["kernel"].to(x.dtype))
    return y.reshape(*x.shape[:-1], n, d_head)


def mha(params, x: torch.Tensor, *, n_heads: int, n_kv: int, d_head: int,
        rope_theta: float = 1e4, positions: Optional[torch.Tensor] = None,
        causal: bool = True, window: Optional[int] = None,
        use_rope: bool = True, qk_norm: bool = False) -> torch.Tensor:
    """Full-sequence self-attention. x: (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    q = _proj(params["wq"], x, n_heads, d_head)     # (B,S,H,hd)
    k = _proj(params["wk"], x, n_kv, d_head)        # (B,S,KV,hd)
    v = _proj(params["wv"], x, n_kv, d_head)
    if qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if positions is None:
        positions = torch.arange(S, device=x.device)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    ctx = flash_attention(q, k, v, causal=causal, window=window)
    ctx = ctx.reshape(B, S, n_heads * d_head)
    return torch.matmul(ctx, params["wo"]["kernel"].to(x.dtype))
