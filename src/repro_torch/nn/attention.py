"""Grouped-query attention with RoPE and optional qk-norm — full-sequence
(training / prefill) path of ``repro/nn/attention.py``.

Layouts (the reference's): q proj ``(d_model, n_heads * d_head)`` "wq",
k/v ``(d_model, n_kv * d_head)`` "wk"/"wv", out ``(n_heads * d_head,
d_model)`` "wo". Scores and context are plain einsums in float32 (the
reference's ``preferred_element_type=float32`` on low-precision
operands), with no fused attention call: this is the plain version the
flash-attention kernel of a later slice is held against. The decode KV
cache and ``mha_decode`` wait for the decode slice (ROADMAP.md queue 1).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.nn.module import (dense_init, rmsnorm, rmsnorm_init,
                                   truncated_normal_init)

NEG_INF = -1e30


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


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """(S_q, S_k) additive bias in float32."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    ok = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (qp - kp < window)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


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
    group = n_heads // n_kv
    qg = q.reshape(B, S, n_kv, group, d_head)
    scores = torch.einsum("bsngh,btnh->bngst", qg.float(), k.float())
    scores = scores * (d_head ** -0.5)
    ar = torch.arange(S, device=x.device)
    scores = scores + _mask_bias(ar, ar, causal, window)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bngst,btnh->bsngh", probs.float(),
                       v.float()).to(x.dtype)
    ctx = ctx.reshape(B, S, n_heads * d_head)
    return torch.matmul(ctx, params["wo"]["kernel"].to(x.dtype))
