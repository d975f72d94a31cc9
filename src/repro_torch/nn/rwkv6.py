"""RWKV-6 "Finch" time mix (Peng et al., arXiv:2404.05892), the port of
``repro/nn/rwkv6.py``.

Data-dependent token shift (low rank) and data-dependent per-channel
decay w_t, with the per-head WKV recurrence

    S_t = diag(w_t) S_{t-1} + k_t^T v_t           (state: (hd, hd) per head)
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

The reference scans the recurrence with ``lax.scan`` from a carried state
(``_wkv_with_initial_state``); the port runs it through
``kernels/rwkv6_scan`` — the CUDA kernel on the card, its plain
sequential version on the CPU — which computes the same function. The
casts are the reference's: the token shift, the low-rank mixes and the
dense projections in the activation type, the decay and the recurrence in
fp32, the group norm on the recurrence's output cast back to the
activation type (its mean and variance reduced in fp32 and rounded, as
``jnp.mean`` and ``jnp.var`` do).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as shd
from repro_torch.kernels.rwkv6_scan.ops import wkv6
from repro_torch.kernels.rwkv6_scan.ref import wkv6_scan_ref  # noqa: F401
from repro_torch.nn.module import dense, dense_init, truncated_normal_init

MIXES = ("w", "k", "v", "r", "g")


def rwkv6_init(gen, d_model: int, n_heads: int, lora_rank: int = 32,
               param_dtype=torch.float32, lead=(), device=None):
    d_head = d_model // n_heads
    kw = dict(lead=lead, device=device)

    def tn(shape, scale):
        return truncated_normal_init(gen, (*lead, *shape), scale, param_dtype,
                                     device)

    def full(shape, value):
        return torch.full((*lead, *shape), value, dtype=param_dtype,
                          device=device)

    w0 = torch.linspace(-6.0, -1.0, d_model, dtype=torch.float32,
                        device=device)
    return {
        "wr": dense_init(gen, d_model, d_model, param_dtype, **kw),
        "wk": dense_init(gen, d_model, d_model, param_dtype, **kw),
        "wv": dense_init(gen, d_model, d_model, param_dtype, **kw),
        "wg": dense_init(gen, d_model, d_model, param_dtype, **kw),
        "wo": dense_init(gen, d_model, d_model, param_dtype, **kw),
        # static token-shift interpolants
        "mu_x": full((d_model,), 0.5),
        "mu": tn((len(MIXES), d_model), 0.02),
        # low-rank data-dependent shift:  tanh(xx A1) A2 -> 5 mixes
        "lora_a1": tn((d_model, len(MIXES) * lora_rank), 0.02),
        "lora_a2": tn((len(MIXES), lora_rank, d_model), 0.02),
        # decay: w = exp(-exp(w0 + tanh(xw W1) W2))
        "w0": w0.to(param_dtype).expand(*lead, d_model).clone(),
        "w_lora1": tn((d_model, lora_rank), 0.02),
        "w_lora2": tn((lora_rank, d_model), 0.02),
        # per-channel bonus u (reshaped to heads)
        "u": tn((d_model,), 0.3),
        # per-head output group norm
        "gn_scale": full((n_heads, d_head), 1.0),
        "gn_bias": full((n_heads, d_head), 0.0),
    }


def _token_shift(x: torch.Tensor, x_prev_last: torch.Tensor) -> torch.Tensor:
    """Shift the sequence right by one; the first position takes the
    carry (B, d)."""
    return torch.cat([x_prev_last[:, None, :], x[:, :-1, :]], dim=1)


def _mix_inputs(p, x: torch.Tensor, x_shift: torch.Tensor):
    xx = x_shift - x
    xxx = x + xx * shd.whole(p["mu_x"]).to(x.dtype)
    # (B,S,5r); over a mesh the LoRA's partial sums are reduced whole
    # (``constrain``), as the tiny rank cannot be split over 'model'
    m = torch.tanh(shd.constrain(torch.matmul(
        xxx, p["lora_a1"].to(x.dtype)), "batch"))
    B, S, _ = m.shape
    r = p["lora_a2"].shape[1]
    m = m.reshape(B, S, len(MIXES), r)
    delta = torch.einsum("bsnr,nrd->nbsd", m, p["lora_a2"].to(x.dtype))
    out = {}
    for i, name in enumerate(MIXES):
        mu = shd.whole(p["mu"][i]).to(x.dtype) + delta[i]
        out[name] = x + xx * mu
    return out


def _decay(p, xw: torch.Tensor) -> torch.Tensor:
    """Per-channel fp32 decay w_t in (0, 1): exp(-exp(w0 + lora(xw)))."""
    lo = torch.matmul(torch.tanh(shd.constrain(torch.matmul(
        xw, p["w_lora1"].to(xw.dtype)), "batch")), p["w_lora2"].to(xw.dtype))
    logw = p["w0"].float() + lo.float()
    return torch.exp(-torch.exp(logw))


def _group_norm(p, o: torch.Tensor, eps: float = 64e-5) -> torch.Tensor:
    """Per-head layer norm over the head dim (RWKV's GroupNorm(H)). Mean
    and variance reduce in fp32 and round to o's type; the rest runs in
    o's type, op by op, as the reference's."""
    o32 = o.float()
    mean = o32.mean(dim=-1, keepdim=True).to(o.dtype)
    var = o32.var(dim=-1, unbiased=False, keepdim=True).to(o.dtype)
    y = (o - mean) * torch.rsqrt(var + eps)
    return y * p["gn_scale"].to(o.dtype) + p["gn_bias"].to(o.dtype)


def rwkv6_time_mix(p, x: torch.Tensor, n_heads: int, state: Any = None,
                   want_state: bool = True):
    """Full-sequence time mix. x: (B, S, d). ``state`` carries
    ``(x_last, S_wkv)`` for streaming; None starts from zeros. Returns
    ``(out, (x[:, -1], S_T))``; with ``want_state=False`` the recurrence
    writes no final state and ``S_T`` is None (the full-sequence block
    drops it, as the reference's does)."""
    B, S, d = x.shape
    D = d // n_heads
    if state is None:
        x_last = torch.zeros((B, d), dtype=x.dtype, device=x.device)
        S_wkv = None        # the kernel starts from a zero state
    else:
        x_last, S_wkv = state
    x_shift = _token_shift(x, x_last)
    mixed = _mix_inputs(p, x, x_shift)
    heads = lambda t: shd.splittable(t, -1, n_heads).reshape(
        *t.shape[:-1], n_heads, D)
    r = heads(dense(p["wr"], mixed["r"]))
    k = heads(dense(p["wk"], mixed["k"]))
    v = heads(dense(p["wv"], mixed["v"]))
    g = F.silu(dense(p["wg"], mixed["g"]))
    w = heads(_decay(p, mixed["w"]))
    u = heads(p["u"])

    if want_state:
        o, S_new = wkv6(r, k, v, w, u, S_wkv, want_state=True)
    else:
        o, S_new = wkv6(r, k, v, w, u, S_wkv), None
    o = _group_norm(p, o.to(x.dtype))
    o = shd.grad_like(o.reshape(B, S, d)) * g
    out = dense(p["wo"], o)
    return out, (x[:, -1, :], S_new)


def rwkv6_decode_step(p, x_t: torch.Tensor, state, n_heads: int):
    """Single-token step. x_t: (B, d); state = (x_last, S_wkv) or None."""
    out, new_state = rwkv6_time_mix(p, x_t[:, None, :], n_heads, state=state)
    return out[:, 0, :], new_state
