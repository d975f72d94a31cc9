"""Real-Gated Linear Recurrent Unit and the Griffin recurrent block
(De, Smith et al., arXiv:2402.19427 — the RecurrentGemma backbone), the
full-sequence path of ``repro/nn/rglru.py``.

    r_t = sigmoid(x_t W_a + b_a)                 (recurrence gate)
    i_t = sigmoid(x_t W_x + b_x)                 (input gate)
    log a_t = -c * softplus(Lambda) * r_t        (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference scans associatively (``lax.associative_scan``); the port
runs the recurrence through ``kernels/rglru_scan`` — sequential over T
with an fp32 carry, the CUDA kernel on the card and its plain version on
the CPU. The two forms agree to rtol 2e-4 / atol 1e-5 (the bound
``tests/test_nn_layers.py`` holds them to). The casts are the
reference's: dense projections in the activation type, gates in fp32,
the conv accumulated in fp32 in tap order, ``h`` cast to the activation
type before the output gate. The single-step ``rglru_decode_step`` of
the cached decode path is plain PyTorch, as the reference's is: three
elementwise ops on the gates, no kernel.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.nn.module import dense, dense_init, truncated_normal_init

_C = 8.0


def rglru_init(gen, width: int, param_dtype=torch.float32, lead=(),
               device=None):
    kw = dict(lead=lead, device=device)
    wa = dense_init(gen, width, width, param_dtype, **kw)
    wx = dense_init(gen, width, width, param_dtype, **kw)
    # Lambda init so a ~ U[0.9, 0.999] at r = 1 (paper App. A)
    u = torch.empty((*lead, width), dtype=torch.float32, device=device)
    u.uniform_(0.9, 0.999, generator=gen)
    lam = torch.log(torch.expm1(-torch.log(u) / _C))  # softplus^-1(-log u / c)
    return {
        "wa": wa,
        "ba": torch.zeros((*lead, width), dtype=param_dtype, device=device),
        "wx": wx,
        "bx": torch.zeros((*lead, width), dtype=param_dtype, device=device),
        "lam": lam.to(param_dtype),
    }


def _gates(p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence's fp32 (a, b) of x: (B, T, width)."""
    r = torch.sigmoid(dense(p["wa"], x).float() + p["ba"].float())
    i = torch.sigmoid(dense(p["wx"], x).float() + p["bx"].float())
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    # multiplier sqrt(1 - a^2) in stable form
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = mult * (i * x.float())
    return a, b


def rglru_apply(p, x: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """x: (B, T, width) -> (y in x's dtype, fp32 h_T (B, width)). An
    initial state ``h0`` is folded into the first step: b_0 += a_0 * h0."""
    a, b = _gates(p, x)
    if h0 is not None:
        b = b.clone()
        b[:, 0] = b[:, 0] + a[:, 0] * h0.float()
    h = rglru_scan(a, b)
    return h.to(x.dtype), h[:, -1]


def rglru_decode_step(p, x_t: torch.Tensor, h: torch.Tensor):
    """x_t: (B, width); h: (B, width) fp32 carry. Returns (y in x_t's
    dtype, the fp32 new carry)."""
    a, b = _gates(p, x_t[:, None, :])
    h_new = a[:, 0, :] * h + b[:, 0, :]
    return h_new.to(x_t.dtype), h_new


# ---------------------------------------------------------------- conv1d ----

def causal_conv1d_init(gen, width: int, kernel_size: int = 4,
                       param_dtype=torch.float32, lead=(), device=None):
    return {
        "w": truncated_normal_init(gen, (*lead, kernel_size, width),
                                   kernel_size ** -0.5, param_dtype, device),
        "b": torch.zeros((*lead, width), dtype=param_dtype, device=device),
    }


def causal_conv1d(p, x: torch.Tensor, carry: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B, T, W); carry: (B, k-1, W) history.
    Returns (y in x's dtype, new carry)."""
    k = p["w"].shape[0]
    B, T, W = x.shape
    if carry is None:
        carry = torch.zeros((B, k - 1, W), dtype=x.dtype, device=x.device)
    xp = torch.cat([carry, x], dim=1)  # (B, T+k-1, W)
    y = torch.zeros((B, T, W), dtype=torch.float32, device=x.device)
    for i in range(k):
        y = y + xp[:, i:i + T].float() * p["w"][i].float()
    y = y + p["b"].float()
    return y.to(x.dtype), xp[:, -(k - 1):]


# ------------------------------------------------------- recurrent block ----

def griffin_recurrent_init(gen, d_model: int, width: int,
                           param_dtype=torch.float32, lead=(), device=None):
    kw = dict(lead=lead, device=device)
    return {
        "in_rec": dense_init(gen, d_model, width, param_dtype, **kw),
        "in_gate": dense_init(gen, d_model, width, param_dtype, **kw),
        "conv": causal_conv1d_init(gen, width, 4, param_dtype, **kw),
        "rglru": rglru_init(gen, width, param_dtype, **kw),
        "out": dense_init(gen, width, d_model, param_dtype, **kw),
    }


def griffin_recurrent_apply(p, x: torch.Tensor, state: Any = None):
    """Griffin recurrent branch: [linear -> conv -> RG-LRU] * gelu(linear).
    state = (conv_carry, h) or None. Returns (y, new_state)."""
    conv_carry, h0 = (None, None) if state is None else state
    u = dense(p["in_rec"], x)
    g = F.gelu(dense(p["in_gate"], x), approximate="tanh")
    u, conv_carry = causal_conv1d(p["conv"], u, conv_carry)
    h, hT = rglru_apply(p["rglru"], u, h0)
    y = dense(p["out"], h * g)
    return y, (conv_carry, hT)
