"""Plain PyTorch attention — the port's copy of
``repro/kernels/flash_attention/ref.py::attention_ref``, in the port's
``(B, S, H, hd)`` layout. The CPU path of ``ops.py`` and the oracle the
CUDA kernel is held against on the card.

Scores, mask and softmax in float32; float32 probabilities times float32
V (never rounded to the activation type in between); the output rounded
once to q's dtype. Masked scores take the finite ``NEG_INF``, as the
Pallas kernel's do.
"""
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with H % KV == 0 (Sq !=
    Sk: cross-attention, called without a causal mask or window).
    Returns (B, Sq, H, hd) in q's dtype. Any lengths (no block
    padding)."""
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bsngh,btnh->bngst", qf, k.float()) * hd ** -0.5
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (k_pos <= q_pos)
    if window is not None:
        ok = ok & (q_pos - k_pos < window)
    s = torch.where(ok, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngst,btnh->bsngh", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)
