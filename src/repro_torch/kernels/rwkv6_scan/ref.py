"""Plain PyTorch WKV6 recurrence — the CPU path of ``ops.py`` and the
oracle the CUDA kernel is held against on the card.

    kv  = k_t^T v_t                          (D, D) outer product
    o_t = r_t (S_{t-1} + diag(u) kv)
    S_t = diag(w_t) S_{t-1} + kv

a sequential loop over T in fp32, in the order of the reference's
``repro/nn/rwkv6.py`` scan step; each elementwise op rounds on its own
(no fused multiply-add), the order the kernel keeps for the state."""
from typing import Optional, Tuple

import torch


def wkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  S0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: (B, T, H, D) of any float type; u: (H, D); S0: optional
    (B, H, D, D) initial state (zeros if None). Returns o: fp32 (B, T, H, D)
    and the fp32 final state S_T: (B, H, D, D)."""
    B, T, H, D = r.shape
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()[None, :, :, None]                       # (1, H, D, 1)
    S = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
         if S0 is None else S0.float())
    o = torch.empty((B, T, H, D), dtype=torch.float32, device=r.device)
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]    # (B, H, D, D)
        o[:, t] = torch.einsum("bhi,bhij->bhj", r[:, t], S + u * kv)
        S = w[:, t, :, :, None] * S + kv
    return o, S
