"""Plain PyTorch WKV6 recurrence — the CPU path of ``ops.py`` and the
oracle the CUDA kernel is held against on the card.

    kv  = k_t^T v_t                          (D, D) outer product
    o_t = r_t (S_{t-1} + diag(u) kv)
    S_t = diag(w_t) S_{t-1} + kv

a sequential loop over T in fp32, in the order of the reference's
``repro/nn/rwkv6.py`` scan step; each elementwise op rounds on its own
(no fused multiply-add), the order the kernel keeps for the state. Its
gradient, ``wkv6_scan_backward_ref``, is the CPU implementation of the
operator ``repro_torch::wkv6_backward`` (``ops.py``) and the oracle the
backward kernel (``csrc/rwkv6_scan_backward.cu``) is held against on the
card."""
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


def wkv6_scan_backward_ref(go: Optional[torch.Tensor],
                           gS: Optional[torch.Tensor], r: torch.Tensor,
                           k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                           u: torch.Tensor, S0: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``wkv6_scan_ref`` written out as a recurrence
    backward in time, against ``go`` (of o) and ``gS`` (of S_T), either
    None for no gradient. The forward states S_{-1} = S0 ... S_{T-2} are
    recomputed in fp32 and held (T (B, H, D, D) blocks); then for t from
    T - 1 down to 0, with dS carried from gS (or zero):

        M = S_{t-1} + u kv_t,   dM = r_t^T go_t,   dr_t = M go_t
        dkv = dM u + dS,        du += sum_{b, j} dM kv_t
        dw_t = sum_j dS S_{t-1},   dk_t = dkv v_t,   dv_t = k_t^T dkv
        dS <- dM + w_t dS

    and dS0 is the last dS. Each sum is the one autograd of the loop
    makes, so the two agree to fp32 rounding. Returns (dr, dk, dv, dw, du,
    dS0), each in its input's dtype; dS0 an empty fp32 (0,) without S0."""
    B, T, H, D = r.shape
    dev, f32 = r.device, torch.float32
    r32, k32, v32, w32 = (t.float() for t in (r, k, v, w))
    u32 = u.float()[None, :, :, None]                     # (1, H, D, 1)
    S = (torch.zeros((B, H, D, D), dtype=f32, device=dev) if S0 is None
         else S0.float())
    states = []
    for t in range(T):
        states.append(S)
        S = w32[:, t, :, :, None] * S \
            + k32[:, t, :, :, None] * v32[:, t, :, None, :]
    dS = (torch.zeros((B, H, D, D), dtype=f32, device=dev) if gS is None
          else gS.float().clone())
    dr, dk, dv, dw = (torch.zeros((B, T, H, D), dtype=f32, device=dev)
                      for _ in range(4))
    du = torch.zeros(u32.shape, dtype=f32, device=dev)
    for t in range(T - 1, -1, -1):
        S = states.pop()                                  # S_{t-1}
        kt, vt = k32[:, t, :, :, None], v32[:, t, :, None, :]
        kv = kt * vt
        dkv = dS
        if go is not None:
            go_t = go[:, t].float()
            dM = r32[:, t, :, :, None] * go_t[:, :, None, :]
            # the einsum's bmm gradient, as autograd makes it
            dr[:, t] = torch.bmm(
                go_t.reshape(B * H, 1, D),
                (S + u32 * kv).reshape(B * H, D, D).transpose(1, 2),
            ).reshape(B, H, D)
            du += (dM * kv).sum((0, 3), keepdim=True)
            dkv = dM * u32 + dS
        dw[:, t] = (dS * S).sum(-1)
        dk[:, t] = (dkv * vt).sum(-1)
        dv[:, t] = (dkv * kt).sum(-2)
        dS = w32[:, t, :, :, None] * dS
        if go is not None:
            dS = dM + dS
    dS0 = (torch.empty((0,), dtype=f32, device=dev) if S0 is None
           else dS.to(S0.dtype))
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du[0, :, :, 0].to(u.dtype), dS0)
