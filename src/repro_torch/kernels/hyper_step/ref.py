"""Plain PyTorch versions of the fused hypersolver update — the CPU path of
``ops.py`` and the oracle the CUDA kernel is held against on the card."""
import torch


def _coef(a, leaf: torch.Tensor) -> torch.Tensor:
    """Right-pad a scalar-or-(B,) coefficient to broadcast against leaf."""
    a = torch.as_tensor(a, dtype=torch.float32, device=leaf.device)
    if a.ndim:
        a = a.reshape(a.shape + (1,) * (leaf.ndim - a.ndim))
    return a


def fused_rk_update_ref(z, stages, g, eps, b, order: int, active=None):
    """eps scalar or per-sample (B,) row; ``active`` an optional (B,) mask
    row freezing inactive samples at z. fp32 accumulation in the order
    z, stages, g; one rounding to z's dtype."""
    z32 = z.float()
    out = z32
    e = _coef(eps, z)
    for bj, r in zip(b, stages):
        if bj != 0.0:
            out = out + (e * bj) * r.float()
    if g is not None:
        out = out + (e ** (order + 1)) * g.float()
    if active is not None:
        act = torch.as_tensor(active, device=z.device)
        act = act.reshape(act.shape + (1,) * (z.ndim - act.ndim))
        out = torch.where(act != 0, out, z32)
    return out.to(z.dtype)
