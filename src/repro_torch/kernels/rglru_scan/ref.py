"""Plain PyTorch RG-LRU scan — the CPU path of ``ops.py`` and the oracle
the CUDA kernel is held against on the card (bit for bit in fp32).

    h_t = a_t * h_{t-1} + b_t,   h_{-1} = 0

a sequential loop over T with an fp32 carry: the multiply rounds, then
the add (no fused multiply-add), the order the kernel keeps. Its
gradient, ``rglru_scan_backward_ref``, is the CPU implementation of the
operator ``repro_torch::rglru_scan_backward`` (``ops.py``) and the oracle
the backward kernel (``csrc/rglru_scan_backward.cu``) is held against on
the card, bit for bit."""
from typing import Tuple

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, T, W) of any float type -> h: fp32 (B, T, W)."""
    a32, b32 = a.float(), b.float()
    out = torch.empty_like(a32)
    h = torch.zeros_like(a32[:, 0])
    for t in range(a32.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        out[:, t] = h
    return out


def rglru_scan_backward_ref(grad: torch.Tensor, a: torch.Tensor,
                            h: torch.Tensor, b_dtype: torch.dtype
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of ``rglru_scan_ref`` written out as a recurrence
    backward in time: grad (B, T, W) of h; a the forward's gates; h its
    fp32 output (the kernel's, equal to the plain version's). For t from
    T - 1 down to 0

        dh_t = g_t + a_{t+1} dh_{t+1},   db_t = dh_t,   da_t = dh_t h_{t-1}

    with each product and sum rounded as autograd of the loop rounds them
    (h_{-1} = 0), so both are equal bit for bit. Returns (da in a's dtype,
    db in ``b_dtype``), the cast autograd of ``.float()`` makes."""
    a32, g = a.float(), grad.float()
    dh = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    carry = None
    for t in range(g.shape[1] - 1, -1, -1):
        carry = g[:, t] if carry is None else g[:, t] + a32[:, t + 1] * carry
        dh[:, t] = carry
    h_prev = torch.zeros_like(dh)
    h_prev[:, 1:] = h[:, :-1]
    return (dh * h_prev).to(a.dtype), dh.to(b_dtype)
