"""Plain PyTorch RG-LRU scan — the CPU path of ``ops.py`` and the oracle
the CUDA kernel is held against on the card (bit for bit in fp32).

    h_t = a_t * h_{t-1} + b_t,   h_{-1} = 0

a sequential loop over T with an fp32 carry: the multiply rounds, then
the add (no fused multiply-add), the order the kernel keeps."""
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
