"""Convolutional building blocks for the paper's image-classification
Neural ODEs (App. C.2) — the port of ``repro/nn/conv_blocks.py``:
DepthCat conv vector fields, conv HyperEuler nets, channel Augmenter,
PReLU, GroupNorm.

Layout. States and images are NCHW tensors (PyTorch's and cuDNN's
layout). Param leaves keep the reference's names and its HWIO conv
layout, so ``convert.py::params_from_jax`` carries them unchanged and a
checkpoint of conv g params restores in either package; ``conv2d`` hands
``F.conv2d`` the view ``w.permute(3, 2, 0, 1)`` (OIHW). Concatenations
(``depth_cat``, the ``[z, dz]`` input of g) run along dim 1 in the
reference's channel order — z, then dz, then s — so the in-channel order
of the carried weights holds. The heads flatten a 1-channel map, where
NHWC ``(H, W, 1)`` and NCHW ``(1, H, W)`` flatten in the same order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.module import truncated_normal_init


def conv2d_init(gen: torch.Generator, in_ch: int, out_ch: int, ksize: int,
                param_dtype=torch.float32, device=None):
    fan_in = in_ch * ksize * ksize
    return {
        "w": truncated_normal_init(gen, (ksize, ksize, in_ch, out_ch),
                                   fan_in ** -0.5, param_dtype, device),
        "b": torch.zeros((out_ch,), dtype=param_dtype, device=device),
    }


def conv2d(p, x: torch.Tensor) -> torch.Tensor:
    """NCHW 'SAME' conv over HWIO weights, accumulated and biased in
    float32 and rounded once to x's dtype (the reference's
    ``preferred_element_type=float32``)."""
    w = p["w"].permute(3, 2, 0, 1).to(x.dtype)
    if x.dtype == torch.float32:
        return F.conv2d(x, w, p["b"].float(), padding="same")
    y = F.conv2d(x, w, padding="same")
    return (y.float() + p["b"].float()[:, None, None]).to(x.dtype)


def prelu_init(ch: int, param_dtype=torch.float32, device=None):
    return {"alpha": torch.full((ch,), 0.25, dtype=param_dtype,
                                device=device)}


def prelu(p, x: torch.Tensor) -> torch.Tensor:
    a = p["alpha"].to(x.dtype)[:, None, None]
    return torch.where(x >= 0, x, a * x)


def groupnorm_init(ch: int, param_dtype=torch.float32, device=None):
    return {"scale": torch.ones((ch,), dtype=param_dtype, device=device),
            "bias": torch.zeros((ch,), dtype=param_dtype, device=device)}


def groupnorm(p, x: torch.Tensor, groups: int = 8, eps: float = 1e-5):
    """NCHW group norm over groups of contiguous channels, reduced in
    float32 with the biased variance (the reference's; a BatchNorm
    stand-in inside ODE fields, where running statistics are ill-defined
    along continuous depth)."""
    C = x.shape[1]
    g = min(groups, C)
    while C % g:
        g -= 1
    y = F.group_norm(x.float(), g, p["scale"].float(), p["bias"].float(),
                     eps)
    return y.to(x.dtype)


def depth_cat(x: torch.Tensor, s) -> torch.Tensor:
    """Concatenate the depth variable s as a constant channel (DepthCat).

    A tensor ``s`` is broadcast to the NHWC shape ``(B, H, W, 1)``, as the
    reference's ``jnp.broadcast_to`` does, so a per-sample ``(B,)`` depth
    raises here as it does there (the reference's conv fields take a
    scalar depth only). A Python number is filled on x's device."""
    B, _, H, W = x.shape
    if isinstance(s, torch.Tensor):
        s = s.to(device=x.device, dtype=x.dtype)
        s_chan = torch.broadcast_to(s, (B, H, W, 1)).permute(0, 3, 1, 2)
    else:
        s_chan = torch.full((B, 1, H, W), s, dtype=x.dtype, device=x.device)
    return torch.cat([x, s_chan], dim=1)
