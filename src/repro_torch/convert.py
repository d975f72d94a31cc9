"""Carry weights from the JAX package into the port, leaf for leaf.

``params_from_jax`` takes a tree (nested dicts/lists/tuples) of numpy
arrays — ``np.asarray`` of each JAX leaf — and returns the same tree of
tensors with the same leaf names, layouts and dtypes. bfloat16 leaves
(numpy's ``ml_dtypes`` bfloat16) travel through their raw 16-bit pattern,
so no value is rounded on the way. Works for LM params, g params and
optimizer states (NamedTuples such as the reference's ``AdamState``) alike;
conv params keep the reference's HWIO layout (``nn/conv_blocks.py``), so
they carry unchanged too.

Image states differ in layout: the reference's are NHWC, the port's
NCHW. ``nchw_from_nhwc`` and ``nhwc_from_nchw`` carry a state, a batch of
images or a trajectory (a leading mesh axis) across, moving the channel
axis between last and third from last.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tensor_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device) if device is not None else t


def params_from_jax(tree: Any, device=None) -> Any:
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        children = [params_from_jax(v, device) for v in tree]
        if hasattr(tree, "_fields"):     # a NamedTuple takes its fields
            return type(tree)(*children)
        return type(tree)(children)
    if tree is None:
        return None
    return tensor_from_numpy(tree, device)


def nchw_from_nhwc(a: np.ndarray, device=None) -> torch.Tensor:
    """A reference image state ``(..., H, W, C)`` as the port's
    ``(..., C, H, W)`` tensor."""
    return tensor_from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(a), -1, -3)), device)


def nhwc_from_nchw(t: torch.Tensor) -> np.ndarray:
    """A port image state ``(..., C, H, W)`` as the reference's
    ``(..., H, W, C)`` numpy array."""
    return np.ascontiguousarray(np.moveaxis(t.detach().cpu().numpy(), -3, -1))
