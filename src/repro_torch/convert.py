"""Carry weights from the JAX package into the port, leaf for leaf.

``params_from_jax`` takes a tree (nested dicts/lists/tuples) of numpy
arrays — ``np.asarray`` of each JAX leaf — and returns the same tree of
tensors with the same leaf names, layouts and dtypes. bfloat16 leaves
(numpy's ``ml_dtypes`` bfloat16) travel through their raw 16-bit pattern,
so no value is rounded on the way. Works for LM params, g params and
optimizer states (NamedTuples such as the reference's ``AdamState``) alike.
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
