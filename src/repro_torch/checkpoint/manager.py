"""Checkpoint restore — reads what the JAX package's ``CheckpointManager``
writes, so a correction g trained there serves in the port (``--g-ckpt``).

Layout: ``<dir>/step_<N>/{manifest.json, <i>.npy.zst}``, one raw
little-endian buffer per leaf, compressed with the codec the manifest
names ("zstd" — read when the ``zstandard`` package imports — "zlib" or
"raw"). Leaves are numbered in JAX's ``tree_flatten`` order, which sorts
dict keys: an LM correction is stored as ``w_dh, w_h, w_out, w_s``. The
save side waits for the online refinery (ROADMAP.md queue 1).
"""
from __future__ import annotations

import json
import os
import re
import zlib
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

try:  # optional dependency, as in the reference
    import zstandard
except ImportError:
    zstandard = None


def _decompress(codec: str, buf: bytes) -> bytes:
    if codec == "zstd":
        if zstandard is None:
            raise RuntimeError(
                "checkpoint was written with codec='zstd' but the zstandard "
                "package is not installed")
        return zstandard.ZstdDecompressor().decompress(buf)
    if codec == "zlib":
        return zlib.decompress(buf)
    if codec == "raw":
        return buf
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _to_tensor(raw: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(dtype))
                            .reshape(shape).copy())


def flatten_sorted(tree: Any) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """Leaves in JAX's ``tree_flatten`` order (dict keys sorted; lists and
    tuples in order; None is an empty subtree) and a function rebuilding
    the tree from such a list."""
    leaves: List[Any] = []

    def walk(t):
        if isinstance(t, dict):
            keys = sorted(t)
            subs = [walk(t[k]) for k in keys]
            return lambda it: {k: s(it) for k, s in zip(keys, subs)}
        if isinstance(t, (list, tuple)):
            subs = [walk(x) for x in t]
            return lambda it: type(t)(s(it) for s in subs)
        if t is None:
            return lambda it: None
        leaves.append(t)
        return lambda it: next(it)

    build = walk(tree)
    return leaves, lambda new: build(iter(new))


class CheckpointManager:
    """Restore side of the reference's checkpoint manager."""

    def __init__(self, directory: str):
        self.dir = directory

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def restore(self, step: int, like: Any, device=None) -> Any:
        """``like``: a tree with the target structure whose leaves have
        ``.shape`` (tensors). Returns the same tree of tensors on
        ``device``, each in the dtype the checkpoint stored."""
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat_like, unflatten = flatten_sorted(like)
        if manifest["n_leaves"] != len(flat_like):
            raise ValueError(f"checkpoint {d} holds {manifest['n_leaves']} "
                             f"leaves, the target tree {len(flat_like)}")
        codec = manifest.get("codec", "zstd")  # pre-tag ckpts: zstd
        out = []
        for i, l in enumerate(flat_like):
            with open(os.path.join(d, f"{i}.npy.zst"), "rb") as fh:
                raw = _decompress(codec, fh.read())
            t = _to_tensor(raw, manifest["dtypes"][i], manifest["shapes"][i])
            if tuple(t.shape) != tuple(l.shape):
                raise ValueError(f"leaf {i}: checkpoint shape "
                                 f"{tuple(t.shape)}, target {tuple(l.shape)}")
            out.append(t.to(device) if device is not None else t)
        return unflatten(out)
