"""Deterministic synthetic data — the port of ``synthetic_images`` of
``repro/data/synthetic.py`` (the container is offline).

Class-conditional stroke/blob renders in MNIST-like (28x28x1) and
CIFAR-like (32x32x3) formats stand in for the unavailable natural-image
sets. The numpy renderer is a copy of the reference's, so a seed gives
the same images and labels in both packages; the port hands them out
NCHW, its state layout (``nn/conv_blocks.py``). Token streams and 2-D
densities wait for ROADMAP.md queue 1 items 12 and 8.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def synthetic_images(kind: str, n: int, seed: int = 0, device=None):
    """Class-conditional procedural images. kind: 'mnist28' | 'cifar32'.
    Ten classes; each class is a deterministic arrangement of oriented
    strokes and blobs, plus noise. Returns (images NCHW float32 in
    [0, 1], int64 labels) on ``resolve_device(device)``: the reference's
    images for the same seed, channels first."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if kind == "mnist28":
        H = W = 28
        C = 1
    elif kind == "cifar32":
        H = W = 32
        C = 3
    else:
        raise ValueError(kind)
    ys = rng.integers(0, 10, n)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    imgs = np.zeros((n, H, W, C), np.float32)
    for i in range(n):
        c = ys[i]
        img = np.zeros((H, W), np.float32)
        # class-dependent strokes: k-th class gets k%3+1 bars at angle ~c
        for j in range(c % 3 + 1):
            ang = (c * 36.0 + j * 50.0) * np.pi / 180.0
            cx = H / 2 + rng.normal(0, 1.5)
            cy = W / 2 + rng.normal(0, 1.5)
            d = np.abs(np.cos(ang) * (xx - cx) + np.sin(ang) * (yy - cy))
            img += np.exp(-(d ** 2) / 4.0)
        # class-dependent blob ring
        r0 = 4.0 + (c % 5) * 2.0
        rr = np.sqrt((xx - W / 2) ** 2 + (yy - H / 2) ** 2)
        img += 0.7 * np.exp(-((rr - r0) ** 2) / 3.0) * ((c >= 5) * 1.0)
        img += 0.08 * rng.standard_normal((H, W))
        img = np.clip(img / max(img.max(), 1e-6), 0, 1)
        if C == 1:
            imgs[i, ..., 0] = img
        else:
            phase = np.array([1.0, 0.8 + 0.04 * c, 0.6 + 0.04 * c])
            imgs[i] = img[..., None] * phase[None, None]
    return (torch.from_numpy(np.ascontiguousarray(imgs.transpose(0, 3, 1, 2)))
            .to(dev), torch.from_numpy(ys.astype(np.int64)).to(dev))
