"""Deterministic synthetic data — the port of ``repro/data/synthetic.py``
(the container is offline).

* token streams: order-2 Markov sequences over a reduced alphabet, a
  learnable next-token process for LM training loops;
* 2-D densities for CNFs: pinwheel / rings / checkerboard / circles (the
  paper's own procedural densities, Sec. 4.2 + Grathwohl et al.);
* class-conditional stroke/blob renders in MNIST-like (28x28x1) and
  CIFAR-like (32x32x3) formats stand in for the unavailable
  natural-image sets.

The numpy code is a copy of the reference's, so a seed gives the same
tokens, points, images and labels in both packages; the port hands
images out NCHW, its state layout (``nn/conv_blocks.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


# ------------------------------------------------------------- tokens ----

def token_batches(vocab: int, batch: int, seq_len: int, seed: int = 0,
                  device=None):
    """Endless (tokens, next tokens) batches, each (batch, seq_len) int32
    on ``resolve_device(device)``: an order-2 Markov chain over a reduced
    alphabet embedded in [0, vocab), the reference's tokens for the same
    seed."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    alpha = min(vocab, 512)
    trans = rng.dirichlet(np.full(alpha, 0.05), size=(alpha, alpha))
    cum = np.cumsum(trans, axis=-1)
    while True:
        toks = np.zeros((batch, seq_len + 1), np.int64)
        toks[:, 0] = rng.integers(0, alpha, batch)
        toks[:, 1] = rng.integers(0, alpha, batch)
        u = rng.random((batch, seq_len + 1))
        for t in range(2, seq_len + 1):
            c = cum[toks[:, t - 2], toks[:, t - 1]]
            toks[:, t] = (u[:, t, None] < c).argmax(-1)
        yield (torch.from_numpy(toks[:, :-1].astype(np.int32)).to(dev),
               torch.from_numpy(toks[:, 1:].astype(np.int32)).to(dev))


# ----------------------------------------------------------- densities ----

def _pinwheel(rng, n):
    radial_std, tangential_std, num_classes, rate = 0.3, 0.1, 5, 0.25
    rads = np.linspace(0, 2 * np.pi, num_classes, endpoint=False)
    feats = rng.standard_normal((n, 2)) * np.array([radial_std,
                                                    tangential_std])
    feats[:, 0] += 1.0
    labels = rng.integers(0, num_classes, n)
    angles = rads[labels] + rate * np.exp(feats[:, 0])
    rot = np.stack([np.cos(angles), -np.sin(angles),
                    np.sin(angles), np.cos(angles)], -1).reshape(n, 2, 2)
    return 2.0 * np.einsum("ni,nij->nj", feats, rot)


def _rings(rng, n):
    n_per = n // 3 + 1
    pts = []
    for r in (1.0, 2.0, 3.0):
        t = rng.random(n_per) * 2 * np.pi
        pts.append(np.stack([r * np.cos(t), r * np.sin(t)], -1))
    x = np.concatenate(pts)[:n]
    return x + 0.08 * rng.standard_normal((n, 2))


def _checkerboard(rng, n):
    x1 = rng.random(n) * 4 - 2
    x2_ = rng.random(n) - rng.integers(0, 2, n) * 2
    x2 = x2_ + np.floor(x1) % 2
    return np.stack([x1, x2], -1) * 2


def _circles(rng, n):
    """Paper's 'modified, more challenging circles': two annuli connected
    by three curves."""
    n_ring = int(n * 0.8)
    n_arm = n - n_ring
    pts = []
    for r in (1.0, 2.5):
        t = rng.random(n_ring // 2 + 1) * 2 * np.pi
        pts.append(np.stack([r * np.cos(t), r * np.sin(t)], -1))
    ring = np.concatenate(pts)[:n_ring]
    a = rng.integers(0, 3, n_arm)
    base = a * 2 * np.pi / 3
    rr = 1.0 + 1.5 * rng.random(n_arm)
    curve = base + 0.4 * (rr - 1.0)
    arm = np.stack([rr * np.cos(curve), rr * np.sin(curve)], -1)
    x = np.concatenate([ring, arm])
    return x + 0.05 * rng.standard_normal(x.shape)


DENSITIES = {
    "pinwheel": _pinwheel,
    "rings": _rings,
    "checkerboard": _checkerboard,
    "circles": _circles,
}


def density_sampler(name: str, batch: int, seed: int = 0, device=None):
    """Endless batches of ``batch`` points of density ``name``: the
    reference's points for the same seed, float32 on
    ``resolve_device(device)``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    fn = DENSITIES[name]
    while True:
        yield torch.from_numpy(fn(rng, batch).astype(np.float32)).to(dev)


# -------------------------------------------------------------- images ----


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
