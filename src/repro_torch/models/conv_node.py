"""The paper's image-classification Neural ODEs (App. C.2) — the port of
``repro/models/conv_node.py``. States are NCHW; params keep the
reference's names and HWIO layout (``nn/conv_blocks.py``).

MNIST-family (1x28x28):
    aug: conv(1->12, k3)
    f:   DepthCat -> conv(13->64, k3) -> tanh -> DepthCat ->
         conv(65->12, k3)                       (channels 12-64-12, paper)
    head: conv(12->1, k3) -> flatten -> linear(784->10)
    g (HyperEuler): conv(25->64, k3) -> PReLU -> conv(64->12, k3)
         (input = [z(12), dz(12), s(1)] = 25 channels, paper)

CIFAR-family (3x32x32):
    aug: conv(3->5, k3) (concat -> 8 channels)
    f:   DepthCat -> conv(9->64) -> GN -> tanh -> DepthCat ->
         conv(65->64) -> GN -> tanh -> conv(64->8)
    head: conv(8->1) -> flatten -> linear(1024->10)
    g:   conv(17->64, k5) -> PReLU -> conv(64->32, k5) -> PReLU ->
         conv(32->8, k3)

GroupNorm replaces the paper's BatchNorm inside f (running statistics are
ill-defined along continuous depth). The last conv of each g starts at
zero, so g == 0 at init. ``init_*`` draw from ``gen``, a
``torch.Generator`` on the device the params go to
(``resolve_device(device)``: cuda unless ``device="cpu"``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.integrate import Integrator
from repro_torch.core.neural_ode import NeuralODE
from repro_torch.nn.conv_blocks import (conv2d, conv2d_init, depth_cat,
                                        groupnorm, groupnorm_init, prelu,
                                        prelu_init)
from repro_torch.nn.module import dense_init


def conv_macs(h, w, cin, cout, k):
    return h * w * cin * cout * k * k


def _head(params, z):
    h = conv2d(params["head_conv"], z)
    return h.reshape(h.shape[0], -1) @ params["head_lin"]["kernel"]


def _g_input(z, dz, s):
    return depth_cat(torch.cat([z, dz], dim=1), s)


# ------------------------------------------------------------- MNIST ----

def init_mnist_node(gen: torch.Generator, device=None):
    dev = resolve_device(device)
    return {
        "aug": conv2d_init(gen, 1, 12, 3, device=dev),
        "f1": conv2d_init(gen, 13, 64, 3, device=dev),
        "f2": conv2d_init(gen, 65, 12, 3, device=dev),
        "head_conv": conv2d_init(gen, 12, 1, 3, device=dev),
        "head_lin": dense_init(gen, 28 * 28, 10, device=dev),
    }


def mnist_f_apply(params, s, x, z):
    h = depth_cat(z, s)
    h = torch.tanh(conv2d(params["f1"], h))
    h = depth_cat(h, s)
    return conv2d(params["f2"], h)


def mnist_hx(params, x):
    return conv2d(params["aug"], x)


def mnist_hy(params, z):
    return _head(params, z)


def mnist_node(gen: torch.Generator, device=None
               ) -> Tuple[NeuralODE, dict]:
    params = init_mnist_node(gen, device)
    node = NeuralODE(f_apply=mnist_f_apply, hx_apply=mnist_hx,
                     hy_apply=mnist_hy, s_span=(0.0, 1.0))
    return node, params


def mnist_f_macs(hw: int = 28) -> int:
    return conv_macs(hw, hw, 13, 64, 3) + conv_macs(hw, hw, 65, 12, 3)


def init_mnist_hyper(gen: torch.Generator, device=None):
    dev = resolve_device(device)
    p = {
        "c1": conv2d_init(gen, 25, 64, 3, device=dev),
        "a1": prelu_init(64, device=dev),
        "c2": conv2d_init(gen, 64, 12, 3, device=dev),
    }
    p["c2"]["w"] = torch.zeros_like(p["c2"]["w"])  # start at g == 0
    return p


def mnist_g_apply(gp, eps, s, x, z, dz):
    h = _g_input(z, dz, s)                               # 25 channels
    h = prelu(gp["a1"], conv2d(gp["c1"], h))
    return conv2d(gp["c2"], h)


def mnist_g_macs(hw: int = 28) -> int:
    return conv_macs(hw, hw, 25, 64, 3) + conv_macs(hw, hw, 64, 12, 3)


def mnist_integrator(gp=None, x=None, base="euler",
                     fused: bool = False) -> Integrator:
    """Unified-engine solver for the MNIST-family Neural ODE: plain base
    tableau when ``gp`` is None, HyperEuler-style correction otherwise."""
    from repro_torch.core.train import make_integrator
    return make_integrator(base, mnist_g_apply if gp is not None else None,
                           gp, x, fused=fused)


# ------------------------------------------------------------- CIFAR ----

def init_cifar_node(gen: torch.Generator, device=None):
    dev = resolve_device(device)
    return {
        "aug": conv2d_init(gen, 3, 5, 3, device=dev),
        "f1": conv2d_init(gen, 9, 64, 3, device=dev),
        "gn1": groupnorm_init(64, device=dev),
        "f2": conv2d_init(gen, 65, 64, 3, device=dev),
        "gn2": groupnorm_init(64, device=dev),
        "f3": conv2d_init(gen, 64, 8, 3, device=dev),
        "head_conv": conv2d_init(gen, 8, 1, 3, device=dev),
        "head_lin": dense_init(gen, 32 * 32, 10, device=dev),
    }


def cifar_f_apply(params, s, x, z):
    h = depth_cat(z, s)
    h = torch.tanh(groupnorm(params["gn1"], conv2d(params["f1"], h)))
    h = depth_cat(h, s)
    h = torch.tanh(groupnorm(params["gn2"], conv2d(params["f2"], h)))
    return conv2d(params["f3"], h)


def cifar_hx(params, x):
    return torch.cat([x, conv2d(params["aug"], x)], dim=1)


def cifar_hy(params, z):
    return _head(params, z)


def cifar_node(gen: torch.Generator, device=None
               ) -> Tuple[NeuralODE, dict]:
    params = init_cifar_node(gen, device)
    node = NeuralODE(f_apply=cifar_f_apply, hx_apply=cifar_hx,
                     hy_apply=cifar_hy, s_span=(0.0, 1.0))
    return node, params


def init_cifar_hyper(gen: torch.Generator, device=None):
    dev = resolve_device(device)
    p = {
        "c1": conv2d_init(gen, 17, 64, 5, device=dev),
        "a1": prelu_init(64, device=dev),
        "c2": conv2d_init(gen, 64, 32, 5, device=dev),
        "a2": prelu_init(32, device=dev),
        "c3": conv2d_init(gen, 32, 8, 3, device=dev),
    }
    p["c3"]["w"] = torch.zeros_like(p["c3"]["w"])
    return p


def cifar_g_apply(gp, eps, s, x, z, dz):
    h = _g_input(z, dz, s)                               # 17 channels
    h = prelu(gp["a1"], conv2d(gp["c1"], h))
    h = prelu(gp["a2"], conv2d(gp["c2"], h))
    return conv2d(gp["c3"], h)


def cifar_integrator(gp=None, x=None, base="euler",
                     fused: bool = False) -> Integrator:
    """Unified-engine solver for the CIFAR-family Neural ODE."""
    from repro_torch.core.train import make_integrator
    return make_integrator(base, cifar_g_apply if gp is not None else None,
                           gp, x, fused=fused)
