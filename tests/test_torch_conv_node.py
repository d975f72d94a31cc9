"""The paper's image-classification Neural ODEs in the port
(``repro_torch/nn/conv_blocks.py``, ``models/conv_node.py``,
``data/synthetic.py``) held against the JAX package on the CPU.

Params are drawn by the reference and carried across unchanged (HWIO
conv weights); states cross between the reference's NHWC and the port's
NCHW through ``convert.py``. Tolerances, float32: 1e-5 for the
elementwise blocks (PReLU, GroupNorm, DepthCat), 1e-4 through convs
(XLA and cuDNN/oneDNN reduce a conv in different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic_images as jax_images
from repro.models import conv_node as J
from repro.nn import conv_blocks as JB
from repro_torch.convert import nchw_from_nhwc, nhwc_from_nchw, params_from_jax
from repro_torch.data import synthetic_images
from repro_torch.models import conv_node as T
from repro_torch.nn import conv_blocks as TB

ELEM = dict(rtol=1e-5, atol=1e-5)
CONV = dict(rtol=1e-4, atol=1e-4)
B = 3


def _carry(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _nhwc(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(t, j, tol):
    np.testing.assert_allclose(nhwc_from_nchw(t), np.asarray(j), **tol)


# --------------------------------------------------------------- blocks ----

def test_conv2d_matches_reference():
    for k, cin, cout in ((3, 13, 64), (5, 17, 64), (3, 12, 1)):
        p = JB.conv2d_init(jax.random.PRNGKey(k + cin), cin, cout, k)
        p["b"] = jnp.asarray(_nhwc((cout,), 1))
        x = _nhwc((B, 9, 11, cin), 2)
        _close(TB.conv2d(_carry(p), nchw_from_nhwc(x)),
               JB.conv2d(p, jnp.asarray(x)), CONV)


def test_prelu_and_groupnorm_match_reference():
    x = _nhwc((B, 6, 5, 24), 3)
    pa = {"alpha": jnp.asarray(np.linspace(0.1, 0.4, 24, dtype=np.float32))}
    _close(TB.prelu(_carry(pa), nchw_from_nhwc(x)),
           JB.prelu(pa, jnp.asarray(x)), ELEM)
    for C, groups in ((24, 8), (24, 5), (3, 8)):   # 24/5 -> 4 groups; 3 -> 3
        xc = jnp.asarray(x[..., :C] * 3.0 + 1.0)
        pg = {"scale": jnp.asarray(_nhwc((C,), 4)),
              "bias": jnp.asarray(_nhwc((C,), 5))}
        _close(TB.groupnorm(_carry(pg), nchw_from_nhwc(np.asarray(xc)),
                            groups=groups),
               JB.groupnorm(pg, xc, groups=groups), ELEM)


@pytest.mark.parametrize("s", [0.375, "tensor"])
def test_depth_cat_matches_reference(s):
    x = _nhwc((B, 4, 6, 5), 6)
    s_j = jnp.float32(0.625) if s == "tensor" else s
    s_t = torch.tensor(0.625) if s == "tensor" else s
    out = TB.depth_cat(nchw_from_nhwc(x), s_t)
    assert out.shape == (B, 6, 4, 6)
    _close(out, JB.depth_cat(jnp.asarray(x), s_j), ELEM)


def test_per_sample_depth_raises_in_both_packages():
    """The reference's depth_cat broadcasts with ``jnp.broadcast_to`` and
    cannot lift a per-sample (B,) depth; the port keeps that behaviour,
    for the block and through a whole conv field."""
    x = _nhwc((B, 4, 4, 2), 7)
    s = np.linspace(0.1, 0.3, B).astype(np.float32)
    with pytest.raises(ValueError):
        JB.depth_cat(jnp.asarray(x), jnp.asarray(s))
    with pytest.raises(RuntimeError):
        TB.depth_cat(nchw_from_nhwc(x), torch.from_numpy(s))
    jnode, jp = J.mnist_node(jax.random.PRNGKey(0))
    z = _nhwc((B, 28, 28, 12), 8)
    with pytest.raises(ValueError):
        jnode.f_apply(jp, jnp.asarray(s), None, jnp.asarray(z))
    with pytest.raises(RuntimeError):
        T.mnist_f_apply(_carry(jp), torch.from_numpy(s), None,
                        nchw_from_nhwc(z))


# -------------------------------------------------------------- families ----

FAMILIES = {
    "mnist": (J.mnist_node, J.init_mnist_hyper, J.mnist_g_apply,
              T.mnist_f_apply, T.mnist_hx, T.mnist_hy, T.mnist_g_apply,
              (28, 1, 12)),
    "cifar": (J.cifar_node, J.init_cifar_hyper, J.cifar_g_apply,
              T.cifar_f_apply, T.cifar_hx, T.cifar_hy, T.cifar_g_apply,
              (32, 3, 8)),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("fn", ["f", "hx", "hy", "g"])
def test_family_maps_match_reference(family, fn):
    """f, hx, hy and g of each family on carried params; g's last conv is
    given random weights so its output is not the init's zero."""
    jnode_fn, jg_init, jg, tf, thx, thy, tg, (hw, cin, cz) = FAMILIES[family]
    jnode, jp = jnode_fn(jax.random.PRNGKey(1))
    gp = jg_init(jax.random.PRNGKey(2))
    last = sorted(k for k in gp if k.startswith("c"))[-1]
    gp[last]["w"] = jnp.asarray(0.05 * _nhwc(gp[last]["w"].shape, 9))
    tp, tgp = _carry(jp), _carry(gp)
    x = _nhwc((B, hw, hw, cin), 10)
    z = _nhwc((B, hw, hw, cz), 11)
    dz = _nhwc((B, hw, hw, cz), 12)
    if fn == "f":
        t, j = (tf(tp, 0.4, None, nchw_from_nhwc(z)),
                jnode.f_apply(jp, 0.4, None, jnp.asarray(z)))
    elif fn == "hx":
        t, j = thx(tp, nchw_from_nhwc(x)), jnode.hx_apply(jp, jnp.asarray(x))
    elif fn == "g":
        t, j = (tg(tgp, 0.1, 0.4, None, nchw_from_nhwc(z), nchw_from_nhwc(dz)),
                jg(gp, 0.1, 0.4, None, jnp.asarray(z), jnp.asarray(dz)))
    else:
        np.testing.assert_allclose(
            thy(tp, nchw_from_nhwc(z)).numpy(),
            np.asarray(jnode.hy_apply(jp, jnp.asarray(z))), **CONV)
        return
    _close(t, j, CONV)


def test_head_flattens_row_major_over_h_w():
    """The head flattens its 1-channel map as NHWC (H, W, 1) does: with an
    identity head conv (centre tap of channel 0) and a head_lin whose
    column j reads pixel (r_j, c_j), logit j is z[:, 0, r_j, c_j]."""
    p = _carry(J.init_mnist_node(jax.random.PRNGKey(3)))
    w = torch.zeros_like(p["head_conv"]["w"])
    w[1, 1, 0, 0] = 1.0
    pix = [(0, 0), (0, 27), (1, 0), (5, 9), (27, 0), (27, 27), (13, 14),
           (14, 13), (3, 20), (20, 3)]
    lin = torch.zeros(784, 10)
    for j, (r, c) in enumerate(pix):
        lin[r * 28 + c, j] = 1.0
    p["head_conv"] = {"w": w, "b": torch.zeros(1)}
    p["head_lin"] = {"kernel": lin}
    z = torch.from_numpy(np.random.RandomState(4).randn(B, 12, 28, 28)
                         .astype(np.float32))
    want = torch.stack([z[:, 0, r, c] for r, c in pix], dim=1)
    assert torch.equal(T.mnist_hy(p, z), want)


def test_macs_formulas_equal_reference():
    assert T.mnist_f_macs() == J.mnist_f_macs()
    assert T.mnist_g_macs() == J.mnist_g_macs()
    assert T.mnist_f_macs(32) == J.mnist_f_macs(32)
    assert T.conv_macs(7, 5, 3, 2, 5) == J.conv_macs(7, 5, 3, 2, 5)


@pytest.mark.parametrize("family", ["mnist", "cifar"])
def test_g_is_zero_at_init_and_trees_match(family):
    """The port's inits give the reference's param trees (names, shapes,
    dtypes) and a g that is exactly zero."""
    t_node, t_g, tg = {"mnist": (T.init_mnist_node, T.init_mnist_hyper,
                                 T.mnist_g_apply),
                       "cifar": (T.init_cifar_node, T.init_cifar_hyper,
                                 T.cifar_g_apply)}[family]
    j_node, j_g = {"mnist": (J.init_mnist_node, J.init_mnist_hyper),
                   "cifar": (J.init_cifar_node, J.init_cifar_hyper)}[family]
    gen = torch.Generator().manual_seed(0)
    for t_init, j_init in ((t_node, j_node), (t_g, j_g)):
        tp = t_init(gen, device="cpu")
        jp = j_init(jax.random.PRNGKey(0))
        t_leaves = jax.tree_util.tree_flatten_with_path(
            jax.tree_util.tree_map(lambda l: l.numpy(), tp))[0]
        j_leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
        assert [(k, v.shape, v.dtype.name) for k, v in t_leaves] == \
            [(k, v.shape, v.dtype.name) for k, v in j_leaves]
    gp = t_g(gen, device="cpu")
    hw, cz = (28, 12) if family == "mnist" else (32, 8)
    z = torch.randn(2, cz, hw, hw, generator=gen)
    out = tg(gp, 0.1, 0.3, None, z, torch.randn(2, cz, hw, hw, generator=gen))
    assert out.shape == z.shape and not out.abs().max()


@pytest.mark.parametrize("kind", ["mnist28", "cifar32"])
def test_synthetic_images_bit_for_bit(kind):
    xs_j, ys_j = jax_images(kind, 12, seed=5)
    xs_t, ys_t = synthetic_images(kind, 12, seed=5, device="cpu")
    assert xs_t.dtype == torch.float32 and xs_t.shape[1] in (1, 3)
    assert np.array_equal(nhwc_from_nchw(xs_t), np.asarray(xs_j))
    assert np.array_equal(ys_t.numpy(), np.asarray(ys_j))
