"""The port's adaptive Dormand-Prince solver (``repro_torch/core/adaptive.py``)
and the embedded-error helpers it shares with the controllers, held
against the JAX package on the CPU (mirrors ``tests/test_adaptive.py``).

``odeint_dopri5`` must take the reference's step sequence: equal NFE,
trajectories within 1e-5 (float32; the port reduces the error ratio and
the convs in another order than XLA). Every accept/reject ratio on both
sides is recorded and asserted to lie more than 1e-3 from 1, so that
rounding cannot flip a step decision."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.adaptive as jax_adaptive
import repro_torch.core.adaptive as torch_adaptive
from repro.core import FixedGrid as JaxGrid
from repro.core import controllers as JC
from repro.data import synthetic_images as jax_images
from repro.models import conv_node as J
from repro_torch.convert import nchw_from_nhwc, nhwc_from_nchw, params_from_jax
from repro_torch.core import FixedGrid, controllers as TC, odeint_dopri5
from repro_torch.models import conv_node as T

TRAJ = dict(rtol=1e-5, atol=1e-5)
A = np.array([[-0.5, -2.0], [2.0, -0.5]], dtype=np.float32)


def _expm(M):
    w, V = np.linalg.eig(np.asarray(M, np.float64))
    return (V @ np.diag(np.exp(w)) @ np.linalg.inv(V)).real


def test_controller_constants_equal_reference():
    assert (TC.SAFETY, TC.MIN_FACTOR, TC.MAX_FACTOR) == \
        (JC.SAFETY, JC.MIN_FACTOR, JC.MAX_FACTOR)


def test_error_ratio_matches_reference():
    rs = np.random.RandomState(0)
    z = {"a": rs.randn(4, 6).astype(np.float32),
         "b": rs.randn(3).astype(np.float32)}
    zn = {k: v + 0.1 * rs.randn(*v.shape).astype(np.float32)
          for k, v in z.items()}
    err = {k: 1e-3 * rs.randn(*v.shape).astype(np.float32)
           for k, v in z.items()}
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    for atol, rtol in ((1e-4, 1e-4), (1e-6, 1e-3)):
        got = TC.error_ratio(t(z), t(zn), t(err), atol, rtol)
        want = JC.error_ratio(z, zn, err, atol, rtol)
        assert got.dtype == torch.float32 and got.ndim == 0
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("order", [1, 4, 5])
def test_step_factor_matches_reference(order):
    ratios = np.array([0.0, 1e-12, 1e-4, 0.3, 0.99, 1.0, 1.7, 50.0, 1e6],
                      np.float32)
    got = TC.step_factor(torch.from_numpy(ratios), order).numpy()
    want = np.asarray(JC.step_factor(jnp.asarray(ratios), order))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.fixture
def ratios(monkeypatch):
    """Record every accept/reject ratio of both solvers: the port's as
    floats, the reference's through ``jax.debug.callback`` out of its
    while_loop."""
    seen = {"torch": [], "jax": []}

    def torch_ratio(*a):
        r = TC.error_ratio(*a)
        seen["torch"].append(float(r))
        return r

    def jax_ratio(*a):
        r = JC.error_ratio(*a)
        jax.debug.callback(lambda v: seen["jax"].append(float(v)), r)
        return r

    monkeypatch.setattr(torch_adaptive, "error_ratio", torch_ratio)
    monkeypatch.setattr(jax_adaptive, "error_ratio", jax_ratio)
    return seen


def _assert_same_steps(seen, nfe_t, nfe_j):
    assert nfe_t == int(nfe_j)
    assert len(seen["torch"]) == len(seen["jax"]) == nfe_t // 6
    for side in ("torch", "jax"):
        near = [r for r in seen[side] if abs(r - 1.0) <= 1e-3]
        assert not near, (side, near)
    assert [r <= 1.0 for r in seen["torch"]] == \
        [r <= 1.0 for r in seen["jax"]]


@pytest.mark.parametrize("tol", [1e-3, 1e-5])
def test_dopri5_matches_reference_on_linear_ode(ratios, tol):
    z0 = np.array([[1.0, 0.5], [-0.3, 2.0]], np.float32)
    traj_j, nfe_j = jax_adaptive.odeint_dopri5(
        lambda s, z: z @ jnp.asarray(A).T, jnp.asarray(z0),
        JaxGrid.over(0.0, 1.0, 4), atol=tol, rtol=tol)
    At = torch.from_numpy(A)
    traj_t, nfe_t = odeint_dopri5(lambda s, z: z @ At.T, torch.from_numpy(z0),
                                  FixedGrid.over(0.0, 1.0, 4), atol=tol,
                                  rtol=tol)
    assert traj_t.shape == (5, 2, 2) and isinstance(nfe_t, int)
    _assert_same_steps(ratios, nfe_t, nfe_j)
    np.testing.assert_allclose(traj_t.numpy(), np.asarray(traj_j), **TRAJ)
    exact = z0 @ _expm(A).T
    assert np.abs(traj_t[-1].numpy() - exact).max() < 100 * tol


def test_dopri5_matches_reference_on_mnist_field(ratios):
    """The MNIST-family conv field, carried params scaled up so that the
    solve rejects and grows steps (not one step a segment), at K 4."""
    jnode, jp = J.mnist_node(jax.random.PRNGKey(0))
    jp = dict(jp, f1={"w": jp["f1"]["w"] * 3.0, "b": jp["f1"]["b"]},
              f2={"w": jp["f2"]["w"] * 3.0, "b": jp["f2"]["b"]})
    xs, _ = jax_images("mnist28", 2, seed=1)
    traj_j, nfe_j = jax_adaptive.odeint_dopri5(
        jnode.field(jp, xs), jnode.hx_apply(jp, xs), JaxGrid.over(0.0, 1.0, 4),
        atol=1e-4, rtol=1e-4)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    x = nchw_from_nhwc(np.asarray(xs))
    traj_t, nfe_t = odeint_dopri5(
        lambda s, z: T.mnist_f_apply(tp, s, x, z), T.mnist_hx(tp, x),
        FixedGrid.over(0.0, 1.0, 4), atol=1e-4, rtol=1e-4)
    assert nfe_t > 4 * 6, nfe_t
    _assert_same_steps(ratios, nfe_t, nfe_j)
    np.testing.assert_allclose(nhwc_from_nchw(traj_t), np.asarray(traj_j),
                               **TRAJ)


def test_nfe_monotone_in_tolerance():
    At = torch.from_numpy(A)
    z0 = torch.tensor([[1.0, -0.3]])
    nfes = [odeint_dopri5(lambda s, z: z @ At.T, z0,
                          FixedGrid.over(0.0, 1.0, 4), atol=t, rtol=t)[1]
            for t in (1e-2, 1e-3, 1e-4, 1e-5)]
    assert nfes == sorted(nfes) and nfes[-1] > nfes[0], nfes


def test_dopri5_caps_a_segment_and_refuses_batched_eps():
    At = torch.from_numpy(A)
    _, nfe = odeint_dopri5(lambda s, z: z @ At.T, torch.ones(1, 2),
                           FixedGrid.over(0.0, 1.0, 2), atol=1e-7, rtol=1e-7,
                           max_steps_per_segment=3)
    assert nfe == 2 * 3 * 6
    with pytest.raises(ValueError, match="scalar-eps"):
        odeint_dopri5(lambda s, z: z, torch.ones(2, 2),
                      FixedGrid.over_batched(0.0, [1.0, 2.0], 2))


def test_dopri5_runs_without_autograd():
    w = torch.tensor(0.5, requires_grad=True)
    traj, _ = odeint_dopri5(lambda s, z: -w * z, torch.ones(3),
                            FixedGrid.over(0.0, 1.0, 2))
    assert not traj[1:].requires_grad
    np.testing.assert_allclose(traj[-1].numpy(), np.exp(-0.5), rtol=1e-5)
