"""The port's CNF slice (``repro_torch/nn/cnf.py``, ``nn/module.py``'s MLP,
``data/synthetic.py``'s 2-D densities and ``chip_smoke.py::phase_cnf``'s
step bodies) held against the JAX package on the CPU, at small widths.

Inputs come from numpy ``RandomState``; weights are drawn by the JAX side
and carried across (``convert.py::params_from_jax``). Tolerances, float32:
the densities and ``mlp_init``'s shapes and zeroed last layer bit for bit;
``mlp_apply``, the field, its exact trace, the reversed field, the base
log-density and every 2-NFE sample (fused on the CPU takes the kernel's
plain version) within 1e-5; ``cnf_log_prob`` through RK4 at K 8 and the
NLL's gradient within 1e-4 (relative); three AdamW steps of the bench's
train and fit step bodies within 1e-4; the lock-step dopri5 on the
``(z, logp)`` tuple with the reference's NFE exactly and endpoints within
1e-5."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from port_isolation import port_module_isolation  # noqa: F401
from repro.core import FixedGrid as JaxGrid
from repro.core import Integrator as JaxIntegrator
from repro.core import get_tableau as jax_tableau
from repro.core import odeint_dopri5 as jax_dopri5
from repro.core.residual import residual_fitting_loss as jax_residual_loss
from repro.data import DENSITIES as JAX_DENSITIES
from repro.data import density_sampler as jax_sampler
from repro.nn import cnf as J
from repro.nn.module import mlp_apply as jax_mlp_apply
from repro.nn.module import mlp_init as jax_mlp_init
from repro.optim import adamw as jax_adamw
from repro.optim import apply_updates as jax_apply
from repro.optim import clip_by_global_norm as jax_clip
from repro_torch.convert import params_from_jax
from repro_torch.core import FixedGrid, Integrator, get_tableau, odeint_dopri5
from repro_torch.data import DENSITIES, density_sampler
from repro_torch.nn import cnf as T
from repro_torch.nn.module import mlp_apply, mlp_init

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from benchmarks.bench_cnf import _g_apply, _g_init, _hist_l1  # noqa: E402

HIDDEN = (16, 16)
TOL = dict(rtol=0, atol=1e-5)


def _carry(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _np(tree):
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(tree)]


def _tnp(tree):
    return [l.detach().numpy() for l in pytree.tree_leaves(tree)]


def _points(seed, n=32, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(n, 2)).astype(np.float32)


@pytest.fixture(scope="module")
def cnf():
    jp = J.cnf_mlp_init(jax.random.PRNGKey(0), hidden=HIDDEN)
    return jp, _carry(jp)


@pytest.fixture(scope="module")
def g():
    """The bench's g with its zeroed last layer given small random
    weights, so HyperHeun is not Heun."""
    gp = _g_init(jax.random.PRNGKey(3))
    last = gp["layers"][-1]["kernel"]
    gp["layers"][-1]["kernel"] = jnp.asarray(
        0.1 * np.random.RandomState(4).randn(*last.shape), jnp.float32)
    return gp, _carry(gp)


# ------------------------------------------------------------ densities ----

@pytest.mark.parametrize("name", sorted(JAX_DENSITIES))
@pytest.mark.parametrize("seed,batch", [(0, 7), (3, 512)])
def test_density_points_equal_reference(name, seed, batch):
    assert sorted(DENSITIES) == sorted(JAX_DENSITIES)
    js, ts = jax_sampler(name, batch, seed), density_sampler(
        name, batch, seed, device="cpu")
    for _ in range(2):
        a, b = np.asarray(next(js)), next(ts)
        assert b.dtype == torch.float32 and b.shape == (batch, 2)
        np.testing.assert_array_equal(b.numpy(), a)


def test_densities_shapes_and_spread():
    """Mirrors ``tests/test_data.py::test_densities_shapes_and_spread``."""
    for name in DENSITIES:
        x = next(density_sampler(name, 512, seed=3, device="cpu"))
        assert x.shape == (512, 2)
        assert bool(torch.isfinite(x).all())
        assert float(torch.std(x)) > 0.3, name


def test_density_sampler_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        next(density_sampler("rings", 4))


# ------------------------------------------------------------------ MLP ----

@pytest.mark.parametrize("final_zero", [False, True])
def test_mlp_init_shapes_and_final_zero(final_zero):
    dims = (5, 16, 8, 3)
    jp = jax_mlp_init(jax.random.PRNGKey(1), dims, final_zero=final_zero)
    tp = mlp_init(torch.Generator().manual_seed(1), dims,
                  final_zero=final_zero)
    assert list(tp) == ["layers"] and len(tp["layers"]) == len(dims) - 1
    for a, b in zip(jp["layers"], tp["layers"]):
        assert list(b) == ["kernel"]
        assert b["kernel"].shape == a["kernel"].shape
        assert b["kernel"].dtype == torch.float32
    last = tp["layers"][-1]["kernel"]
    assert bool((last == 0).all()) == final_zero
    np.testing.assert_array_equal(last.numpy() == 0,
                                  np.asarray(jp["layers"][-1]["kernel"]) == 0)
    # truncated-normal draws at fan-in scale
    k0 = tp["layers"][0]["kernel"]
    assert float(k0.abs().max()) <= 2.0 * dims[0] ** -0.5 + 1e-6
    # a carried tree keeps its structure
    carried = _carry(jp)
    assert pytree.tree_structure(carried) == pytree.tree_structure(tp)


def test_mlp_apply_matches_reference():
    jp = jax_mlp_init(jax.random.PRNGKey(2), (4, 16, 16, 3))
    x = _points(5, 9).repeat(2, axis=1)
    for act_j, act_t in ((jnp.tanh, torch.tanh),
                         (jax.nn.relu, torch.relu)):
        np.testing.assert_allclose(
            mlp_apply(_carry(jp), torch.from_numpy(x), act=act_t).numpy(),
            np.asarray(jax_mlp_apply(jp, jnp.asarray(x), act=act_j)), **TOL)


# ------------------------------------------------------------ the field ----

def test_cnf_mlp_init_is_the_paper_net():
    p = T.cnf_mlp_init(torch.Generator().manual_seed(0))
    assert [tuple(l["kernel"].shape) for l in p["layers"]] == \
        [(3, 128), (128, 128), (128, 128), (128, 2)]


@pytest.mark.parametrize("s", [0.0, 0.3, 1.0])
def test_field_trace_and_reversal_match_reference(cnf, s):
    jp, tp = cnf
    z = _points(1)
    state_j = (jnp.asarray(z), jnp.zeros(z.shape[0]))
    state_t = (torch.from_numpy(z), torch.zeros(z.shape[0]))
    s_t = torch.tensor(s)
    np.testing.assert_allclose(T.cnf_field(tp)(s_t, state_t[0]).numpy(),
                               np.asarray(J.cnf_field(jp)(s, state_j[0])),
                               **TOL)
    for jf, tf in ((J.exact_trace_dynamics(jp), T.exact_trace_dynamics(tp)),
                   (J.reversed_field(J.exact_trace_dynamics(jp)),
                    T.reversed_field(T.exact_trace_dynamics(tp)))):
        for a, b in zip(jf(s, state_j), tf(s_t, state_t)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    np.testing.assert_allclose(T.base_log_prob(state_t[0]).numpy(),
                               np.asarray(J.base_log_prob(state_j[0])), **TOL)


def test_field_refuses_a_per_sample_depth_as_the_reference(cnf):
    """The reference broadcasts s to ``z[..., :1]``, so a per-sample (B,)
    depth raises there (its CNF goes through no multi-rate solve); the
    port's field refuses the same input, and takes what the reference
    takes: a Python scalar, a 0-d depth and one depth a row, (B, 1)."""
    jp, tp = cnf
    z = _points(2, n=4)
    rows = np.array([0.0, 0.25, 0.5, 0.75], np.float32)
    with pytest.raises((ValueError, TypeError)):
        J.cnf_field(jp)(jnp.asarray(rows), jnp.asarray(z))
    with pytest.raises(RuntimeError, match="expanded size"):
        T.cnf_field(tp)(torch.from_numpy(rows), torch.from_numpy(z))
    for s_j, s_t in ((0.5, 0.5), (jnp.asarray(0.5), torch.tensor(0.5)),
                     (jnp.asarray(rows[:, None]),
                      torch.from_numpy(rows[:, None]))):
        np.testing.assert_allclose(
            T.cnf_field(tp)(s_t, torch.from_numpy(z)).numpy(),
            np.asarray(J.cnf_field(jp)(s_j, jnp.asarray(z))), **TOL)


def test_exact_trace_is_the_jacobian_diagonal(cnf):
    _, tp = cnf
    z = torch.from_numpy(_points(2, 5))
    f = T.cnf_field(tp)
    s = torch.tensor(0.4)
    jac = torch.stack([torch.autograd.functional.jacobian(
        lambda zz: f(s, zz[None])[0], zi) for zi in z])
    _, neg_tr = T.exact_trace_dynamics(tp)(s, (z, torch.zeros(5)))
    np.testing.assert_allclose(-neg_tr.numpy(),
                               torch.diagonal(jac, dim1=1, dim2=2).sum(-1)
                               .numpy(), rtol=0, atol=1e-5)


def test_hutchinson_over_reference_probes_equals_reference(cnf):
    """The reference draws its probes from ``fold_in(fold_in(key, 0), i)``
    at every evaluation; fed those probes, the port's estimator gives the
    reference's value, and the port's dynamics reuse their own probes."""
    jp, tp = cnf
    z = _points(3, 16)
    key, n = jax.random.PRNGKey(11), 3
    ks = jax.random.fold_in(key, 0)
    probes = np.stack([np.asarray(jax.random.rademacher(
        jax.random.fold_in(ks, i), z.shape, dtype=jnp.float32))
        for i in range(n)])
    _, want = J.hutchinson_dynamics(jp, key, n)(
        0.25, (jnp.asarray(z), jnp.zeros(16)))
    got = T.rademacher_trace(T.cnf_field(tp), torch.tensor(0.25),
                             torch.from_numpy(z), torch.from_numpy(probes))
    np.testing.assert_allclose(-got.numpy(), np.asarray(want), **TOL)
    aug = T.hutchinson_dynamics(tp, torch.Generator().manual_seed(0), n)
    state = (torch.from_numpy(z), torch.zeros(16))
    a, b = aug(torch.tensor(0.25), state), aug(torch.tensor(0.25), state)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])
    # with many probes the estimate approaches the exact trace
    aug = T.hutchinson_dynamics(tp, torch.Generator().manual_seed(1), 400)
    _, exact = T.exact_trace_dynamics(tp)(torch.tensor(0.25), state)
    assert float((aug(torch.tensor(0.25), state)[1] - exact).abs().mean()) \
        < 0.1 * float(exact.abs().mean()) + 1e-3


# ------------------------------------------------------------- sampling ----

def _jax_integrator(name, gp=None, fused=False):
    g = None if gp is None else \
        (lambda e, s, z, dz: _g_apply(gp, e, s, None, z, dz))
    return JaxIntegrator(tableau=jax_tableau(name), g=g, fused=fused)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name,K,hyper", [("heun", 1, False),
                                          ("euler", 2, False),
                                          ("rk4", 3, False),
                                          ("heun", 1, True)])
def test_cnf_sample_matches_reference(cnf, g, name, K, hyper, fused):
    jp, tp = cnf
    z0 = _points(6, 64)
    integ_j = _jax_integrator(name, g[0] if hyper else None, fused)
    integ_t = (chip_smoke.hyper_heun(g[1], fused) if hyper
               else Integrator(get_tableau(name), fused=fused))
    want = J.cnf_sample(jp, jnp.asarray(z0), K=K, solver=integ_j,
                        return_traj=True)
    got = T.cnf_sample(tp, torch.from_numpy(z0), K=K, solver=integ_t,
                       return_traj=True)
    assert got[0].shape == (K + 1, 64, 2) and got[1].shape == (K + 1, 64)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_g_apply_matches_bench(g):
    gj, gt = g
    rs = np.random.RandomState(8)
    z, dz = rs.randn(2, 10, 2).astype(np.float32)
    logp, dlogp = rs.randn(2, 10).astype(np.float32)
    want = _g_apply(gj, 0.5, 0.5, None, (jnp.asarray(z), jnp.asarray(logp)),
                    (jnp.asarray(dz), jnp.asarray(dlogp)))
    got = chip_smoke.cnf_g_apply(
        gt, 0.5, torch.tensor(0.5), None,
        (torch.from_numpy(z), torch.from_numpy(logp)),
        (torch.from_numpy(dz), torch.from_numpy(dlogp)))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    fresh = chip_smoke.cnf_g_init(torch.Generator().manual_seed(0))
    assert [tuple(l["kernel"].shape) for l in fresh["layers"]] == \
        [tuple(l["kernel"].shape) for l in _g_init(jax.random.PRNGKey(0))[
            "layers"]]
    assert not bool(fresh["layers"][-1]["kernel"].any())


def test_hist_l1_equals_bench():
    a, b = _points(9, 300, 2.0), _points(10, 200, 1.5)
    assert chip_smoke.hist_l1(a, b) == _hist_l1(a, b)


# --------------------------------------------------------------- density ----

def test_cnf_log_prob_and_nll_gradient_match_reference(cnf):
    jp, tp = cnf
    x = _points(12, 48, 1.5)
    np.testing.assert_allclose(
        T.cnf_log_prob(tp, torch.from_numpy(x)).numpy(),
        np.asarray(J.cnf_log_prob(jp, jnp.asarray(x), K=8, solver="rk4")),
        rtol=1e-4, atol=1e-4)
    gj = jax.grad(lambda p: -jnp.mean(J.cnf_log_prob(p, jnp.asarray(x))))(jp)
    leaves, spec = pytree.tree_flatten(tp)
    live = [l.clone().requires_grad_(True) for l in leaves]
    loss = chip_smoke.cnf_nll(pytree.tree_unflatten(live, spec),
                              torch.from_numpy(x))
    gt = torch.autograd.grad(loss, live)
    for a, b in zip(_np(gj), gt):
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-4 * np.abs(a).max())


def _stiffer(jp, by=2.5):
    """Carried CNF params with every kernel scaled up, so that dopri5
    rejects and grows steps (not one step a segment): 84 NFE over two
    segments. (At 3x the logp leaf reaches ~9, and float32 rounding of
    the two packages' matmuls, amplified over 23 steps of a field that
    steep, reaches ~2e-5 at the same step sequence.)"""
    jp = jax.tree_util.tree_map(lambda l: l * by, jp)
    return jp, _carry(jp)


def test_dopri5_on_the_cnf_tuple_matches_reference(cnf):
    jp, tp = _stiffer(cnf[0])
    z0 = _points(13, 64)
    want, nfe_j = jax_dopri5(J.exact_trace_dynamics(jp),
                             (jnp.asarray(z0), jnp.zeros(64)),
                             JaxGrid.over(0.0, 1.0, 2), atol=1e-5, rtol=1e-5)
    got, nfe_t = odeint_dopri5(T.exact_trace_dynamics(tp),
                               chip_smoke.cnf_state0(torch.from_numpy(z0)),
                               FixedGrid.over(0.0, 1.0, 2), atol=1e-5,
                               rtol=1e-5)
    assert nfe_t == int(nfe_j) and nfe_t > 12
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


# --------------------------------------------------------- training loops ----

def test_train_steps_match_reference(cnf):
    """Three steps of ``phase_cnf``'s train step against the bench's
    ``train_cnf`` step body on the same batches."""
    jp, tp = cnf
    opt = jax_adamw(1e-3)
    st_j = opt.init(jp)

    def nll(p, x):
        return -jnp.mean(J.cnf_log_prob(p, x, K=8, solver="rk4"))

    step_t, opt_t = chip_smoke.cnf_train_step()
    st_t = opt_t.init(tp)
    for i in range(3):
        x = _points(20 + i, 32, 1.5)
        l_j, grads = jax.value_and_grad(nll)(jp, jnp.asarray(x))
        grads, _ = jax_clip(grads, 10.0)
        u, st_j = opt.update(grads, st_j, jp, i)
        jp = jax_apply(jp, u)
        tp, st_t, l_t = step_t(tp, st_t, i, torch.from_numpy(x))
        np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-4)
        for a, b in zip(_np(jp), _tnp(tp)):
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=1e-4 * np.abs(a).max())


def test_fit_steps_match_reference(cnf, g):
    """Three steps of ``phase_cnf``'s HyperHeun fit step against the
    bench's ``fit_hyperheun`` step body, on the reference's dopri5
    trajectory carried across."""
    jp, tp = cnf
    gj, gt = g
    aug_j = J.exact_trace_dynamics(jp)
    grid = JaxGrid.over(0.0, 1.0, 1)
    traj_j, _ = jax_dopri5(aug_j, (jnp.asarray(_points(30, 64)),
                                   jnp.zeros(64)), grid, atol=1e-5, rtol=1e-5)
    opt = jax_adamw(5e-3, weight_decay=1e-6)
    st_j = opt.init(gj)

    def loss_fn(gp, traj):
        integ = _jax_integrator("heun", gp)
        return jax_residual_loss(integ, aug_j, traj, grid)

    step_t, opt_t = chip_smoke.cnf_fit_step(T.exact_trace_dynamics(tp), K=1)
    st_t = opt_t.init(gt)
    traj_t = _carry(traj_j)
    for i in range(3):
        l_j, grads = jax.value_and_grad(loss_fn)(gj, traj_j)
        grads, _ = jax_clip(grads, 10.0)
        u, st_j = opt.update(grads, st_j, gj, i)
        gj = jax_apply(gj, u)
        gt, st_t, l_t = step_t(gt, st_t, i, traj_t)
        np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-4)
        for a, b in zip(_np(gj), _tnp(gt)):
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=1e-4 * np.abs(a).max())
