"""The trajectory-fitting tracker of ``chip_smoke.py::phase_tracking``
(the port's counterpart of ``benchmarks/bench_trajectory.py``, paper App.
C.1) held against the reference bench on the CPU: ``_beta``, the node's
field, two training steps, a short trajectory-fitting
``train_hypersolver`` run and the solver rows, on weights drawn by the
JAX side and carried across and inputs from numpy ``RandomState``.
Tolerance 1e-4 (float32) throughout, NFE exact."""
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
from repro.core.train import HypersolverTrainConfig as JaxCfg
from repro.core.train import make_integrator as jax_make_integrator
from repro.core.train import train_hypersolver as jax_train
from repro.nn.module import mlp_init as jax_mlp_init
from repro.optim import adamw as jax_adamw
from repro.optim import apply_updates as jax_apply
from repro.optim import clip_by_global_norm as jax_clip
from repro_torch.convert import params_from_jax
from repro_torch.core import train_hypersolver

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from benchmarks import bench_trajectory as B  # noqa: E402

TOL = dict(rtol=0, atol=1e-4)


def _carry(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _z0(seed, n):
    rs = np.random.RandomState(seed)
    return (np.array([0.0, 1.0], np.float32)
            + 0.05 * rs.randn(n, 2)).astype(np.float32)


@pytest.fixture(scope="module")
def tracker():
    """The bench's node params and its g (the zeroed last layer given
    small random weights, so HyperEuler is not Euler)."""
    fp = jax_mlp_init(jax.random.PRNGKey(0), (3, 64, 64, 2))
    gp = jax_mlp_init(jax.random.PRNGKey(5), (5, 64, 64, 64, 2),
                      final_zero=True)
    last = gp["layers"][-1]["kernel"]
    gp["layers"][-1]["kernel"] = jnp.asarray(
        0.05 * np.random.RandomState(1).randn(*last.shape), jnp.float32)
    return fp, gp


def test_beta_and_field_match_bench(tracker):
    fp, _ = tracker
    s = np.linspace(0, 1, 17).astype(np.float32)
    np.testing.assert_allclose(chip_smoke.beta(torch.from_numpy(s)).numpy(),
                               np.asarray(B._beta(jnp.asarray(s))), **TOL)
    z = _z0(2, 12)
    f_j = B._make_node().field(fp, None)
    f_t = chip_smoke.tracker_node().field(_carry(fp), None)
    for si in (0.0, 0.37, 1.0):
        np.testing.assert_allclose(
            f_t(torch.tensor(si), torch.from_numpy(z)).numpy(),
            np.asarray(f_j(si, jnp.asarray(z))), **TOL)
    dz = f_t(torch.tensor(0.5), torch.from_numpy(z))
    np.testing.assert_allclose(
        chip_smoke.tracker_g_apply(_carry(tracker[1]), 0.1, torch.tensor(0.5),
                                   None, torch.from_numpy(z), dz).numpy(),
        np.asarray(B._g_apply(tracker[1], 0.1, 0.5, None, jnp.asarray(z),
                              jnp.asarray(dz.numpy()))), **TOL)


def test_train_steps_match_bench(tracker):
    """Two steps of ``phase_tracking``'s train step against the bench's
    ``train_tracker`` step body on the same initial points."""
    jp, _ = tracker
    node = B._make_node()
    opt = jax_adamw(3e-3)
    st_j = opt.init(jp)
    K = 32
    s_knots = JaxGrid.over(0, 1, K).s_span

    def loss_fn(p, z0):
        traj = jax_make_integrator("rk4").solve(node.field(p, None), z0,
                                                JaxGrid.over(0, 1, K))
        return jnp.mean((traj - B._beta(s_knots)[:, None, :]) ** 2)

    step_t, opt_t = chip_smoke.tracker_train_step(chip_smoke.tracker_node())
    tp = _carry(jp)
    st_t = opt_t.init(tp)
    for i in range(2):
        z0 = _z0(10 + i, 8)
        l_j, g = jax.value_and_grad(loss_fn)(jp, jnp.asarray(z0))
        g, _ = jax_clip(g, 1.0)
        u, st_j = opt.update(g, st_j, jp, i)
        jp = jax_apply(jp, u)
        tp, st_t, l_t = step_t(tp, st_t, i, torch.from_numpy(z0))
        np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-4)
        for a, b in zip(jax.tree_util.tree_leaves(jp),
                        pytree.tree_leaves(tp)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_trajectory_fitting_run_matches_bench(tracker):
    """Four iterations of the bench's trajectory fit (``train_hypersolver``
    with ``fit_tracker_hypersolver``'s config at K 8), the batch swapped
    at iteration 2, from the bench's zeroed g."""
    fp, _ = tracker
    gp = jax_mlp_init(jax.random.PRNGKey(5), (5, 64, 64, 64, 2),
                      final_zero=True)
    cfg_t = chip_smoke.tracker_fit_config(iters=4, K=8)
    cfg_t.pretrain_iters, cfg_t.swap_every = 1, 2
    cfg_j = JaxCfg(**{k: getattr(cfg_t, k) for k in (
        "base_solver", "K", "iters", "pretrain_iters", "swap_every", "lr",
        "lr_min", "weight_decay", "grad_clip", "atol", "rtol",
        "residual_weight", "trajectory_weight")})
    assert (cfg_j.residual_weight, cfg_j.trajectory_weight) == (0.0, 1.0)
    batches = [_z0(20, 16), _z0(21, 16), _z0(22, 16)]
    gj, lj = jax_train(B._make_node(), fp, B._g_apply, gp,
                       iter(jnp.asarray(b) for b in batches), cfg_j)
    gt, lt = train_hypersolver(chip_smoke.tracker_node(), _carry(fp),
                               chip_smoke.tracker_g_apply, _carry(gp),
                               iter(torch.from_numpy(b) for b in batches),
                               cfg_t)
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    assert lt[-1] < lt[0]
    for a, b in zip(jax.tree_util.tree_leaves(gj), pytree.tree_leaves(gt)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("K", [4])
def test_rows_match_bench(tracker, K):
    """``tracker_rows`` at K 4 against the bench's ``main`` loop body on
    the same params, g and initial points, with the reference's dopri5
    (1e-8) endpoint as the target of both, and the port's own dopri5
    endpoint within 1e-4 of it."""
    fp, gp = tracker
    z0 = _z0(9, 64)
    node = B._make_node()
    ref, _, nfe_j = node.reference_trajectory(fp, jnp.asarray(z0), K=16,
                                              atol=1e-8, rtol=1e-8)
    tnode = chip_smoke.tracker_node()
    ref_t, _, nfe_t = tnode.reference_trajectory(
        _carry(fp), torch.from_numpy(z0), K=16, atol=1e-8, rtol=1e-8)
    assert nfe_t == int(nfe_j)
    np.testing.assert_allclose(ref_t[-1].numpy(), np.asarray(ref[-1]), **TOL)
    z_ref = np.asarray(ref[-1])
    rows = chip_smoke.tracker_rows(tnode, _carry(fp), _carry(gp),
                                   torch.from_numpy(z0),
                                   torch.from_numpy(z_ref), Ks=(K,))
    f = node.field(fp, jnp.asarray(z0))
    for row in rows:
        name = row["solver"]
        integ = (jax_make_integrator("euler", B._g_apply, gp, jnp.asarray(z0))
                 if name == "hyper_euler" else jax_make_integrator(name))
        zT = integ.solve(f, jnp.asarray(z0), JaxGrid.over(0.0, 1.0, K),
                         return_traj=False)
        err = float(jnp.mean(jnp.linalg.norm(zT - z_ref, axis=-1)))
        assert row["K"] == K and row["nfe"] == integ.nfe(K)
        np.testing.assert_allclose(row["global_err"], err, **TOL)
        if name == "hyper_euler":
            np.testing.assert_allclose(row["global_err_fused"], err, **TOL)
            assert row["fused_diff"] <= 1e-5 * row["max_abs_z"]
    assert [r["solver"] for r in rows] == list(chip_smoke.TRACK_SOLVERS)
