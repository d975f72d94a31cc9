"""The port's fixed-grid solver API, hypersolvers, Neural ODE, trajectory
losses and offline HyperEuler training (``repro_torch/core/{solvers,
integrate,hypersolver,neural_ode,residual,train}.py`` and the LM's
``models/cdepth.py::cdepth_residual_loss``) held against the JAX package
on the CPU (mirrors ``tests/test_hypersolver.py``, ``tests/test_solvers.py``,
``tests/test_cdepth.py`` and ``tests/test_system.py``).

Tolerances, float32: 1e-6 for the update algebra on a dense toy field,
1e-5 for losses and their gradients (1e-4 through the reduced LM of
``cdepth_residual_loss``; the ``jax.grad`` side reduces in
another order), and for 3 iterations of ``train_hypersolver`` on the
MNIST-family node the losses to 1e-4 relative (1.8e-6 measured) and the
g params to 5e-5 absolute (1.6e-5 measured, on the first conv: AdamW
divides each gradient element by its own root mean square, so where a
gradient is near zero the two frameworks' rounding moves a step of up
to lr = 1e-2 by a visible fraction)."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import FixedGrid as JaxGrid
from repro.core import Integrator as JaxIntegrator
from repro.core import get_tableau as jax_tableau
from repro.core import residual as JR
from repro.core import solvers as JS
from repro.core.hypersolver import make as jax_make_solver
from repro.core.train import HypersolverTrainConfig as JaxCfg
from repro.core.train import train_hypersolver as jax_train
from repro.data import synthetic_images as jax_images
from repro.models import conv_node as J
from repro_torch.convert import nchw_from_nhwc, params_from_jax
from repro_torch.core import (EULER, RK4, FixedGrid, HyperSolver,
                              HypersolverTrainConfig, Integrator, NeuralODE,
                              as_integrator, depth_like, get_tableau,
                              local_error, make_solver, nfe_per_step,
                              odeint_fixed, train_hypersolver)
from repro_torch.core import residual as TR
from repro_torch.core.train import make_hypersolver
from repro_torch.models import conv_node as T
from repro_torch.optim import adamw, apply_updates

ALG = dict(rtol=1e-6, atol=1e-6)
LOSS = dict(rtol=1e-5, atol=1e-5)
B, D = 5, 6


def _carry(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _np(seed, *shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


# toy dense field and correction, the same math on both sides
def f_jax(s, z):
    return jnp.tanh(z) * jnp.cos(3.0 * s) - 0.5 * z


def f_torch(s, z):
    return torch.tanh(z) * torch.cos(torch.as_tensor(3.0 * s)) - 0.5 * z


GW = _np(0, 2 * D + 1, D, scale=0.3)


def g_jax_of(w):
    def g(eps, s, z, dz):
        s_col = jnp.broadcast_to(jnp.asarray(s, z.dtype), z[..., :1].shape)
        return jnp.tanh(jnp.concatenate([z, dz, s_col], -1) @ w)
    return g


def g_torch_of(w):
    def g(eps, s, z, dz):
        return torch.tanh(torch.cat([z, dz, depth_like(s, z)], -1) @ w)
    return g


Z0 = _np(1, B, D)


# ------------------------------------------------------------ solver API ----

@pytest.mark.parametrize("tab", ["euler", "midpoint", "rk4"])
def test_odeint_fixed_matches_reference(tab):
    traj_t = odeint_fixed(f_torch, torch.from_numpy(Z0),
                          FixedGrid.over(0.0, 1.0, 5), get_tableau(tab))
    traj_j = JS.odeint_fixed(f_jax, jnp.asarray(Z0), JaxGrid.over(0.0, 1.0, 5),
                             jax_tableau(tab))
    assert traj_t.shape == (6, B, D)
    np.testing.assert_allclose(traj_t.numpy(), np.asarray(traj_j), **ALG)
    zT = odeint_fixed(f_torch, torch.from_numpy(Z0),
                      FixedGrid.over(0.0, 1.0, 5), get_tableau(tab),
                      return_traj=False)
    assert torch.equal(zT, traj_t[-1])


@pytest.mark.parametrize("tab", ["euler", "heun", "rk4"])
def test_local_error_and_nfe_per_step_match_reference(tab):
    z1 = Z0 + 0.1 * _np(2, B, D)
    got = local_error(f_torch, get_tableau(tab), 0.25, 0.1,
                      torch.from_numpy(Z0), torch.from_numpy(z1))
    want = JS.local_error(f_jax, jax_tableau(tab), 0.25, 0.1, jnp.asarray(Z0),
                          jnp.asarray(z1))
    assert got.ndim == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert nfe_per_step(get_tableau(tab)) == JS.nfe_per_step(jax_tableau(tab))


def test_s_span_and_over_batched_match_reference():
    for K in (1, 3, 7, 10):
        np.testing.assert_array_equal(
            FixedGrid.over(0.0, 1.0, K).s_span.numpy(),
            np.asarray(JaxGrid.over(0.0, 1.0, K).s_span))
    s1 = [1.0, 0.5, 2.0]
    gt, gj = FixedGrid.over_batched(0.0, s1, 4), \
        JaxGrid.over_batched(0.0, np.asarray(s1, np.float32), 4)
    assert gt.eps.dtype == torch.float32 and gt.s_span.shape == (5, 3)
    np.testing.assert_allclose(gt.eps.numpy(), np.asarray(gj.eps), rtol=1e-7)
    np.testing.assert_allclose(gt.s_span.numpy(), np.asarray(gj.s_span),
                               rtol=1e-7)


def test_name_with_tableau_nfe_and_as_integrator():
    g = g_torch_of(torch.from_numpy(GW))
    ig, jg = Integrator(EULER, g=g), JaxIntegrator(jax_tableau("euler"),
                                                  g=g_jax_of(GW))
    assert ig.name == jg.name == "hyper_euler"
    assert Integrator(RK4).name == JaxIntegrator(jax_tableau("rk4")).name
    swapped = ig.with_tableau("midpoint")
    assert swapped.g is g and swapped.tableau == get_tableau("midpoint")
    assert swapped.name == jg.with_tableau("midpoint").name
    for K in (1, 4, 10):
        assert Integrator(RK4).nfe(K) == \
            JaxIntegrator(jax_tableau("rk4")).nfe(K)
    assert as_integrator(ig) is ig
    assert as_integrator("rk4", fused=True) == Integrator(RK4, fused=True)
    assert as_integrator(RK4) == Integrator(RK4)
    hs = make_solver("euler", g)
    assert isinstance(hs, HyperSolver) and as_integrator(hs) is hs
    duck = types.SimpleNamespace(tableau=EULER, g=g, fused=True)
    assert as_integrator(duck) == Integrator(EULER, g=g, fused=True)
    with pytest.raises(TypeError):
        as_integrator(3)


def test_checkpointed_solve_gives_same_values_and_grads():
    w = torch.from_numpy(GW).requires_grad_(True)
    integ = Integrator(RK4, g=g_torch_of(w))
    z0 = torch.from_numpy(Z0).requires_grad_(True)
    outs = []
    for ck in (False, True):
        zT = integ.solve(f_torch, z0, FixedGrid.over(0.0, 1.0, 4),
                         return_traj=False, checkpoint=ck)
        outs.append((zT.detach(), *torch.autograd.grad(zT.square().sum(),
                                                       (w, z0))))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_zero_g_hypersolver_equals_base_tableau():
    zero = lambda eps, s, z, dz: torch.zeros_like(z)
    for tab in ("euler", "midpoint", "rk4"):
        grid = FixedGrid.over(0.0, 1.0, 4)
        base = odeint_fixed(f_torch, torch.from_numpy(Z0), grid,
                            get_tableau(tab))
        hyper = make_solver(tab, zero).odeint(f_torch, torch.from_numpy(Z0),
                                              grid)
        torch.testing.assert_close(hyper, base, rtol=0, atol=0)


def test_hypersolver_odeint_matches_reference():
    grid_t, grid_j = FixedGrid.over(0.0, 1.0, 4), JaxGrid.over(0.0, 1.0, 4)
    got = make_solver("euler", g_torch_of(torch.from_numpy(GW))).odeint(
        f_torch, torch.from_numpy(Z0), grid_t)
    want = jax_make_solver("euler", g_jax_of(GW)).odeint(
        f_jax, jnp.asarray(Z0), grid_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ALG)


# ---------------------------------------------------------------- losses ----

def _traj():
    """A 'ground truth' trajectory: RK4 at K 16 read every 4th point."""
    fine = JS.odeint_fixed(f_jax, jnp.asarray(Z0), JaxGrid.over(0.0, 1.0, 16),
                           jax_tableau("rk4"))
    return np.array(fine)[::4]


def test_solver_residual_matches_reference():
    traj = _traj()
    for tab in ("euler", "midpoint"):
        rt, dzt = TR.solver_residual(f_torch, get_tableau(tab), 0.25, 0.25,
                                     torch.from_numpy(traj[1]),
                                     torch.from_numpy(traj[2]))
        rj, dzj = JR.solver_residual(f_jax, jax_tableau(tab), 0.25, 0.25,
                                     jnp.asarray(traj[1]),
                                     jnp.asarray(traj[2]))
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), **LOSS)
        np.testing.assert_allclose(dzt.numpy(), np.asarray(dzj), **ALG)


@pytest.mark.parametrize("loss", ["residual", "trajectory", "combined"])
def test_losses_and_grads_match_reference(loss):
    """Each loss and its gradient in g's params against ``jax.grad``; the
    residual loss takes one norm over the whole batch at each mesh step."""
    traj = _traj()
    grid_t, grid_j = FixedGrid.over(0.0, 1.0, 4), JaxGrid.over(0.0, 1.0, 4)
    t_fn = {"residual": TR.residual_fitting_loss,
            "trajectory": TR.trajectory_fitting_loss,
            "combined": lambda *a: TR.combined_loss(
                *a, residual_weight=0.7, trajectory_weight=0.3)}[loss]
    j_fn = {"residual": JR.residual_fitting_loss,
            "trajectory": JR.trajectory_fitting_loss,
            "combined": lambda *a: JR.combined_loss(
                *a, residual_weight=0.7, trajectory_weight=0.3)}[loss]

    def jax_loss(w):
        return j_fn(JaxIntegrator(jax_tableau("euler"), g=g_jax_of(w)), f_jax,
                    jnp.asarray(traj), grid_j)

    w = torch.from_numpy(GW).requires_grad_(True)
    got = t_fn(Integrator(EULER, g=g_torch_of(w)), f_torch,
               torch.from_numpy(traj), grid_t)
    (grad,) = torch.autograd.grad(got, (w,))
    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(GW))
    np.testing.assert_allclose(float(got.detach()), float(want), **LOSS)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), **LOSS)


def test_residual_loss_is_a_whole_batch_norm():
    """Per-row norms averaged would give another number: the reference's
    ``_tree_l2`` is one norm over the batch at each k."""
    traj = torch.from_numpy(_traj())
    integ = Integrator(EULER, g=g_torch_of(torch.from_numpy(GW)))
    grid = FixedGrid.over(0.0, 1.0, 4)
    loss = TR.residual_fitting_loss(integ, f_torch, traj, grid)
    want, rows = [], []
    for k in range(4):
        r, dz = TR.solver_residual(f_torch, EULER, 0.25 * k, 0.25, traj[k],
                                   traj[k + 1])
        d = r - integ.g(0.25, 0.25 * k, traj[k], dz)
        want.append(d.square().sum().sqrt())
        rows.append(d.square().sum(-1).sqrt().mean())
    torch.testing.assert_close(loss, torch.stack(want).mean())
    assert abs(float(loss) - float(torch.stack(rows).mean())) > 1e-3


def test_losses_need_a_correction():
    traj = torch.from_numpy(_traj())
    for fn in (TR.residual_fitting_loss, TR.trajectory_fitting_loss):
        with pytest.raises(ValueError, match="correction"):
            fn(Integrator(EULER), f_torch, traj, FixedGrid.over(0.0, 1.0, 4))


@pytest.mark.parametrize("K", [2, 4])
def test_cdepth_residual_loss_and_grad_match_reference(K):
    """The LM form of residual fitting (``models/cdepth.py``) on reduced
    qwen3_4b at 4 layers: the discrete trajectory, the loss and its
    gradient in g's params against ``jax.grad``."""
    from repro.configs import get as jax_cfg
    from repro.models import cdepth as jcd
    from repro.models.lm import init_lm
    from repro_torch.configs import get as torch_cfg
    from repro_torch.models import cdepth as tcd

    cfg_j = dataclasses.replace(jax_cfg("qwen3_4b").reduced(), n_layers=4)
    cfg_t = dataclasses.replace(torch_cfg("qwen3_4b").reduced(), n_layers=4)
    pj = init_lm(jax.random.PRNGKey(0), cfg_j)
    gj = jcd.lm_g_init(jax.random.PRNGKey(5), cfg_j, rank=8)
    gj = dict(gj, w_out=0.1 * jax.random.normal(jax.random.PRNGKey(6),
                                                gj["w_out"].shape))
    toks = np.random.RandomState(0).randint(0, cfg_j.vocab, (2, 8)).astype(
        np.int32)
    pt, gt = _carry(pj), _carry(gj)
    want_traj = jcd.discrete_depth_trajectory(pj, cfg_j, jnp.asarray(toks))
    np.testing.assert_allclose(
        tcd.discrete_depth_trajectory(pt, cfg_t, torch.from_numpy(toks))
        .numpy(), np.asarray(want_traj), rtol=1e-4, atol=1e-4)
    want, want_g = jax.value_and_grad(
        lambda g: jcd.cdepth_residual_loss(pj, g, cfg_j, jnp.asarray(toks),
                                           K))(gj)
    live = {k: v.requires_grad_(True) for k, v in gt.items()}
    got = tcd.cdepth_residual_loss(pt, live, cfg_t, torch.from_numpy(toks), K)
    grads = torch.autograd.grad(got, list(live.values()))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    for k, g in zip(live, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="multiple"):
        tcd.cdepth_residual_loss(pt, gt, cfg_t, torch.from_numpy(toks), 3)


# -------------------------------------------------------------- training ----

def test_train_hypersolver_matches_reference():
    """Three iterations on the MNIST-family node from the same carried
    params, g init (last conv given small random weights) and numpy
    batches, the batch swapped at iteration 2."""
    jnode, jp = J.mnist_node(jax.random.PRNGKey(0))
    gp = J.init_mnist_hyper(jax.random.PRNGKey(1))
    gp["c2"]["w"] = jnp.asarray(_np(3, *gp["c2"]["w"].shape, scale=0.02))
    xs, _ = jax_images("mnist28", 4, seed=4)
    batches = [np.asarray(xs[:2]), np.asarray(xs[2:])]
    kw = dict(base_solver="euler", K=4, iters=3, pretrain_iters=1,
              swap_every=2, lr=1e-2, lr_min=5e-4, weight_decay=1e-6,
              atol=1e-4, rtol=1e-4)
    gj, lj = jax_train(jnode, jp, J.mnist_g_apply, gp,
                       iter(jnp.asarray(b) for b in batches), JaxCfg(**kw))
    tnode = NeuralODE(T.mnist_f_apply, T.mnist_hx, T.mnist_hy)
    gt, lt = train_hypersolver(tnode, _carry(jp), T.mnist_g_apply, _carry(gp),
                               iter(nchw_from_nhwc(b) for b in batches),
                               HypersolverTrainConfig(**kw))
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(gj)[0],
                            jax.tree_util.tree_leaves(
                                jax.tree_util.tree_map(lambda l: l.numpy(),
                                                       gt))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=5e-5,
                                   err_msg=str(path))


def _two_moons(rs, n):
    t = rs.rand(n) * np.pi
    lab = (rs.rand(n) < 0.5).astype(np.int64)
    x = np.stack([np.cos(t) * (1 - 2 * lab) + lab,
                  np.sin(t) * (1 - 2 * lab) + 0.3 * lab], -1)
    return (x + 0.05 * rs.randn(*x.shape)).astype(np.float32), lab


def test_full_pipeline_in_the_port():
    """Paper Figs. 3-4 in microcosm, in the port alone at reduced
    iterations: train a toy Neural ODE (RK4 K 16), fit HyperEuler by
    residual fitting on dopri5 trajectories, and at K 4 on held-out data
    HyperEuler beats Euler against a tight dopri5 reference."""
    gen = torch.Generator().manual_seed(0)
    nz = 8
    params = {"w1": torch.randn(nz + 1, 32, generator=gen) * 0.4,
              "w2": torch.randn(32, nz, generator=gen) * 0.4,
              "hx": torch.randn(2, nz, generator=gen) * 0.7,
              "hy": torch.randn(nz, 2, generator=gen) * 0.7}

    def f_apply(p, s, x, z):
        return torch.tanh(torch.cat([z, depth_like(s, z)], -1) @ p["w1"]) \
            @ p["w2"]

    node = NeuralODE(f_apply=f_apply, hx_apply=lambda p, x: x @ p["hx"],
                     hy_apply=lambda p, z: z @ p["hy"])
    rs = np.random.RandomState(1)
    xs, ys = map(torch.from_numpy, _two_moons(rs, 256))
    opt = adamw(3e-3)
    st = opt.init(params)
    for i in range(60):
        with torch.enable_grad():
            live = {k: v.detach().requires_grad_(True)
                    for k, v in params.items()}
            loss = F.cross_entropy(node.forward_fixed(live, xs, RK4, 16), ys)
            grads = dict(zip(live, torch.autograd.grad(loss,
                                                       list(live.values()))))
        with torch.no_grad():
            upd, st = opt.update(grads, st, params, i)
            params = apply_updates(params, upd)
    gp = {"w1": torch.randn(2 * nz + 1, 32, generator=gen) * 0.05,
          "w2": torch.zeros(32, nz)}

    def g_apply(g, eps, s, x, z, dz):
        return torch.tanh(torch.cat([z, dz, depth_like(s, z)], -1)
                          @ g["w1"]) @ g["w2"]

    def batches():
        while True:
            yield torch.from_numpy(_two_moons(rs, 128)[0])

    cfg = HypersolverTrainConfig(base_solver="euler", K=4, iters=80,
                                 pretrain_iters=10, swap_every=10, lr=1e-2,
                                 lr_min=5e-4, atol=1e-5, rtol=1e-5)
    gp, losses = train_hypersolver(node, params, g_apply, gp, batches(), cfg)
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    xt = torch.from_numpy(_two_moons(np.random.RandomState(9), 512)[0])
    ref, _, _ = node.reference_trajectory(params, xt, 4, atol=1e-6, rtol=1e-6)
    f, z0 = node.field(params, xt), node.hx_apply(params, xt)
    grid = FixedGrid.over(0.0, 1.0, 4)
    err_e = (odeint_fixed(f, z0, grid, EULER, return_traj=False)
             - ref[-1]).abs().mean()
    err_h = (make_hypersolver("euler", g_apply, gp, xt).odeint(
        f, z0, grid, return_traj=False) - ref[-1]).abs().mean()
    assert err_h < err_e, (float(err_e), float(err_h))


def test_train_config_defaults_equal_reference():
    assert dataclasses.asdict(HypersolverTrainConfig()) == \
        dataclasses.asdict(JaxCfg())
