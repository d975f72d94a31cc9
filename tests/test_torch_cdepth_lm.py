"""The LM hypersolver fit of ``benchmarks/bench_cdepth_lm.py`` on the port
(``chip_smoke.py``'s ``train_cdepth_lm``, ``fit_cdepth_g``,
``cdepth_lm_rows``, ``check_cdepth_lm`` and ``serve_saved_g``), the
port's ``data/synthetic.py::token_batches``, ``models/lm.py::lm_loss`` in
training, and the continuous-depth cases of tests/test_cdepth.py, held
against the JAX package on the CPU.

The bench's model (reduced ``qwen3_4b`` at 8 layers, float32) and, where
the case is the model's and not the bench's, reduced ``olmoe_1b_7b``
(top-2 of 4 experts). Weights and corrections are drawn by the JAX
package and carried across with ``convert.params_from_jax``; tokens come
from both packages' ``token_batches`` (equal for a seed, asserted) or
numpy. The first steps of training and of a K's fit are held to the
reference's loop, losses at rtol 1e-5 and parameters at rtol 1e-4, atol
3e-5 (AdamW's first steps move a parameter by about lr = 1e-3 or 3e-3;
one whose gradient is near AdamW's eps moves by a share of lr that the
gradient's last bits set, readings up to 1.3e-5); logits through a
model at 1e-4."""
import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_isolation import port_module_isolation  # noqa: F401
from repro.configs import get as jax_get
from repro.data import token_batches as jax_token_batches
from repro.models import cdepth as jcd
from repro.models import lm as jlm
from repro.optim import adamw as jax_adamw
from repro.optim import apply_updates as jax_apply
from repro.optim import clip_by_global_norm as jax_clip
from repro_torch.configs import get as torch_get
from repro_torch.convert import params_from_jax
from repro_torch.core.train import make_fit_step
from repro_torch.data import token_batches
from repro_torch.models import cdepth as tcd
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from benchmarks import bench_cdepth_lm as bench  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _carry(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


def _close_tree(t_tree, j_tree, **tol):
    flat = jax.tree_util.tree_flatten_with_path(j_tree)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(t_tree))
    for path, leaf in flat:
        node = t_tree
        for k in path:
            node = node[k.key]
        _close(node, leaf, **tol)


@functools.lru_cache(maxsize=None)
def _bench_params():
    """The bench model's reference weights, drawn once per file."""
    return jlm.init_lm(jax.random.PRNGKey(0), bench._cfg())


def _bench_model():
    cfg_j = bench._cfg()
    assert dataclasses.asdict(cs.cdepth_lm_cfg()) == dataclasses.asdict(cfg_j)
    return cfg_j, _bench_params()


def _jax_g(cfg_j, seed=2, readout=0.0):
    gp = jcd.lm_g_init(jax.random.PRNGKey(seed), cfg_j, rank=32,
                       param_dtype=jnp.float32)
    if readout:
        gp = dict(gp, w_out=readout * jax.random.normal(
            jax.random.PRNGKey(seed + 1), gp["w_out"].shape))
    return gp


@pytest.mark.parametrize("vocab,batch,seq_len,seed",
                         [(256, 8, 64, 3), (256, 4, 32, 11),
                          (256, 4, 32, 13), (100, 2, 5, 0)])
def test_token_batches_equal_reference(vocab, batch, seq_len, seed):
    """The bench's streams (training seed 3, rows 11, fit 13) and a
    smaller alphabet: the port's batches are the reference's, int32."""
    jit = jax_token_batches(vocab, batch, seq_len, seed=seed)
    tit = token_batches(vocab, batch, seq_len, seed=seed, device="cpu")
    for _ in range(3):
        (xj, yj), (xt, yt) = next(jit), next(tit)
        assert xt.dtype == yt.dtype == torch.int32
        assert xt.shape == (batch, seq_len)
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        np.testing.assert_array_equal(xt[:, 1:].numpy(), yt[:, :-1].numpy())


def _jax_train(cfg_j, pj, steps):
    """bench_cdepth_lm.train_small_lm's loop, ``steps`` of it."""
    opt = jax_adamw(1e-3)
    st = opt.init(pj)

    @jax.jit
    def step(p, st, i, toks, tgts):
        (l, _), g = jax.value_and_grad(
            lambda pp: jlm.lm_loss(pp, cfg_j, toks, tgts), has_aux=True)(p)
        g, _ = jax_clip(g, 1.0)
        u, st = opt.update(g, st, p, i)
        return jax_apply(p, u), st, l

    it = jax_token_batches(cfg_j.vocab, 8, 64, seed=3)
    losses = []
    for i in range(steps):
        toks, tgts = next(it)
        pj, st, l = step(pj, st, i, toks, tgts)
        losses.append(float(l))
    return pj, losses


def test_bench_training_first_steps_match_jax():
    """Three steps of the bench's ``lm_loss`` training (AdamW 1e-3, clip
    1.0, the seed-3 stream) from the same weights: losses and every
    parameter after them."""
    cfg_j, pj = _bench_model()
    pj3, lj = _jax_train(cfg_j, pj, 3)
    pt3, lt = cs.train_cdepth_lm(_carry(pj), 3)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    _close_tree(pt3, pj3, rtol=1e-4, atol=3e-5)


def _jax_fit(cfg_j, pj, gj, K, iters):
    """bench_cdepth_lm.main's fit at K, ``iters`` of it."""
    opt = jax_adamw(3e-3)
    st = opt.init(gj)

    @jax.jit
    def fit(gp, st, i, batch):
        l, g = jax.value_and_grad(
            lambda gg: jcd.cdepth_residual_loss(pj, gg, cfg_j, batch, K))(gp)
        g, _ = jax_clip(g, 1.0)
        u, st = opt.update(g, st, gp, i)
        return jax_apply(gp, u), st, l

    it = jax_token_batches(cfg_j.vocab, 4, 32, seed=13)
    batch, _ = next(it)
    losses = []
    for i in range(iters):
        if i % 10 == 0:
            batch, _ = next(it)
        gj, st, l = fit(gj, st, i, batch)
        losses.append(float(l))
    return gj, losses


@pytest.mark.parametrize("K", [1, 2, 4])
def test_bench_fit_first_steps_match_jax(K):
    """Three iterations of the bench's fit at K (AdamW 3e-3, clip 1.0,
    ``cdepth_residual_loss`` on the seed-13 stream) from the same model
    and zero-readout g: losses and g after them. (At K 8 Euler is exact:
    the residual is rounding, which no two frameworks share.)"""
    cfg_j, pj = _bench_model()
    gj = _jax_g(cfg_j)
    gj3, lj = _jax_fit(cfg_j, pj, gj, K, 3)
    gt3, lt = cs.fit_cdepth_g(_carry(pj), _carry(gj), K, 3)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    _close_tree(gt3, gj3, rtol=1e-4, atol=3e-5)


def test_cdepth_lm_rows_match_jax():
    """The bench's rows (argmax agreement, logit MAE, KL against full
    depth) for euler and hyper_euler at K 1, 2, 4, 8 with nonzero g's,
    on the seed-11 stream's first batch."""
    cfg_j, pj = _bench_model()
    pt = _carry(pj)
    toks, _ = next(jax_token_batches(cfg_j.vocab, 4, 32, seed=11))
    full, _ = jlm.lm_forward(pj, cfg_j, toks)
    lp_full = jax.nn.log_softmax(full, -1)
    gjs = {K: _jax_g(cfg_j, seed=K, readout=0.3) for K in (1, 2, 4, 8)}
    rows = cs.cdepth_lm_rows(pt, {K: _carry(g) for K, g in gjs.items()},
                             torch.from_numpy(np.array(toks)))
    assert [(r["solver"], r["K"]) for r in rows] == [
        (s, K) for K in (1, 2, 4, 8) for s in ("euler", "hyper_euler")]
    for r in rows:
        g = gjs[r["K"]] if r["solver"] == "hyper_euler" else None
        out = jcd.lm_forward_cdepth(pj, cfg_j, toks, K=r["K"],
                                    solver="euler", g_params=g)
        lp = jax.nn.log_softmax(out, -1)
        assert r["full_depth_groups"] == 8
        assert r["nfe_fraction"] == r["K"] / 8
        assert r["argmax_agreement"] == float(
            jnp.mean(jnp.argmax(full, -1) == jnp.argmax(out, -1)))
        np.testing.assert_allclose(
            r["logit_mae"], float(jnp.mean(jnp.abs(full - out))), rtol=1e-4,
            atol=1e-5)
        np.testing.assert_allclose(
            r["kl_vs_full_depth"],
            float(jnp.mean(jnp.sum(jnp.exp(lp_full) * (lp_full - lp), -1))),
            rtol=1e-3, atol=1e-6)


def _rows(kl_euler, kl_hyper, K=1):
    base = dict(bench="cdepth_lm", K=K, full_depth_groups=8)
    return [dict(base, solver="euler", kl_vs_full_depth=kl_euler),
            dict(base, solver="hyper_euler", kl_vs_full_depth=kl_hyper)]


def test_check_cdepth_lm_holds_the_bench_claims():
    """Raises when hyper_euler's KL is not below euler's short of full
    depth, or when a loss does not fall; full depth is exempt."""
    falling = list(np.linspace(2.0, 1.0, 20))
    cs.check_cdepth_lm(falling, {1: falling, 8: falling[::-1]},
                       _rows(2.0, 1.0) + _rows(0.0, 1e-8, K=8))
    with pytest.raises(AssertionError, match="K=1: hyper_euler KL"):
        cs.check_cdepth_lm(falling, {1: falling}, _rows(1.0, 1.0))
    with pytest.raises(AssertionError, match="fit K=1"):
        cs.check_cdepth_lm(falling, {1: falling[::-1]}, _rows(2.0, 1.0))
    with pytest.raises(AssertionError, match="lm_loss"):
        cs.check_cdepth_lm(falling[::-1], {1: falling}, _rows(2.0, 1.0))


def test_saved_g_serves_at_its_rows_agreement(tmp_path):
    """A fitted g saved by the port's ``CheckpointManager``, restored by
    ``load_g_params`` (``--g-ckpt``'s loader) bit for bit and served at K
    4 by the drain engine (hyper_euler, fixed K, fused): its argmax
    agreement with the full forward is the K 4 hyper_euler row's."""
    cfg_j, pj = _bench_model()
    pt = _carry(pj)
    gp, _ = cs.fit_cdepth_g(pt, _carry(_jax_g(cfg_j)), 4, 3)
    toks, _ = next(token_batches(cfg_j.vocab, 4, 32, seed=11, device="cpu"))
    row = next(r for r in cs.cdepth_lm_rows(pt, {4: gp}, toks)
               if r["solver"] == "hyper_euler")
    served, restored = cs.serve_saved_g(pt, gp, toks, 4, str(tmp_path))
    assert all(torch.equal(restored[k], gp[k]) for k in gp)
    assert [(r.K, r.nfe, r.status) for r in served] == [(4, 4, "ok")] * 4
    top = tlm.lm_forward(pt, cs.cdepth_lm_cfg(), toks)[0].argmax(-1).numpy()
    agree = float(np.mean([np.mean(np.argmax(r.outputs, -1) == top[i])
                           for i, r in enumerate(served)]))
    assert agree == row["argmax_agreement"]


# ------------------------------------- tests/test_cdepth.py's cases ----

ARCHS = {"qwen3_4b": 8, "olmoe_1b_7b": 4}


@functools.lru_cache(maxsize=None)
def _jax_setup(arch, n):
    """The reference's weights and tokens of a reduced ``arch`` at ``n``
    layers, drawn once per file."""
    cfg_j = dataclasses.replace(jax_get(arch).reduced(), n_layers=n)
    pj = jlm.init_lm(jax.random.PRNGKey(0), cfg_j)
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0, cfg_j.vocab)
    return cfg_j, pj, toks


def _setup(arch, n_layers=None):
    """(cfg_j, cfg_t, JAX params, a fresh copy for the port, tokens)."""
    n = n_layers or ARCHS[arch]
    cfg_j, pj, toks = _jax_setup(arch, n)
    cfg_t = dataclasses.replace(torch_get(arch).reduced(), n_layers=n)
    return cfg_j, cfg_t, pj, _carry(pj), np.array(toks, np.int32)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_euler_full_K_equals_discrete_forward(arch):
    """Euler at K = n_groups reproduces the discrete network (the
    reference's bound), and the reference's solve."""
    cfg_j, cfg_t, pj, pt, toks = _setup(arch)
    n_groups = tlm.group_layout(cfg_t)[1]
    ref, _ = tlm.lm_forward(pt, cfg_t, torch.from_numpy(toks))
    ode = tcd.lm_forward_cdepth(pt, cfg_t, torch.from_numpy(toks), K=n_groups)
    _close(ode, ref.numpy(), rtol=1e-5, atol=1e-5)
    _close(ode, jcd.lm_forward_cdepth(pj, cfg_j, jnp.asarray(toks),
                                      K=n_groups))


def test_reduced_K_degrades_then_hypersolver_recovers():
    """At half the depth Euler moves the logits; 120 iterations of the
    residual fit (the reference test's: its model, the JAX-drawn weights,
    g and token batches, a new batch every 10, AdamW 3e-3, clip 1.0)
    bring the fit loss down and the error below Euler's. (The MoE fit's
    loss and gradient are held to the reference's below.)"""
    arch = "qwen3_4b"
    _, cfg_t, _, pt, toks = _setup(arch)
    K = tlm.group_layout(cfg_t)[1] // 2
    x = torch.from_numpy(toks)
    ref, _ = tlm.lm_forward(pt, cfg_t, x)
    err_base = float((ref - tcd.lm_forward_cdepth(pt, cfg_t, x, K=K))
                     .abs().mean())
    assert err_base > 0
    gp = _carry(_jax_g(jax_get(arch).reduced()))
    opt = adamw(3e-3)
    step = make_fit_step(
        lambda g, b: tcd.cdepth_residual_loss(pt, g, cfg_t, b, K), opt, 1.0)
    st, key, losses = opt.init(gp), jax.random.PRNGKey(3), []
    for i in range(120):
        if i % 10 == 0:
            key, sub = jax.random.split(key)
            batch = torch.from_numpy(np.array(jax.random.randint(
                sub, (2, 8), 0, cfg_t.vocab), np.int32))
        gp, st, loss = step(gp, st, i, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    hyper = tcd.lm_forward_cdepth(pt, cfg_t, x, K=K, g_params=gp)
    assert float((ref - hyper).abs().mean()) < err_base


@pytest.mark.parametrize("arch", list(ARCHS))
def test_trajectory_matches_jax(arch):
    """The group-boundary trajectory: n_groups + 1 states, finite, the
    reference's."""
    cfg_j, cfg_t, pj, pt, toks = _setup(arch, n_layers=4)
    traj = tcd.discrete_depth_trajectory(pt, cfg_t, torch.from_numpy(toks))
    assert traj.shape[0] == tlm.group_layout(cfg_t)[1] + 1
    assert torch.isfinite(traj).all()
    _close(traj, jcd.discrete_depth_trajectory(pj, cfg_j, jnp.asarray(toks)))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cdepth_residual_loss_and_grads_match_jax(arch):
    """The residual-fitting loss at K = n_groups / 2 and its gradient
    with respect to every leaf of a nonzero g."""
    cfg_j, cfg_t, pj, pt, toks = _setup(arch)
    K = tlm.group_layout(cfg_t)[1] // 2
    gj = _jax_g(cfg_j, readout=0.3)
    lj, grad_j = jax.value_and_grad(lambda g: jcd.cdepth_residual_loss(
        pj, g, cfg_j, jnp.asarray(toks), K))(gj)
    gt = jax.tree_util.tree_map(lambda t: t.requires_grad_(), _carry(gj))
    lt = tcd.cdepth_residual_loss(pt, gt, cfg_t, torch.from_numpy(toks), K)
    lt.backward()
    _close(lt, lj, rtol=1e-5, atol=1e-5)
    for k in gj:
        _close(gt[k].grad, grad_j[k], rtol=1e-4, atol=1e-5)
