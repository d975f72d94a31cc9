"""The port's optimizer substrate (repro_torch/optim: AdamW, SGD, the
global-norm clip, the cosine and warmup-cosine schedules) and its shared
fit step (core/train.py::make_fit_step) held against the JAX package's on
the CPU; the counterparts of tests/test_optim.py for what the refinery,
the flow-head fit and the trainer use (the int8 moments and gradient
compression are held in tests/test_torch_quant.py). AdamW's in-place
update, the trainer's, is held to its functional one in
tests/test_torch_train.py.

Tolerances: AdamW, SGD, the schedules and the clip at fp32 rtol = atol =
1e-6 over 20 steps of numpy-seeded gradients; ``make_fit_step`` params
at 1e-5 of the reference's after 10 steps (a loss through a tanh net,
whose gradients XLA and PyTorch reduce in different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_isolation import port_module_isolation  # noqa: F401
from repro.core.residual import ledger_fitting_loss as jax_ledger_loss
from repro.core.train import make_fit_step as jax_make_fit_step
from repro.optim import adamw as jax_adamw
from repro.optim import apply_updates as jax_apply
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim.optimizers import AdamState as JaxAdamState
from repro.optim import sgd as jax_sgd
from repro.optim.schedules import cosine_annealing as jax_cosine
from repro.optim.schedules import linear_warmup_cosine as jax_warmup_cosine
from repro_torch.checkpoint.manager import flatten_sorted
from repro_torch.convert import params_from_jax
from repro_torch.core import ledger_fitting_loss, make_fit_step
from repro_torch.optim import (AdamState, SgdState, adamw, apply_updates,
                               clip_by_global_norm, cosine_annealing,
                               global_norm, linear_warmup_cosine, sgd)


def _t(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _assert_close(port, ref, tol):
    for a, b in zip(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, ref)),
            [l.numpy() for l in flatten_sorted(port)[0]]):
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol)


def test_adamw_matches_numpy_reference():
    p = {"w": torch.tensor([[1.0, -2.0], [0.5, 3.0]])}
    g = {"w": torch.tensor([[0.1, -0.3], [0.2, 0.05]])}
    opt = adamw(1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    st = opt.init(p)
    params = p
    m = np.zeros((2, 2))
    v = np.zeros((2, 2))
    w = p["w"].numpy().astype(np.float64)
    gn = g["w"].numpy().astype(np.float64)
    for step in range(5):
        upd, st = opt.update(g, st, params, step)
        params = apply_updates(params, upd)
        m = 0.9 * m + 0.1 * gn
        v = 0.999 * v + 0.001 * gn * gn
        mh = m / (1 - 0.9 ** (step + 1))
        vh = v / (1 - 0.999 ** (step + 1))
        w = w - 1e-2 * (mh / (np.sqrt(vh) + 1e-8) + 0.01 * w)
    np.testing.assert_allclose(params["w"].numpy(), w, rtol=1e-5)


def test_adamw_converges_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    p = {"x": torch.zeros(3)}
    opt = adamw(0.1)
    st = opt.init(p)
    for i in range(300):
        x = p["x"].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum((x - target) ** 2), [x])
        upd, st = opt.update({"x": g}, st, p, i)
        p = apply_updates(p, upd)
    np.testing.assert_allclose(p["x"].numpy(), target.numpy(), atol=1e-2)


def test_schedules():
    s = cosine_annealing(1.0, 0.1, 100)
    assert abs(float(s(0)) - 1.0) < 1e-6
    assert abs(float(s(100)) - 0.1) < 1e-6
    js = jax_cosine(3e-3, 1e-4, 37)
    for step in range(0, 45, 3):
        np.testing.assert_allclose(
            float(s(step)), float(jax_cosine(1.0, 0.1, 100)(step)),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            float(cosine_annealing(3e-3, 1e-4, 37)(torch.tensor(
                float(step)))), float(js(jnp.float32(step))), rtol=1e-6,
            atol=1e-9)


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 20.0) < 1e-4
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-4
    # under the bound nothing moves
    small = {"a": torch.full((4,), 0.1), "b": {"c": torch.ones(2)}}
    same, n = clip_by_global_norm(small, 10.0)
    assert torch.equal(same["a"], small["a"])
    np.testing.assert_allclose(float(n), float(global_norm(small)))


def test_moment_dtype_bf16():
    opt = adamw(1e-2, moment_dtype=torch.bfloat16)
    p = {"w": torch.ones(8)}
    st = opt.init(p)
    assert st.mu["w"].dtype == torch.bfloat16
    upd, st = opt.update({"w": torch.full((8,), 0.5)}, st, p, 0)
    assert torch.isfinite(upd["w"]).all()


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adamw_cosine_clip_match_reference_20_steps(weight_decay):
    """AdamW under a cosine schedule with every gradient clipped at a
    global norm the draws exceed, 20 steps of numpy-seeded gradients over
    a nested tree: params, both moments and the clip norms within 1e-6
    of the reference's."""
    rs = np.random.RandomState(0)
    p_np = {"a": rs.randn(5, 3).astype(np.float32),
            "n": {"b": rs.randn(7).astype(np.float32)}}
    kw = dict(weight_decay=weight_decay)
    jopt = jax_adamw(jax_cosine(3e-2, 1e-3, 20), **kw)
    topt = adamw(cosine_annealing(3e-2, 1e-3, 20), **kw)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p_np), _t(p_np)
    jst, tst = jopt.init(jp), topt.init(tp)
    for step in range(20):
        g_np = jax.tree_util.tree_map(
            lambda l: (3.0 * rs.randn(*l.shape)).astype(np.float32), p_np)
        jg, jn = jax_clip(jax.tree_util.tree_map(jnp.asarray, g_np), 2.0)
        tg, tn = clip_by_global_norm(_t(g_np), 2.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        ju, jst = jopt.update(jg, jst, jp, step)
        tu, tst = topt.update(tg, tst, tp, step)
        jp, tp = jax_apply(jp, ju), apply_updates(tp, tu)
    _assert_close(tp, jp, 1e-6)
    _assert_close(tst.mu, jst.mu, 1e-6)
    _assert_close(tst.nu, jst.nu, 1e-6)


def test_fit_step_matches_reference_10_steps():
    """``make_fit_step`` (loss and grad, clip, AdamW under a cosine
    schedule, apply) over ``ledger_fitting_loss`` of a tanh correction
    net on numpy-seeded residual rows: after 10 steps the params are
    within 1e-5 of the reference's fit step, the losses within 1e-5."""
    rs = np.random.RandomState(3)
    n, d, h = 16, 6, 5
    rows = dict(s=rs.rand(n).astype(np.float32),
                eps=(0.1 + rs.rand(n)).astype(np.float32),
                z=rs.randn(n, d).astype(np.float32),
                dz=rs.randn(n, d).astype(np.float32),
                R=rs.randn(n, d).astype(np.float32))
    gp_np = {"w1": (0.5 * rs.randn(4, h)).astype(np.float32),
             "b1": np.zeros(h, np.float32),
             "w2": (0.1 * rs.randn(h, 1)).astype(np.float32)}

    def net_jax(gp, eps, s, z, dz):
        up = lambda a: jnp.broadcast_to(jnp.reshape(
            a, jnp.shape(a) + (1,) * (z.ndim - jnp.ndim(a))), z.shape)
        f = jnp.stack([z, dz, up(s), up(eps)], -1)
        return (jnp.tanh(f @ gp["w1"] + gp["b1"]) @ gp["w2"])[..., 0]

    def net(gp, eps, s, z, dz):
        up = lambda a: a.reshape(tuple(a.shape) + (1,) * (z.ndim - a.ndim)
                                 ).expand(z.shape)
        f = torch.stack([z, dz, up(s), up(eps)], -1)
        return (torch.tanh(f @ gp["w1"] + gp["b1"]) @ gp["w2"])[..., 0]

    def loss_jax(gp, s, eps, z, dz, R):
        return jax_ledger_loss(lambda e, si, zi, dzi: net_jax(gp, e, si, zi,
                                                              dzi),
                               s, eps, z, dz, R)

    def loss(gp, s, eps, z, dz, R):
        return ledger_fitting_loss(lambda e, si, zi, dzi: net(gp, e, si, zi,
                                                              dzi),
                                   s, eps, z, dz, R)

    jstep = jax_make_fit_step(loss_jax, jax_adamw(
        jax_cosine(3e-2, 1e-3, 10), weight_decay=1e-6), 1.0)
    opt = adamw(cosine_annealing(3e-2, 1e-3, 10), weight_decay=1e-6)
    tstep = make_fit_step(loss, opt, 1.0)
    jp = jax.tree_util.tree_map(jnp.asarray, gp_np)
    tp = _t(gp_np)
    jst = jax_adamw(1.0).init(jp)
    tst = opt.init(tp)
    jb = [jnp.asarray(rows[k]) for k in ("s", "eps", "z", "dz", "R")]
    tb = [torch.from_numpy(rows[k]) for k in ("s", "eps", "z", "dz", "R")]
    for step in range(10):
        jp, jst, jl = jstep(jp, jst, step, *jb)
        leaves_before = [l.clone() for l in tp.values()]
        tp_new, tst, tl = tstep(tp, tst, step, *tb)
        # functional: the params handed in are never written
        assert all(torch.equal(a, b) for a, b in zip(leaves_before,
                                                      tp.values()))
        tp = tp_new
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_close(tp, jp, 1e-5)


def test_adam_state_carries_across_from_jax():
    """``params_from_jax`` rebuilds the reference's ``AdamState`` (a
    NamedTuple of two trees) field by field, as the port's own type's
    layout: a reference optimizer state resumes in the port."""
    p = {"w": jnp.arange(6.0).reshape(2, 3), "b": jnp.ones(2)}
    jst = jax_adamw(1e-2).init(p)
    jst = JaxAdamState(mu=jax.tree_util.tree_map(lambda l: l + 1.0, jst.mu),
                       nu=jax.tree_util.tree_map(lambda l: l + 2.0, jst.nu))
    st = params_from_jax(jax.tree_util.tree_map(np.asarray, jst))
    assert type(st) is JaxAdamState and st._fields == AdamState._fields
    st = AdamState(*st)
    assert torch.equal(st.mu["w"], torch.arange(6.0).reshape(2, 3) * 0 + 1)
    assert torch.equal(st.nu["b"], torch.full((2,), 2.0))
    upd, st2 = adamw(1e-2).update({"w": torch.ones(2, 3),
                                   "b": torch.ones(2)}, st,
                                  _t(p), 0)
    ju, jst2 = jax_adamw(1e-2).update(
        {"w": jnp.ones((2, 3)), "b": jnp.ones(2)}, jst, p, 0)
    _assert_close(upd, ju, 1e-6)
    _assert_close(st2.nu, jst2.nu, 1e-6)


def test_linear_warmup_cosine_matches_reference():
    """The trainer's schedule (``launch/steps.py``: warmup 200 of 10,000)
    and a short one, at integer and float32 steps through warmup, the
    anneal and past its end, within 1e-6 of the reference's."""
    for args in ((3e-4, 3e-5, 200, 10_000), (1.0, 0.1, 5, 20),
                 (2e-3, 0.0, 0, 10)):
        js, ts = jax_warmup_cosine(*args), linear_warmup_cosine(*args)
        for step in (0, 1, 3, 5, 7, 12, 199, 200, 201, 5000, 9999, 10_000,
                     12_000):
            np.testing.assert_allclose(float(ts(step)), float(js(step)),
                                       rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(
                float(ts(torch.tensor(float(step) + 1.0))),
                float(js(jnp.float32(step) + 1.0)), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference_20_steps(momentum):
    """SGD under the warmup-cosine schedule (read at ``step``, not ``step +
    1`` as AdamW reads it), with and without momentum, 20 steps of
    numpy-seeded gradients: params and the momentum buffer within 1e-6
    of the reference's."""
    rs = np.random.RandomState(4)
    p_np = {"a": rs.randn(5, 3).astype(np.float32),
            "n": {"b": rs.randn(7).astype(np.float32)}}
    jopt = jax_sgd(jax_warmup_cosine(0.1, 0.01, 4, 20), momentum=momentum)
    topt = sgd(linear_warmup_cosine(0.1, 0.01, 4, 20), momentum=momentum)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p_np), _t(p_np)
    jst, tst = jopt.init(jp), topt.init(tp)
    assert isinstance(tst, SgdState)
    assert (tst.momentum is None) == (momentum == 0.0)
    for step in range(20):
        g_np = jax.tree_util.tree_map(
            lambda l: rs.randn(*l.shape).astype(np.float32), p_np)
        ju, jst = jopt.update(jax.tree_util.tree_map(jnp.asarray, g_np), jst,
                              jp, step)
        tu, tst = topt.update(_t(g_np), tst, tp, step)
        jp, tp = jax_apply(jp, ju), apply_updates(tp, tu)
    _assert_close(tp, jp, 1e-6)
    if momentum:
        _assert_close(tst.momentum, jst.momentum, 1e-6)
    # a constant rate, as a float
    u, _ = sgd(0.5).update({"w": torch.ones(3)}, sgd(0.5).init(None), None, 0)
    assert torch.equal(u["w"], torch.full((3,), -0.5))


def test_clip_promotes_low_precision_leaves_as_jax_does():
    """A bf16 leaf times the float32 clip factor is float32 in JAX; the
    port's clip gives the same dtype and values."""
    g = np.random.RandomState(5).randn(6).astype(np.float32) * 4
    jt, _ = jax_clip({"a": jnp.asarray(g).astype(jnp.bfloat16)}, 1.0)
    tt, _ = clip_by_global_norm({"a": torch.from_numpy(g).to(
        torch.bfloat16)}, 1.0)
    assert jt["a"].dtype == jnp.float32 and tt["a"].dtype == torch.float32
    np.testing.assert_allclose(tt["a"].numpy(), np.asarray(jt["a"]),
                               rtol=1e-6, atol=1e-7)
