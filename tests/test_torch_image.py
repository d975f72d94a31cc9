"""The image-classification slice as a whole, held against the JAX
package on the CPU: the MNIST-family pareto sweep of ``chip_smoke.py``
(the port's counterparts of ``benchmarks/common.py``'s ``reference_state``,
``eval_solver`` and ``accuracy_drop``) against the reference's on carried
params, and ``launch/engine.py::node_depth_model`` through both drain
engines.

Tolerances: MAPE (a percentage, the float32 mean of ~4e4 ratios) within
1e-4 of the reference's, relative (1e-4 absolute below 1 %), accuracy
drop equal, NFE exact; engine K and nfe exact, argmax exact, logits
within 1e-4 (fp32). The engine's probe tolerances keep every request's
(err/tol)^(1/q) more than 1e-3 from an integer (asserted), so rounding
cannot flip a K."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FixedGrid as JaxGrid
from repro.core import NeuralODE as JaxNODE
from repro.core import depth_like as jax_depth_like
from repro.core import get_tableau as jax_tableau
from repro.data import synthetic_images as jax_images
from repro.launch import engine as jeng
from repro.models import conv_node as J
from repro_torch.convert import nchw_from_nhwc, params_from_jax
from repro_torch.core import NeuralODE, depth_like
from repro_torch.launch import engine as teng
from repro_torch.models import conv_node as T

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

SOLVERS = ("euler", "hyper_euler", "midpoint", "rk4")


def _carry(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _jax_rows(node, params, gp, x, Ks):
    """The reference bench's ``eval_solver``/``accuracy_drop`` with the
    fused path as an option."""
    ref, _, _ = node.reference_trajectory(params, x, 1, atol=1e-5, rtol=1e-5)
    z_ref = ref[-1]
    rows = []
    for K in Ks:
        for name in SOLVERS:
            row = dict(solver=name, K=K)
            for fused in (False, True):
                if name.startswith("hyper_"):
                    integ = J.mnist_integrator(gp, x, base="euler",
                                               fused=fused)
                else:
                    integ = J.mnist_integrator(base=jax_tableau(name),
                                               fused=fused)
                zT = integ.solve(node.field(params, x),
                                 node.hx_apply(params, x),
                                 JaxGrid.over(0.0, 1.0, K), return_traj=False)
                tag = "fused" if fused else "unfused"
                row[f"mape_{tag}"] = float(jnp.mean(
                    jnp.abs(zT - z_ref) / (jnp.abs(z_ref) + 1e-3))) * 100
                agree = float(jnp.mean(
                    jnp.argmax(node.hy_apply(params, zT), -1)
                    == jnp.argmax(node.hy_apply(params, z_ref), -1)))
                row[f"acc_drop_{tag}"] = (1.0 - agree) * 100
            row["nfe"] = integ.nfe(K)
            rows.append(row)
    return rows


def test_mnist_pareto_rows_match_reference():
    """Batch 4, carried NODE and g (g's last conv given small random
    weights, so HyperEuler is not Euler): the rows at K 2 and 10 for all
    four solvers, unfused and fused."""
    jnode, jp = J.mnist_node(jax.random.PRNGKey(0))
    gp = J.init_mnist_hyper(jax.random.PRNGKey(1))
    gp["c2"]["w"] = jnp.asarray(0.02 * np.random.RandomState(2).randn(
        *gp["c2"]["w"].shape).astype(np.float32))
    xs, _ = jax_images("mnist28", 4, seed=9)
    want = _jax_rows(jnode, jp, gp, xs, (2, 10))

    fam = chip_smoke.image_family("mnist")
    tnode = NeuralODE(T.mnist_f_apply, T.mnist_hx, T.mnist_hy)
    tp, tgp = _carry(jp), _carry(gp)
    x = nchw_from_nhwc(np.asarray(xs))
    with torch.no_grad():
        z_ref, nfe = chip_smoke.reference_state(tnode, tp, x)
        got = chip_smoke.pareto_rows(fam, tnode, tp, tgp, x, z_ref, (2, 10),
                                     SOLVERS)
    assert nfe > 0 and len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert (g["solver"], g["K"], g["nfe"]) == (w["solver"], w["K"],
                                                  w["nfe"])
        for tag in ("unfused", "fused"):
            np.testing.assert_allclose(g[f"mape_{tag}"], w[f"mape_{tag}"],
                                       rtol=1e-4, atol=1e-4, err_msg=str(g))
            assert g[f"acc_drop_{tag}"] == w[f"acc_drop_{tag}"], (g, w)
        assert g["fused_diff"] <= chip_smoke.FUSED_TOL * g["max_abs_z"]
    euler = {r["K"]: r["mape_unfused"] for r in got if r["solver"] == "euler"}
    assert euler[10] < euler[2]


# -------------------------------------------------------- engine adapter ----

NZ, HID = 6, 16
RS = np.random.RandomState(7)
W = {"w1": (0.9 * RS.randn(NZ + 1, HID)).astype(np.float32),
     "w2": (0.9 * RS.randn(HID, NZ)).astype(np.float32),
     "hx": (0.8 * RS.randn(3, NZ)).astype(np.float32),
     "hy": RS.randn(NZ, 4).astype(np.float32)}
GW = {"w1": (0.3 * RS.randn(2 * NZ + 1, HID)).astype(np.float32),
      "w2": (0.3 * RS.randn(HID, NZ)).astype(np.float32)}
XS = (1.5 * RS.randn(8, 3)).astype(np.float32)
# solver -> probe tolerance (order 1)
TOLS = {"euler": 0.37, "hyper_euler": 0.21}


def _jax_node():
    def f(p, s, x, z):
        return jnp.tanh(jnp.concatenate([z, jax_depth_like(s, z)], -1)
                        @ p["w1"]) @ p["w2"]

    def g(gp, eps, s, x, z, dz):
        return jnp.tanh(jnp.concatenate([z, dz, jax_depth_like(s, z)], -1)
                        @ gp["w1"]) @ gp["w2"]
    return JaxNODE(f, lambda p, x: x @ p["hx"], lambda p, z: z @ p["hy"]), g


def _torch_node():
    def f(p, s, x, z):
        return torch.tanh(torch.cat([z, depth_like(s, z)], -1)
                          @ p["w1"]) @ p["w2"]

    def g(gp, eps, s, x, z, dz):
        return torch.tanh(torch.cat([z, dz, depth_like(s, z)], -1)
                          @ gp["w1"]) @ gp["w2"]
    return NeuralODE(f, lambda p, x: x @ p["hx"],
                     lambda p, z: z @ p["hy"]), g


def _engines(solver, fused):
    jnode, jg = _jax_node()
    tnode, tg = _torch_node()
    hyper = solver.startswith("hyper_")
    jm = jeng.node_depth_model(
        jnode, jax.tree_util.tree_map(jnp.asarray, W), solver,
        jg if hyper else None,
        jax.tree_util.tree_map(jnp.asarray, GW) if hyper else None, fused)
    tm = teng.node_depth_model(tnode, params_from_jax(W), solver,
                               tg if hyper else None,
                               params_from_jax(GW) if hyper else None, fused)
    kw = dict(buckets=(2, 4, 8), tol=TOLS[solver], max_batch=4,
              solver=solver, fused=fused)
    return (jeng.MultiRateEngine(jm, jeng.EngineConfig(**kw)),
            teng.MultiRateEngine(tm, teng.EngineConfig(**kw)))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("solver", ["euler", "hyper_euler"])
def test_node_depth_model_serves_like_reference(solver, fused):
    """A dense toy node whose field and g lift s with ``depth_like``,
    served through both drain engines (controller auto: embedded for
    euler, residual for hyper_euler; buckets 2, 4, 8)."""
    je, te = _engines(solver, fused)
    _, errs = te.probe(XS)
    x = (errs / TOLS[solver]).astype(np.float64)
    assert np.abs(x - np.round(x)).min() > 1e-3, x
    with torch.no_grad():
        got = te.run(XS)
    want = je.run(XS)
    assert len({c.K for c in got}) > 1, [c.K for c in got]
    for g, w in zip(got, want):
        assert (g.uid, g.K, g.nfe, g.status) == (w.uid, w.K, w.nfe, w.status)
        assert g.fused_kernel == w.fused_kernel == fused
        np.testing.assert_allclose(g.outputs, np.asarray(w.outputs),
                                   rtol=1e-4, atol=1e-4)
        assert np.argmax(g.outputs) == np.argmax(np.asarray(w.outputs))


def test_hyper_solver_without_g_raises_in_both_packages():
    jnode, _ = _jax_node()
    tnode, _ = _torch_node()
    with pytest.raises(ValueError, match="needs a correction"):
        jeng.node_depth_model(jnode, W, "hyper_euler")
    with pytest.raises(ValueError, match="needs a correction"):
        teng.node_depth_model(tnode, params_from_jax(W), "hyper_euler")


def test_conv_node_under_the_engine_raises_in_both_packages():
    """The reference's conv fields cannot lift the engine's per-sample
    (B,) depth (``nn/conv_blocks.py::depth_cat``); the port keeps that."""
    jnode, jp = J.mnist_node(jax.random.PRNGKey(0))
    xs, _ = jax_images("mnist28", 2, seed=1)
    kw = dict(buckets=(2,), controller="fixed", fixed_K=2)
    je = jeng.MultiRateEngine(jeng.node_depth_model(jnode, jp),
                              jeng.EngineConfig(**kw))
    with pytest.raises(ValueError, match="broadcast"):
        je.run(np.asarray(xs))
    tnode = NeuralODE(T.mnist_f_apply, T.mnist_hx, T.mnist_hy)
    te = teng.MultiRateEngine(teng.node_depth_model(tnode, _carry(jp)),
                              teng.EngineConfig(**kw))
    with pytest.raises(RuntimeError):
        with torch.no_grad():
            te.run(nchw_from_nhwc(np.asarray(xs)).numpy())
