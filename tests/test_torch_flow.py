"""The port's K=0 flow tier (core/flowhead.py, core/controllers.py::
TierRouter, the flow branches of launch/engine.py and launch/scheduler.py,
models/cdepth.py::lm_flow_init/apply, core/train.py::train_flowhead,
launch/engine.py::load_flow_params) held against the JAX package's on the
CPU; the counterparts of tests/test_flow.py (its benchmark gate waits
for the benchmark; the flow tier on a sharded pool is held in
tests/test_torch_mesh.py).

Toy cases serve the reference's toy flow classifier (d = 12; its head
and both nets' first layers drawn by JAX and carried across). The LM
cases serve reduced ``qwen3_4b`` (4 layers), ``recurrentgemma_2b`` (14)
and ``rwkv6_1p6b`` (8) in float32 with a seeded nonzero flow head, at a
tolerance and threshold that route some requests but not all to K=0.

Held exactly: uid, status, K, nfe, completion order, virtual stamps,
``flow_served``/``escalated`` counts. Outputs at fp32 rtol = atol = 1e-5
through the toy head, 1e-4 through an LM. Every probe error sits at
least 1e-3 (relative) from the routing threshold and every K edge
(asserted), so rounding cannot move a request between tiers. The port's
sync and overlap loops are held equal bit for bit."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_isolation import port_module_isolation  # noqa: F401
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get as jax_get
from repro.core import TierRouter as JaxTierRouter
from repro.core import flow_combine as jax_flow_combine
from repro.core.residual import flow_fitting_loss as jax_flow_loss
from repro.core.residual import ledger_fitting_loss as jax_ledger_loss
from repro.core.train import FlowTrainConfig as JaxFlowTrainConfig
from repro.core.train import train_flowhead as jax_train_flowhead
from repro.distributed import fault as jfault
from repro.launch import engine as jeng
from repro.launch import scheduler as jsch
from repro.launch import workload as jwl
from repro.models.cdepth import lm_flow_apply as jax_lm_flow_apply
from repro.models.cdepth import lm_flow_init as jax_lm_flow_init
from repro.models.lm import init_lm as jax_init_lm
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get as torch_get
from repro_torch.convert import params_from_jax
from repro_torch.core import (FlowTrainConfig, TierRouter, flow_combine,
                              flow_fitting_loss, ledger_fitting_loss,
                              make_flow_apply, train_flowhead)
from repro_torch.distributed import fault as tfault
from repro_torch.launch import engine as teng
from repro_torch.launch import scheduler as tsch
from repro_torch.launch import workload as twl
from repro_torch.models.cdepth import lm_flow_apply, lm_flow_init

D = 12
LOOPS = pytest.mark.parametrize("overlap", [False, True],
                                ids=["sync", "overlap"])
_JAX_TOY = jwl.toy_flow_classifier(d=D)
W = np.array(jax.random.normal(jax.random.PRNGKey(7), (D, 10))) / np.sqrt(D)
W1 = np.asarray(_JAX_TOY.g_params["w1"])
FLOW_W1 = np.asarray(_JAX_TOY.flow_params["w1"])


def _t(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _toy():
    return twl.toy_flow_classifier(W, W1, FLOW_W1)


def _ecfg(mod, flow_threshold=0.0, **kw):
    kw.setdefault("buckets", (2, 4, 8, 16))
    kw.setdefault("tol", 5e-3)
    kw.setdefault("max_batch", 8)
    kw.setdefault("solver", "hyper_euler")
    kw.setdefault("fused", True)
    return mod.EngineConfig(flow_threshold=flow_threshold, **kw)


def _key(r):
    return (r.uid, r.K, r.nfe, r.status, r.t_submit, r.t_done)


def assert_records_match(port, ref, rtol, atol):
    """Equal policy record for record, in completion order; outputs
    allclose (NaN where the reference has NaN)."""
    assert [_key(r) for r in port] == [_key(r) for r in ref]
    for a, b in zip(port, ref):
        if b.outputs is None:
            assert a.outputs is None
        else:
            np.testing.assert_allclose(a.outputs, np.asarray(b.outputs),
                                       rtol=rtol, atol=atol, equal_nan=True)


def _bitwise_records_equal(a, b):
    ra = {r.uid: r for r in a.records}
    rb = {r.uid: r for r in b.records}
    if set(ra) != set(rb):
        return False
    for u in ra:
        x, y = ra[u], rb[u]
        if (x.status, x.K, x.nfe, x.t_submit, x.t_done) != \
                (y.status, y.K, y.nfe, y.t_submit, y.t_done):
            return False
        if (x.outputs is None) != (y.outputs is None):
            return False
        if x.outputs is not None and not np.array_equal(
                x.outputs, y.outputs, equal_nan=True):
            return False
    return True


# ------------------------------------------------------- flow head unit ----

def test_zero_init_flow_is_exactly_one_euler_step():
    """A zero-readout flow head is z + eps*dz bit for bit."""
    model = _toy()
    z = torch.from_numpy(np.random.RandomState(0).randn(5, D)
                         .astype(np.float32))
    dz = torch.from_numpy(np.random.RandomState(1).randn(5, D)
                          .astype(np.float32))
    out = model.flow_apply(model.flow_params, 1.0, 0.0, z, dz)
    assert torch.equal(out, z + 1.0 * dz)


def test_flow_combine_order_scaling():
    z, dz, corr = torch.ones(3), torch.full((3,), 2.0), torch.full((3,), 5.0)
    for order in (1, 2, 4):
        got = flow_combine(0.5, z, dz, corr, order=order)
        want = z + 0.5 * dz + 0.5 ** (order + 1) * corr
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flow_combine_matches_reference(dtype):
    """Leaf for leaf the reference's rounding, in float32 and bf16 (the
    scaled correction rounded to the state's type first)."""
    rs = np.random.RandomState(4)
    z, dz, c = (jnp.asarray(rs.randn(3, 7), dtype) for _ in range(3))
    got = flow_combine(0.25, *_t((z, dz, c)), order=1)
    want = np.asarray(jax_flow_combine(0.25, z, dz, c, order=1))
    assert str(got.dtype).endswith(dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


def _rows(seed, n=16):
    rs = np.random.RandomState(seed)
    return dict(s=rs.rand(n).astype(np.float32),
                eps=(0.1 + rs.rand(n)).astype(np.float32),
                z=rs.randn(n, D).astype(np.float32),
                dz=rs.randn(n, D).astype(np.float32),
                R=rs.randn(n, D).astype(np.float32))


def test_flow_fitting_loss_reduces_to_ledger_fitting_loss():
    """For the structured head the Euler part cancels: fitting F equals
    fitting its net on the raw residual rows; ``relative=True`` is
    smaller and positive; all three within 1e-6 of the reference's."""
    b = _rows(7)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}

    def net(fp, e, si, zi, dzi):
        return fp["w"] * zi + dzi * e.reshape(-1, 1)

    def net_jax(fp, e, si, zi, dzi):
        return fp["w"] * zi + dzi * e

    fa = make_flow_apply(net, order=1)
    flow = lambda e, si, zi, dzi: fa({"w": 0.3}, e, si, zi, dzi)
    g = lambda e, si, zi, dzi: net({"w": 0.3}, e, si, zi, dzi)
    args = (tb["s"], tb["eps"], tb["z"], tb["dz"], tb["R"])
    lf = float(flow_fitting_loss(flow, *args, order=1))
    lg = float(ledger_fitting_loss(g, *args))
    np.testing.assert_allclose(lf, lg, rtol=1e-4)
    lr = float(flow_fitting_loss(flow, *args, order=1, relative=True))
    assert 0.0 < lr < lf
    from repro.core import make_flow_apply as jax_make_flow_apply
    jfa = jax_make_flow_apply(net_jax, order=1)
    jflow = lambda e, si, zi, dzi: jfa({"w": 0.3}, e, si, zi, dzi)
    jargs = tuple(jnp.asarray(b[k]) for k in ("s", "eps", "z", "dz", "R"))
    np.testing.assert_allclose(
        lf, float(jax_flow_loss(jflow, *jargs, order=1)), rtol=1e-6)
    np.testing.assert_allclose(
        lr, float(jax_flow_loss(jflow, *jargs, order=1, relative=True)),
        rtol=1e-6)
    np.testing.assert_allclose(lg, float(jax_ledger_loss(
        lambda e, si, zi, dzi: net_jax({"w": 0.3}, e, si, zi, dzi),
        *jargs)), rtol=1e-6)


# ----------------------------------------------------------- tier router ----

def test_tier_router_masks_and_bounds():
    r = TierRouter(flow_threshold=0.5, hyper_k_max=4)
    err = np.asarray([0.001, 0.004, 0.01, np.nan, np.inf, 0.0])
    k_floor = np.asarray([0, 0, 0, 0, 0, 3])
    mask = r.flow_mask(err, 0.01, k_floor)
    assert mask.tolist() == [True, True, False, False, False, False]
    assert mask.tolist() == np.asarray(JaxTierRouter(
        flow_threshold=0.5).flow_mask(err, 0.01, k_floor)).tolist()
    assert r.tier_of([2, 4, 8, 16]).tolist() == [1, 1, 2, 2]
    for bad in (1.5, -0.1):
        with pytest.raises(ValueError, match="confidence fraction"):
            TierRouter(flow_threshold=bad)


def test_tier_router_threshold_rounds_like_the_reference():
    """At the threshold's own float32 neighbours the mask is the
    reference's (the product rounded to float32 once)."""
    thr, tol = 0.3, 0.07
    edge = np.float32(thr * tol)
    err = np.asarray([np.nextafter(edge, 0, dtype=np.float32), edge,
                      np.nextafter(edge, 1, dtype=np.float32)], np.float32)
    got = TierRouter(thr).flow_mask(err, tol, np.zeros(3, np.int32))
    want = np.asarray(JaxTierRouter(thr).flow_mask(err, tol,
                                                   np.zeros(3, np.int32)))
    assert got.tolist() == want.tolist() == [True, True, False]


def test_engine_config_flow_validation():
    with pytest.raises(ValueError, match="flow_threshold"):
        teng.EngineConfig(flow_threshold=1.5)
    flowless = twl.toy_refinable_classifier(W, W1)
    with pytest.raises(ValueError, match="flow"):
        teng.prepare_model(flowless, _ecfg(teng, 0.25))
    with pytest.raises(ValueError, match="controller"):
        teng.prepare_model(_toy(), _ecfg(teng, 0.25, controller="fixed",
                                         fixed_K=4))


# ----------------------------------------------------- flow-tier serving ----

def test_engine_serves_flow_tier_with_k0_accounting():
    """Zero-init g makes every probe error 0: every request completes on
    the flow tier with K=0, status ok, nfe == nfe_flow — record for
    record the reference's."""
    eng = teng.MultiRateEngine(_toy(), _ecfg(teng, 0.25))
    xs = twl.heterogeneous_requests(12, D, seed=0)
    done = eng.run(xs)
    for c in done:
        assert c.K == 0 and c.status == "ok" and c.nfe == eng.nfe_flow
        assert np.isfinite(c.outputs).all()
    assert eng.last_report.flow_served == 12
    ref = jeng.MultiRateEngine(_JAX_TOY, _ecfg(jeng, 0.25)).run(xs)
    assert [(c.uid, c.K, c.nfe, c.status) for c in done] == \
        [(c.uid, c.K, c.nfe, c.status) for c in ref]
    for a, b in zip(done, ref):
        np.testing.assert_allclose(a.outputs, np.asarray(b.outputs),
                                   rtol=1e-5, atol=1e-5)


@LOOPS
def test_scheduler_serves_flow_tier(overlap):
    sched = tsch.InflightScheduler(_toy(), _ecfg(teng, 0.25), slots=4,
                                   seg=2, overlap=overlap)
    xs = twl.heterogeneous_requests(10, D, seed=1)
    uids = [sched.submit(x) for x in xs]
    done = {}
    while sched.pending:
        for c in sched.step():
            done[c.uid] = c
    assert set(done) == set(uids)
    assert all(c.K == 0 and c.status == "ok" for c in done.values())
    assert sched.total_flow_served == 10
    assert sched.total_escalated == 0


def test_flow_sync_overlap_bitwise_parity():
    xs = twl.heterogeneous_requests(12, D, seed=5)
    trace = twl.poisson_trace(xs, rate=0.25, seed=105)
    reps = [twl.replay_scheduler(tsch.InflightScheduler(
        _toy(), _ecfg(teng, 0.25), slots=4, seg=2, overlap=ov), trace)
        for ov in (False, True)]
    assert _bitwise_records_equal(reps[0], reps[1])
    ref = jwl.replay_scheduler(jsch.InflightScheduler(
        _JAX_TOY, _ecfg(jeng, 0.25), slots=4, seg=2),
        jwl.poisson_trace(xs, rate=0.25, seed=105))
    assert_records_match(reps[0].records, ref.records, 1e-5, 1e-5)


# the toy's embedded-controller mix: easy rows probe at ~0.021-0.023 and
# hard ones at ~19, so at tol 0.05 a threshold of 0.5 (0.025) routes the
# easy half to flow and the hard half to K=16
MIX = dict(solver="euler", controller="embedded", tol=0.05)


def _assert_margins(errs, tol, thr, q=2):
    e = np.asarray(errs, np.float64)
    assert np.abs(e / (thr * tol) - 1.0).min() > 1e-3, e
    r = (e / tol) ** (1.0 / q)
    assert np.abs(r - np.round(r)).min() > 1e-3 or r.max() > 16, r


@pytest.mark.parametrize("loop", ["drain", "sync", "overlap"])
def test_mixed_tiers_match_reference(loop):
    """A threshold that routes part of the traffic: flow rows K=0, the rest
    on the ladder, record for record the reference's on every loop."""
    xs = twl.heterogeneous_requests(16, D, seed=3)
    _, errs = jeng.MultiRateEngine(_JAX_TOY, _ecfg(jeng, 0.5, **MIX)) \
        .probe(xs)
    _assert_margins(errs, MIX["tol"], 0.5)
    trace_t = twl.poisson_trace(xs, rate=0.25, seed=7)
    trace_j = jwl.poisson_trace(xs, rate=0.25, seed=7)
    if loop == "drain":
        rep = twl.replay_engine(teng.MultiRateEngine(
            _toy(), _ecfg(teng, 0.5, **MIX)), trace_t)
        ref = jwl.replay_engine(jeng.MultiRateEngine(
            _JAX_TOY, _ecfg(jeng, 0.5, **MIX)), trace_j)
    else:
        ov = loop == "overlap"
        rep = twl.replay_scheduler(tsch.InflightScheduler(
            _toy(), _ecfg(teng, 0.5, **MIX), slots=4, seg=2, overlap=ov),
            trace_t)
        ref = jwl.replay_scheduler(jsch.InflightScheduler(
            _JAX_TOY, _ecfg(jeng, 0.5, **MIX), slots=4, seg=2, overlap=ov),
            trace_j)
    Ks = {r.K for r in rep.records}
    assert 0 in Ks and len(Ks) > 1, Ks
    assert_records_match(rep.records, ref.records, 1e-5, 1e-5)


@pytest.mark.parametrize("threshold", [0.0, 1e-6])
def test_flow_disabled_parity_all_loops(threshold):
    """flow_threshold=0 (tier off), and one so tight nothing qualifies,
    serve bit for bit what a model with no flow head serves, on all
    three loops."""
    kw = {"controller": "embedded"}
    xs = twl.heterogeneous_requests(14, D, seed=9)
    trace = twl.poisson_trace(xs, rate=0.25, seed=109)

    def serve(model, ecfg):
        return (twl.replay_engine(teng.MultiRateEngine(model, ecfg), trace),
                twl.replay_scheduler(tsch.InflightScheduler(
                    model, ecfg, slots=4, seg=2), trace),
                twl.replay_scheduler(tsch.InflightScheduler(
                    model, ecfg, slots=4, seg=2, overlap=True), trace))

    with_flow = serve(_toy(), _ecfg(teng, threshold, **kw))
    without = serve(twl.toy_refinable_classifier(W, W1),
                    _ecfg(teng, 0.0, **kw))
    for a, b in zip(with_flow, without):
        assert _bitwise_records_equal(a, b)
        assert all(r.K > 0 for r in a.records)


def test_hot_swap_flow_validates_structure():
    eng = teng.MultiRateEngine(_toy(), _ecfg(teng, 0.25))
    good = {k: v + 1.0 for k, v in eng.flow_params.items()}
    old = eng.hot_swap_flow(good)
    assert all(torch.equal(eng.flow_params[k], good[k]) for k in good)
    assert torch.equal(old["b1"], torch.zeros(8))    # never written
    with pytest.raises(ValueError, match="hot_swap_flow"):
        eng.hot_swap_flow({"wrong": torch.zeros(3)})
    sched = tsch.InflightScheduler(_toy(), _ecfg(teng, 0.25), slots=4,
                                   seg=2)
    sched.hot_swap_flow(good)
    with pytest.raises(ValueError, match="hot_swap_flow"):
        sched.hot_swap_flow({"wrong": torch.zeros(3)})
    with pytest.raises(ValueError, match="flow head"):
        teng.MultiRateEngine(twl.toy_refinable_classifier(W, W1),
                             _ecfg(teng)).hot_swap_flow(good)


@pytest.mark.parametrize("loop", ["drain", "sync", "overlap"])
def test_hot_swap_flow_is_live_and_matches_reference(loop):
    """Swapped flow params reach the next flow eval: outputs move, and
    equal the reference's after the same swap."""
    xs = twl.heterogeneous_requests(8, D, seed=12)
    fp_np = {k: np.asarray(v) + 0.3 for k, v in
             _JAX_TOY.flow_params.items()}
    outs = []
    for mod, model, wl in ((teng, _toy(), twl), (jeng, _JAX_TOY, jwl)):
        loop_ = mod.MultiRateEngine(model, _ecfg(mod, 0.25)) \
            if loop == "drain" else (tsch if mod is teng else jsch) \
            .InflightScheduler(model, _ecfg(mod, 0.25), slots=4, seg=2,
                               overlap=loop == "overlap")
        before = loop_.run(xs)
        loop_.hot_swap_flow(_t(fp_np) if mod is teng else
                            jax.tree_util.tree_map(jnp.asarray, fp_np))
        after = loop_.run(xs)
        outs.append((before, after))
    (tb, ta), (jb, ja) = outs
    assert any(not np.array_equal(a.outputs, b.outputs)
               for a, b in zip(ta, tb))
    for a, b in zip(ta, ja):
        assert (a.K, a.status) == (b.K, b.status) == (0, "ok")
        np.testing.assert_allclose(a.outputs, np.asarray(b.outputs),
                                   rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------- escalation ----

@pytest.mark.parametrize("loop", ["drain", "sync", "overlap"])
@pytest.mark.parametrize("retries", [1, 0], ids=["escalate", "no-retry"])
def test_flow_escalation_matches_reference(loop, retries):
    """``corrupt_flow_eval`` poisons the flow rows of a hashed uid set:
    those requests escalate into the ladder (status ``escalated``, K at
    least the coarsest bucket, the flow attempt billed) — or, with no
    retry budget, come back ``diverged`` from the flow tier at K=0; uid
    for uid the reference's, with the same flow_served/escalated
    counts."""
    xs = twl.heterogeneous_requests(16, D, seed=3)
    kw = dict(flow_nan_frac=0.4, seed=2)
    ti, ji = tfault.FaultInjector(**kw), jfault.FaultInjector(**kw)
    retry = dict(retry=tfault.RetryPolicy(max_retries=retries))
    jretry = dict(retry=jfault.RetryPolicy(max_retries=retries))
    trace_t = twl.poisson_trace(xs, rate=0.25, seed=8)
    trace_j = jwl.poisson_trace(xs, rate=0.25, seed=8)
    counts = []
    if loop == "drain":
        te = teng.MultiRateEngine(_toy(), _ecfg(teng, 0.5, **MIX),
                                  fault_injector=ti, **retry)
        je = jeng.MultiRateEngine(_JAX_TOY, _ecfg(jeng, 0.5, **MIX),
                                  fault_injector=ji, **jretry)
        rep, ref = twl.replay_engine(te, trace_t), jwl.replay_engine(
            je, trace_j)
    else:
        ov = loop == "overlap"
        ts = tsch.InflightScheduler(_toy(), _ecfg(teng, 0.5, **MIX),
                                    slots=4, seg=2, overlap=ov,
                                    fault_injector=ti, **retry)
        js = jsch.InflightScheduler(_JAX_TOY, _ecfg(jeng, 0.5, **MIX),
                                    slots=4, seg=2, overlap=ov,
                                    fault_injector=ji, **jretry)
        rep, ref = twl.replay_scheduler(ts, trace_t), \
            jwl.replay_scheduler(js, trace_j)
        counts = [(ts.total_flow_served, ts.total_escalated),
                  (js.total_flow_served, js.total_escalated)]
        assert counts[0] == counts[1]
    statuses = {r.status for r in rep.records}
    assert ("escalated" if retries else "diverged") in statuses, statuses
    for r in rep.records:
        if r.status == "escalated":
            assert r.K >= 2 and np.isfinite(r.outputs).all()
        if r.status == "diverged":
            assert r.K == 0 and np.isnan(r.outputs).any()
    assert_records_match(rep.records, ref.records, 1e-5, 1e-5)


# -------------------------------------------------------------- the fit ----

class _Rows:
    """A ledger stand-in: fixed rows, ``sample_batch`` draws indices from
    the caller's RandomState exactly as ``ResidualLedger`` does."""

    def __init__(self, rows, to):
        self.rows, self.to = rows, to

    def sample_batch(self, n, rng):
        idx = rng.randint(0, len(self.rows["s"]), size=n)
        return {k: self.to(v[idx]) for k, v in self.rows.items()}


def test_train_flowhead_matches_reference():
    """``train_flowhead`` (relative flow loss, AdamW under a cosine
    schedule, clip) on the same rows and draws: after 20 iterations the
    losses are the reference's within 1e-5 and the params within 1e-5."""
    rows = _rows(11, n=24)
    cfg = dict(iters=20, batch_size=8, lr=3e-2, seed=4)
    jfa = _JAX_TOY.flow_apply
    jp, jl = jax_train_flowhead(jfa, _JAX_TOY.flow_params,
                                _Rows(rows, jnp.asarray),
                                JaxFlowTrainConfig(**cfg))
    toy = _toy()
    tp, tl = train_flowhead(toy.flow_apply, toy.flow_params,
                            _Rows(rows, torch.from_numpy),
                            FlowTrainConfig(**cfg))
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    for k in tp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- LM cases ----
# arch -> (layers, prompt tokens, tol, threshold): thr * tol splits this
# seed's euler probe errors, so some requests route to K=0, some not
LM = {"qwen3_4b": (4, 8, 2.5, 0.8),
      "recurrentgemma_2b": (14, 16, 3.125, 0.8),
      "rwkv6_1p6b": (8, 16, 3.5, 0.8)}


@functools.lru_cache(maxsize=None)
def _lm_setup(arch):
    n_layers, n_tok, tol, thr = LM[arch]
    cfg_j = dataclasses.replace(jax_get(arch).reduced(), n_layers=n_layers)
    cfg_t = dataclasses.replace(torch_get(arch).reduced(), n_layers=n_layers)
    pj = jax_init_lm(jax.random.PRNGKey(0), cfg_j)
    fj = jax_lm_flow_init(jax.random.PRNGKey(9), cfg_j, rank=8,
                          param_dtype=jnp.float32)
    fj = dict(fj, w_out=0.2 * jax.random.normal(jax.random.PRNGKey(10),
                                                fj["w_out"].shape))
    toks = np.random.RandomState(0).randint(0, cfg_j.vocab, (8, n_tok))
    toks = toks.astype(np.int32)
    kw = dict(buckets=(2, 4, 8), tol=tol, max_batch=8, solver="euler",
              fused=True, flow_threshold=thr)
    jm = jeng.lm_depth_model(pj, cfg_j, flow_params=fj)
    _, errs = jeng.MultiRateEngine(jm, jeng.EngineConfig(**kw)).probe(toks)
    e = errs.astype(np.float64)
    assert np.abs(e / (thr * tol) - 1.0).min() > 1e-3, e
    assert np.abs(e / tol - np.round(e / tol)).min() > 1e-3, e
    tm = teng.lm_depth_model(params_from_jax(
        jax.tree_util.tree_map(np.asarray, pj)), cfg_t,
        flow_params=_t(fj))
    return cfg_j, cfg_t, pj, fj, jm, tm, toks, kw


@pytest.mark.parametrize("arch", list(LM))
def test_lm_flow_apply_matches_reference(arch):
    cfg_j, _, _, fj, _, _, _, _ = _lm_setup(arch)
    rs = np.random.RandomState(2)
    z = rs.randn(3, 5, cfg_j.d_model).astype(np.float32)
    dz = rs.randn(3, 5, cfg_j.d_model).astype(np.float32)
    want = np.asarray(jax_lm_flow_apply(fj, 1.0, 0.0, jnp.asarray(z),
                                        jnp.asarray(dz)))
    got = lm_flow_apply(_t(fj), 1.0, 0.0, torch.from_numpy(z),
                        torch.from_numpy(dz)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", list(LM))
@pytest.mark.parametrize("loop", ["drain", "sync", "overlap"])
def test_lm_flow_tier_matches_reference(arch, loop):
    """A reduced float32 LM of each architecture: some requests served at
    K=0 (nfe == nfe_flow), the rest on the ladder; records exact and
    logits at 1e-4 against the reference's, flow counts equal."""
    cfg_j, cfg_t, pj, fj, jm, tm, toks, kw = _lm_setup(arch)
    if loop == "drain":
        te = teng.MultiRateEngine(tm, teng.EngineConfig(**kw))
        with torch.no_grad():
            got = te.run(toks)
        ref = jeng.MultiRateEngine(jm, jeng.EngineConfig(**kw)).run(toks)
        assert [(c.uid, c.K, c.nfe, c.status) for c in got] == \
            [(c.uid, c.K, c.nfe, c.status) for c in ref]
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.outputs, np.asarray(b.outputs),
                                       rtol=1e-4, atol=1e-4)
        n_flow = te.last_report.flow_served
        assert all(c.nfe == te.nfe_flow for c in got if c.K == 0)
    else:
        ov = loop == "overlap"
        ts = tsch.InflightScheduler(tm, teng.EngineConfig(**kw), slots=4,
                                    seg=2, overlap=ov)
        rep = twl.replay_scheduler(ts, twl.poisson_trace(toks, rate=0.25,
                                                         seed=0))
        js = jsch.InflightScheduler(jm, jeng.EngineConfig(**kw), slots=4,
                                    seg=2, overlap=ov)
        ref = jwl.replay_scheduler(js, jwl.poisson_trace(toks, rate=0.25,
                                                         seed=0))
        assert_records_match(rep.records, ref.records, 1e-4, 1e-4)
        n_flow = ts.total_flow_served
        assert (n_flow, ts.total_escalated) == (js.total_flow_served,
                                                js.total_escalated)
    assert 0 < n_flow < len(toks), n_flow


@pytest.mark.parametrize("arch", list(LM))
def test_lm_flow_escalation_matches_reference(arch):
    """The flow eval of a hashed uid set comes back NaN: those requests
    return ``escalated`` from the ladder (K >= 2, finite logits), uid for
    uid the reference's, in the drain and the in-flight loop."""
    cfg_j, cfg_t, pj, fj, jm, tm, toks, kw = _lm_setup(arch)
    inj = dict(flow_nan_frac=0.6, seed=1)
    got = teng.MultiRateEngine(tm, teng.EngineConfig(**kw),
                               fault_injector=tfault.FaultInjector(**inj))
    with torch.no_grad():
        t_recs = got.run(toks)
    j_recs = jeng.MultiRateEngine(jm, jeng.EngineConfig(**kw),
                                  fault_injector=jfault.FaultInjector(
                                      **inj)).run(toks)
    assert [(c.uid, c.K, c.nfe, c.status) for c in t_recs] == \
        [(c.uid, c.K, c.nfe, c.status) for c in j_recs]
    esc = [c for c in t_recs if c.status == "escalated"]
    assert esc and all(c.K >= 2 and np.isfinite(c.outputs).all()
                       for c in esc)
    reps = [twl.replay_scheduler(tsch.InflightScheduler(
        tm, teng.EngineConfig(**kw), slots=4, seg=2,
        fault_injector=tfault.FaultInjector(**inj)),
        twl.poisson_trace(toks, rate=0.25, seed=0))]
    ref = jwl.replay_scheduler(jsch.InflightScheduler(
        jm, jeng.EngineConfig(**kw), slots=4, seg=2,
        fault_injector=jfault.FaultInjector(**inj)),
        jwl.poisson_trace(toks, rate=0.25, seed=0))
    assert_records_match(reps[0].records, ref.records, 1e-4, 1e-4)
    assert "escalated" in {r.status for r in reps[0].records}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_load_flow_params_reads_either_package(tmp_path, writer):
    """``load_flow_params`` restores a flow head the port's own save side
    wrote, or the reference's, leaf for leaf."""
    cfg_j, cfg_t, _, fj, _, _, _, _ = _lm_setup("qwen3_4b")
    if writer == "port":
        CheckpointManager(str(tmp_path)).save(3, _t(fj), wait=True)
    else:
        JaxCheckpointManager(str(tmp_path)).save(3, fj)
    got = teng.load_flow_params(str(tmp_path), cfg_t, rank=8)
    assert sorted(got) == sorted(fj)
    for k in fj:
        assert torch.equal(got[k], torch.from_numpy(np.array(fj[k])))
    like = lm_flow_init(torch.Generator().manual_seed(0), cfg_t, rank=8,
                        param_dtype=torch.float32)
    assert all(got[k].shape == like[k].shape for k in like)
