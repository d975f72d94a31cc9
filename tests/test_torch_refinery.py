"""The port's online refinery (repro_torch/launch/refinery.py) and the
hooks it rides in both serving loops, held against the JAX package's on
the CPU; the counterparts of tests/test_refinery.py: ledger bounds and
seeding, capture bit-for-bit parity on every loop, trainer convergence,
hot-swap liveness, the shadow gate (promote, reject, roll back), the
graceful-drain hooks — and the parity the reference cannot pin against
itself: the capture cell's ``dz``/``R`` within 1e-4 of the reference's,
the reservoir's membership exactly the reference's (same rows, same
order), the candidate after the same fit steps within 1e-4 of the
reference's, on the reference's toy (d = 16; its head and the first
layer of g drawn by JAX and carried across) and on reduced float32
``qwen3_4b``, ``recurrentgemma_2b`` and ``rwkv6_1p6b``."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_isolation import port_module_isolation  # noqa: F401
from repro.configs import get as jax_get
from repro.launch import engine as jeng
from repro.launch import refinery as jref
from repro.launch import scheduler as jsch
from repro.launch import workload as jwl
from repro.models.lm import init_lm as jax_init_lm
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get as torch_get
from repro_torch.convert import params_from_jax
from repro_torch.launch import engine as teng
from repro_torch.launch import scheduler as tsch
from repro_torch.launch import workload as twl
from repro_torch.launch.refinery import (Refinery, RefineryConfig,
                                         ResidualLedger)

D = 16
W = np.array(jax.random.normal(jax.random.PRNGKey(7), (D, 10))) / np.sqrt(D)


@functools.lru_cache(maxsize=None)
def _w1(hidden=8):
    return np.asarray(jwl.toy_refinable_classifier(
        d=D, hidden=hidden).g_params["w1"])


def _toy(hidden=8):
    return twl.toy_refinable_classifier(W, _w1(hidden))


def _ecfg(mod=teng, **kw):
    # fixed K=2 + seg=1: every request crosses one interior segment
    # boundary, so the retire hook has healthy interior rows to capture
    kw.setdefault("controller", "fixed")
    kw.setdefault("fixed_K", 2)
    kw.setdefault("buckets", (2,))
    return mod.EngineConfig(**kw)


def _sched(model, ledger=None, overlap=False, slots=8, mod=tsch, emod=teng):
    return mod.InflightScheduler(model, _ecfg(emod), slots=slots, seg=1,
                                 overlap=overlap, ledger=ledger)


def _fill_ledger(model, **led_kw):
    led_kw.setdefault("capacity", 256)
    led_kw.setdefault("seed", 0)
    led = ResidualLedger(model, **led_kw)
    xs = twl.heterogeneous_requests(32, D, seed=3)
    twl.replay_scheduler(_sched(model, ledger=led),
                         twl.poisson_trace(xs, rate=1.0, seed=7))
    return led


@functools.lru_cache(maxsize=None)
def _jax_ledger(hidden=8, capacity=256, seed=0):
    model = jwl.toy_refinable_classifier(d=D, hidden=hidden)
    led = jref.ResidualLedger(model, capacity=capacity, seed=seed)
    xs = jwl.heterogeneous_requests(32, D, seed=3)
    jwl.replay_scheduler(_sched(model, ledger=led, mod=jsch, emod=jeng),
                         jwl.poisson_trace(xs, rate=1.0, seed=7))
    return model, led


def assert_ledgers_match(port, ref, tol):
    """Same reservoir membership (rows in the same slots, the same s and
    eps exactly); the captured z and dz within ``tol`` element for
    element, R within ``tol * max|z| / eps^2``: R (euler, p = 1) is a
    difference of terms of the state's size divided by eps^2, so the
    float32 rounding of those terms reaches it scaled by that much."""
    assert (port.seen, port.captures, port.fill, port.holdout_fill) == \
        (ref.seen, ref.captures, ref.fill, ref.holdout_fill)
    for a_split, b_split in ((port._samples, ref._samples),
                             (port._holdout, ref._holdout)):
        for a, b in zip(a_split, b_split):
            assert (a[0], a[1]) == (b[0], b[1])
            for j in (2, 3, 4):
                want = np.asarray(b[j], np.float32)
                scale = np.abs(np.asarray(b[2], np.float32)).max() \
                    / float(b[1]) ** 2 if j == 4 else 1.0
                np.testing.assert_allclose(
                    a[j].float().numpy(), want, rtol=tol,
                    atol=tol * scale)


# -------------------------------------------------------------- ledger ----

def test_ledger_validation_errors():
    model = _toy()
    with pytest.raises(ValueError, match="capacity"):
        ResidualLedger(model, capacity=0)
    with pytest.raises(ValueError, match="capture_rate"):
        ResidualLedger(model, capture_rate=1.5)
    with pytest.raises(ValueError, match="capture_rate"):
        ResidualLedger(model, capture_rate=-0.1)


def test_ledger_reservoir_is_bounded_and_seeded():
    leds = [_fill_ledger(_toy(), capacity=8, seed=5) for _ in range(2)]
    for led in leds:
        assert led.fill <= 8 and led.holdout_fill <= 8
        assert led.seen > 8          # the reservoir actually overflowed
    a, b = leds
    assert a.seen == b.seen
    for ta, tb in zip(a._samples, b._samples):
        assert ta[0] == tb[0] and ta[1] == tb[1]
        assert torch.equal(ta[2], tb[2])
    # and the reservoir is the reference's, slot for slot
    assert_ledgers_match(a, _jax_ledger(capacity=8, seed=5)[1], 1e-5)


@pytest.mark.parametrize("rate", [0.5, 1.0])
def test_ledger_matches_reference_capture_for_capture(rate):
    """The capture cell's dz and R within 1e-5 of the reference's and the
    reservoir membership exact — the ``capture_rate`` gate, algorithm R
    and the holdout split consume the same numpy draws."""
    led = _fill_ledger(_toy(), capacity=16, seed=2, capture_rate=rate)
    model = jwl.toy_refinable_classifier(d=D)
    ref = jref.ResidualLedger(model, capacity=16, seed=2,
                              capture_rate=rate)
    xs = jwl.heterogeneous_requests(32, D, seed=3)
    jwl.replay_scheduler(_sched(model, ledger=ref, mod=jsch, emod=jeng),
                         jwl.poisson_trace(xs, rate=1.0, seed=7))
    assert led.fill > 0 and led.holdout_fill > 0
    assert_ledgers_match(led, ref, 1e-5)


def test_capture_rate_zero_captures_nothing():
    led = _fill_ledger(_toy(), capture_rate=0.0)
    assert led.fill == 0 and led.seen == 0 and led.captures == 0


def test_scheduler_captures_interior_rows_only():
    led = _fill_ledger(_toy())
    assert led.fill > 0
    s_vals = np.asarray([t[0] for t in led._samples + led._holdout])
    assert np.all((s_vals > 0.0) & (s_vals < 1.0)), np.unique(s_vals)


def test_engine_captures_under_fixed_controller():
    model = _toy()
    led = ResidualLedger(model, capacity=64, seed=0)
    eng = teng.MultiRateEngine(model, _ecfg(), ledger=led)
    xs = twl.heterogeneous_requests(16, D, seed=3)
    eng.run(xs)
    assert led.fill > 0
    jm = jwl.toy_refinable_classifier(d=D)
    ref = jref.ResidualLedger(jm, capacity=64, seed=0)
    jeng.MultiRateEngine(jm, _ecfg(jeng), ledger=ref).run(xs)
    assert_ledgers_match(led, ref, 1e-5)


def _bitwise(rep_a, rep_b):
    a = {r.uid: r for r in rep_a.records}
    b = {r.uid: r for r in rep_b.records}
    if set(a) != set(b):
        return False
    for u, ra in a.items():
        rb = b[u]
        if (ra.t_submit, ra.t_admit, ra.t_done, ra.K, ra.nfe,
                ra.status) != (rb.t_submit, rb.t_admit, rb.t_done, rb.K,
                               rb.nfe, rb.status):
            return False
        if (ra.outputs is None) != (rb.outputs is None):
            return False
        if ra.outputs is not None and not np.array_equal(
                ra.outputs, rb.outputs, equal_nan=True):
            return False
    return True


@pytest.mark.parametrize("loop", ["drain", "sync", "overlap"])
def test_capture_parity_bitwise_all_loops(loop):
    """Capture on (rate 1.0) vs off: completions uid for uid bit for bit
    equal on each loop (capture reads state, is never priced)."""
    xs = twl.heterogeneous_requests(24, D, seed=11)
    trace = twl.poisson_trace(xs, rate=0.5, seed=13)

    def run(led_on):
        m = _toy()
        led = ResidualLedger(m, capacity=64, seed=0) if led_on else None
        if loop == "drain":
            return twl.replay_engine(teng.MultiRateEngine(
                m, _ecfg(), ledger=led), trace), led
        return twl.replay_scheduler(_sched(m, ledger=led,
                                           overlap=loop == "overlap"),
                                    trace), led

    (off, _), (on, led) = run(False), run(True)
    assert led.fill > 0
    assert _bitwise(off, on)


def test_ledger_flush_roundtrip(tmp_path):
    led = _fill_ledger(_toy())
    path = os.path.join(str(tmp_path), "ledger.npz")
    n = led.flush(path)
    assert n == led.fill + led.holdout_fill
    data = np.load(path)
    assert int(data["n_train"]) == led.fill
    assert data["s"].shape == (n,) and data["eps"].shape == (n,)
    assert data["z_0"].shape[0] == n and data["R_0"].shape[0] == n
    np.testing.assert_array_equal(data["z_0"][0], led._samples[0][2].numpy())
    led2 = ResidualLedger(_toy(), capacity=4, capture_rate=0.0)
    p2 = os.path.join(str(tmp_path), "empty.npz")
    assert led2.flush(p2) == 0
    assert int(np.load(p2)["n_train"]) == 0


def test_ledger_flush_widens_bf16_rows_exactly(tmp_path):
    """bf16 rows (a bf16 state's z and dz) flush as their exact float32
    widening, which numpy can store."""
    led = ResidualLedger(_toy(), capacity=4)
    z = torch.randn(2, D).to(torch.bfloat16)
    for i in range(2):
        led._offer((np.float32(0.5), np.float32(0.5), z[i], z[i],
                    torch.ones(D)))
    path = os.path.join(str(tmp_path), "bf16.npz")
    assert led.flush(path) == 2
    data = np.load(path)
    assert data["z_0"].dtype == np.float32
    np.testing.assert_array_equal(data["z_0"], z.float().numpy())


# ------------------------------------------------------------- trainer ----

def test_trainer_converges_on_captured_residuals():
    model = _toy(hidden=16)
    led = _fill_ledger(model, capacity=256)
    refin = Refinery(model, led,
                     RefineryConfig(steps_per_tick=60, batch_size=32,
                                    min_fill=8, lr=5e-3, total_steps=600))
    b = led.sample_batch(64, np.random.RandomState(0))
    args = (b["s"], b["eps"], b["z"], b["dz"], b["R"])
    loss0 = float(refin._eval_loss(refin.candidate, *args))
    for _ in range(10):
        last = refin.train_tick()
    assert refin.steps == 600
    loss1 = float(refin._eval_loss(refin.candidate, *args))
    assert loss1 < 0.5 * loss0, (loss0, loss1)
    assert last is not None
    fr = refin.shadow_score(model.g_params)
    ca = refin.shadow_score(refin.candidate)
    assert ca["resid"] < fr["resid"]


def test_trainer_matches_reference_step_for_step():
    """On the reference's own ledger rows (carried across), the port's
    trainer draws the same batches and lands on the reference's candidate
    within 1e-4 after 40 fit steps, loss for loss within 1e-4."""
    jm, jled = _jax_ledger()
    led = ResidualLedger(_toy(), capacity=256)
    conv = lambda t: torch.from_numpy(np.array(t))
    led._samples = [(s, e, conv(z), conv(dz), conv(R))
                    for s, e, z, dz, R in jled._samples]
    cfg = dict(steps_per_tick=8, batch_size=16, min_fill=8, lr=5e-3,
               total_steps=40)
    jr = jref.Refinery(jm, jled, jref.RefineryConfig(**cfg))
    tr = Refinery(_toy(), led, RefineryConfig(**cfg))
    for _ in range(5):
        np.testing.assert_allclose(tr.train_tick(), jr.train_tick(),
                                   rtol=1e-4)
    for k in tr.candidate:
        np.testing.assert_allclose(tr.candidate[k].numpy(),
                                   np.asarray(jr.candidate[k]), rtol=1e-4,
                                   atol=1e-4)


def test_trainer_noop_below_min_fill():
    model = _toy()
    refin = Refinery(model, ResidualLedger(model, capacity=64),
                     RefineryConfig(min_fill=8))
    assert refin.train_tick() is None and refin.steps == 0


def test_refinery_requires_parametric_model():
    led = ResidualLedger(_toy(), capacity=4)
    with pytest.raises(ValueError, match="parametric"):
        Refinery(twl.toy_classifier(W, "euler"), led)
    with pytest.raises(ValueError, match="param_site"):
        Refinery(_toy(), led, param_site="tail")
    with pytest.raises(ValueError, match="flow head"):
        Refinery(_toy(), led, param_site="flow")


def test_refinery_async_checkpoints_candidate(tmp_path):
    model = _toy()
    led = _fill_ledger(model)
    refin = Refinery(model, led,
                     RefineryConfig(steps_per_tick=4, min_fill=8,
                                    ckpt_every=2),
                     ckpt_dir=str(tmp_path))
    refin.train_tick()
    refin.flush()
    step, state = CheckpointManager(str(tmp_path)).restore_latest(
        refin.candidate)
    assert step == 4
    assert torch.equal(state["w1"], refin.candidate["w1"])
    # the reference restores the port's candidate too
    from repro.checkpoint import CheckpointManager as JaxCM
    jstep, jstate = JaxCM(str(tmp_path)).restore_latest(
        jax.eval_shape(lambda: jax.tree_util.tree_map(
            jnp.asarray, {k: v.numpy() for k, v in
                          refin.candidate.items()})))
    assert jstep == 4
    np.testing.assert_array_equal(np.asarray(jstate["w1"]),
                                  refin.candidate["w1"].numpy())


# ------------------------------------------------------------ hot swap ----

def test_hot_swap_mid_flight_rebuilds_nothing_and_is_live():
    """Swapping g mid-replay (pool busy, between segments) keeps the
    pool's segment call (nothing rebuilt) and the swapped params are
    live: completions after the swap differ from a never-swapped run —
    and equal the reference's swapped run."""
    xs = twl.heterogeneous_requests(24, D, seed=21)
    new_np = {k: np.asarray(v) + 0.5 for k, v in
              jwl.toy_refinable_classifier(d=D).g_params.items()}

    def run(swap, mod=tsch, emod=teng, wl=twl, model=None):
        sched = _sched(model or _toy(), mod=mod, emod=emod)
        state = {"tick": 0, "fn": None}

        def on_tick(s):
            state["tick"] += 1
            if swap and state["tick"] == 3:
                assert s.pending, "swap must land on a busy pool"
                if mod is tsch:
                    state["fn"] = next(iter(s._pools.values()))._segment_fn
                    s.hot_swap_g(params_from_jax(new_np))
                else:
                    s.hot_swap_g(jax.tree_util.tree_map(jnp.asarray,
                                                        new_np))

        rep = wl.replay_scheduler(sched, wl.poisson_trace(xs, rate=0.25,
                                                          seed=23),
                                  on_tick=on_tick)
        if swap and mod is tsch:
            assert next(iter(sched._pools.values()))._segment_fn \
                is state["fn"]
        return {r.uid: r.outputs for r in rep.records}

    plain, swapped = run(False), run(True)
    assert set(plain) == set(swapped)
    assert any(not np.array_equal(plain[u], swapped[u]) for u in plain)
    ref = run(True, jsch, jeng, jwl, jwl.toy_refinable_classifier(d=D))
    for u in swapped:
        np.testing.assert_allclose(swapped[u], np.asarray(ref[u]),
                                   rtol=1e-5, atol=1e-5)


def test_hot_swap_reaches_both_loops_alike():
    """A swap once 3 segments have been launched reaches the sync and the
    overlap loop at the same segment, the 4th (the overlap loop's
    segment in flight keeps the params it was launched with): the two
    swapped replays are equal bit for bit, completions before the swap
    equal the unswapped run's, and the resident params are replaced,
    never written in place."""
    xs = twl.heterogeneous_requests(24, D, seed=21)
    trace = twl.poisson_trace(xs, rate=0.25, seed=23)
    new = {k: v + 0.5 for k, v in _toy().g_params.items()}
    reps, swap_now = [], []
    for overlap in (False, True):
        sched = _sched(_toy(), overlap=overlap)
        old = sched.g_params
        snapshot = {k: v.clone() for k, v in old.items()}

        def on_tick(s, done=[]):
            if s.dispatches >= 3 and not done:
                done.append(s.now)
                s.hot_swap_g(new)

        reps.append(twl.replay_scheduler(sched, trace, on_tick=on_tick))
        swap_now.append(on_tick.__defaults__[0][0])
        assert all(torch.equal(old[k], snapshot[k]) for k in old)
    assert _bitwise(*reps)
    plain = {r.uid: r for r in twl.replay_scheduler(_sched(_toy()),
                                                    trace).records}
    early = [r for r in reps[0].records if r.t_done <= swap_now[0]]
    assert early and all(np.array_equal(r.outputs, plain[r.uid].outputs)
                         for r in early)


def test_engine_hot_swap_is_live():
    model = _toy()
    eng = teng.MultiRateEngine(model, _ecfg())
    xs = twl.heterogeneous_requests(8, D, seed=31)
    out_a = {c.uid: c.outputs for c in eng.run(xs)}
    old = eng.hot_swap_g({k: v + 0.5 for k, v in model.g_params.items()})
    assert all(torch.equal(old[k], model.g_params[k]) for k in old)
    out_b = {c.uid: c.outputs for c in eng.run(xs)}
    assert len(out_a) == len(out_b) == 8
    assert any(not np.array_equal(out_a[u - 8], out_b[u]) for u in out_b)


def test_hot_swap_validation_errors():
    sched = _sched(_toy())
    gp = sched.g_params
    with pytest.raises(ValueError):                     # shape mismatch
        sched.hot_swap_g({k: torch.zeros(v.shape + (1,)) for k, v in
                          gp.items()})
    with pytest.raises(ValueError):                     # dtype mismatch
        sched.hot_swap_g({k: torch.zeros(v.shape, dtype=torch.int32)
                          for k, v in gp.items()})
    with pytest.raises(ValueError):                     # treedef mismatch
        sched.hot_swap_g({"nope": torch.zeros(())})
    with pytest.raises(ValueError, match="parametric"):
        _sched(twl.toy_classifier(W, "euler")).hot_swap_g(gp)
    # a swap in another key order is the same tree (JAX sorts keys)
    sched.hot_swap_g({k: gp[k] for k in reversed(list(gp))})


# --------------------------------------------------------- shadow gate ----

def _refinery(model, led, **cfg_kw):
    cfg_kw.setdefault("min_fill", 8)
    cfg_kw.setdefault("ref_K", 32)
    return Refinery(model, led, RefineryConfig(**cfg_kw), ecfg=_ecfg(),
                    shadow_xs=twl.heterogeneous_requests(8, D, seed=99))


def test_gate_promotes_trained_candidate_into_targets():
    model = _toy()
    led = _fill_ledger(model, capacity=256)
    sched = _sched(model)
    refin = _refinery(model, led, steps_per_tick=30, lr=5e-3,
                      total_steps=300)
    for _ in range(10):
        refin.train_tick()
    old = sched.g_params
    verdict = refin.maybe_promote([sched])
    assert verdict["promoted"] and refin.promotions == 1
    assert refin.last_promotion == refin.steps
    assert all(torch.equal(sched.g_params[k], refin.current[k])
               for k in old)
    assert any(not torch.equal(old[k], sched.g_params[k]) for k in old)


def test_shadow_score_matches_reference():
    """The shadow scorer on the same params and held-out set: agreement
    and mean NFE equal, held-out residual within 1e-4 of the reference's
    (its frozen reference on the fused path, the reference's unfused:
    equal to 1e-6 on this state)."""
    jm, jled = _jax_ledger()
    led = ResidualLedger(_toy(), capacity=256)
    conv = lambda t: torch.from_numpy(np.array(t))
    led._holdout = [(s, e, conv(z), conv(dz), conv(R))
                    for s, e, z, dz, R in jled._holdout]
    shadow = twl.heterogeneous_requests(8, D, seed=99)
    tr = Refinery(_toy(), led, RefineryConfig(min_fill=8, ref_K=32),
                  ecfg=_ecfg(), shadow_xs=shadow)
    jr = jref.Refinery(jm, jled, jref.RefineryConfig(min_fill=8, ref_K=32),
                       ecfg=_ecfg(jeng), shadow_xs=shadow)
    np.testing.assert_allclose(tr._ref_out, np.asarray(jr._ref_out),
                               rtol=1e-5, atol=1e-5)
    gp_np = {k: np.asarray(v) + 0.1 for k, v in jm.g_params.items()}
    a = tr.shadow_score(params_from_jax(gp_np))
    b = jr.shadow_score(jax.tree_util.tree_map(jnp.asarray, gp_np))
    assert (a["agreement"], a["mean_nfe"]) == (b["agreement"],
                                               b["mean_nfe"])
    np.testing.assert_allclose(a["resid"], b["resid"], rtol=1e-4)


def test_gate_rejects_corrupted_candidate():
    model = _toy()
    led = _fill_ledger(model)
    sched = _sched(model)
    refin = _refinery(model, led)
    rng = np.random.RandomState(0)
    refin.candidate = {k: v + torch.from_numpy(
        100.0 * rng.standard_normal(tuple(v.shape)).astype(np.float32))
        for k, v in refin.candidate.items()}
    old = sched.g_params
    verdict = refin.maybe_promote([sched])
    assert not verdict["promoted"] and refin.rejections == 1
    assert all(torch.equal(old[k], sched.g_params[k]) for k in old)


def test_check_promoted_rolls_back_regressed_params():
    model = _toy()
    led = _fill_ledger(model, capacity=256)
    sched = _sched(model)
    refin = _refinery(model, led, steps_per_tick=30, lr=5e-3,
                      total_steps=300)
    for _ in range(10):
        refin.train_tick()
    assert refin.maybe_promote([sched])["promoted"]
    good = refin.current
    rng = np.random.RandomState(1)
    refin.current = {k: v + torch.from_numpy(
        100.0 * rng.standard_normal(tuple(v.shape)).astype(np.float32))
        for k, v in good.items()}
    assert refin.check_promoted([sched]) is True
    assert refin.rollbacks == 1
    prev = refin.current
    assert all(torch.equal(sched.g_params[k], prev[k]) for k in prev)
    assert refin.check_promoted([sched]) is None


def test_flow_site_trains_scores_and_swaps():
    """``param_site="flow"``: the candidate flow head fits the ledger's
    rows (relative flow loss), the shadow scorer serves it as the K=0
    tier, and a promotion hot-swaps the flow params of every target —
    the flow head's outputs move, g's params stay."""
    jm = jwl.toy_flow_classifier(d=D)
    model = twl.toy_flow_classifier(W, _w1(), np.asarray(
        jm.flow_params["w1"]))
    led = _fill_ledger(model, capacity=256)
    eng = teng.MultiRateEngine(model, teng.EngineConfig(
        buckets=(2, 4, 8, 16), tol=5e-3, solver="hyper_euler", fused=True,
        flow_threshold=0.25))
    refin = Refinery(model, led, RefineryConfig(
        steps_per_tick=20, min_fill=8, ref_K=32, lr=5e-3,
        total_steps=200), ecfg=_ecfg(),
        shadow_xs=twl.heterogeneous_requests(8, D, seed=99),
        param_site="flow")
    b = led.sample_batch(64, np.random.RandomState(0))
    args = (b["s"], b["eps"], b["z"], b["dz"], b["R"])
    loss0 = float(refin._eval_loss(refin.candidate, *args))
    for _ in range(10):
        refin.train_tick()
    assert float(refin._eval_loss(refin.candidate, *args)) < loss0
    g_before = dict(eng.g_params)
    xs = twl.heterogeneous_requests(6, D, seed=5)
    out0 = [c.outputs for c in eng.run(xs)]
    refin.candidate = refin.candidate   # trained ahead of current
    cand, cur = refin.shadow_score(refin.candidate), \
        refin.shadow_score(refin.current)
    assert set(cand) == {"agreement", "resid"}
    refin._swap(eng, refin.candidate)
    assert all(torch.equal(eng.flow_params[k], refin.candidate[k])
               for k in refin.candidate)
    assert all(eng.g_params[k] is g_before[k] for k in g_before)
    out1 = [c.outputs for c in eng.run(xs)]
    assert any(not np.array_equal(a, b) for a, b in zip(out0, out1))
    assert cur["resid"] > cand["resid"]


def test_status_keys_for_progress_line():
    model = _toy()
    refin = _refinery(model, ResidualLedger(model, capacity=8))
    st = refin.status()
    for key in ("ledger_fill", "ledger_seen", "candidate_step",
                "last_loss", "last_promotion", "promotions",
                "rejections", "rollbacks"):
        assert key in st


# ------------------------------------------------------- graceful drain ----

def test_should_admit_false_drains_inflight_and_stops_admission():
    sched = _sched(_toy(), slots=4)
    xs = twl.heterogeneous_requests(24, D, seed=41)
    trace = twl.poisson_trace(xs, rate=0.25, seed=43)
    ticks = [0]

    def on_tick(s):
        ticks[0] += 1

    rep = twl.replay_scheduler(sched, trace, on_tick=on_tick,
                               should_admit=lambda: ticks[0] < 3)
    assert 0 < len(rep.records) < len(trace)
    assert sched.pending == 0
    assert all(r.status in ("ok", "retried") for r in rep.records)


def test_drifting_requests_seeded_and_nonstationary():
    a = twl.drifting_requests(48, D, seed=3)
    np.testing.assert_array_equal(a, twl.drifting_requests(48, D, seed=3))
    np.testing.assert_array_equal(a, jwl.drifting_requests(48, D, seed=3))
    assert a.shape == (48, D)
    n = len(a) // 3
    assert np.linalg.norm(a[-n:], axis=1).mean() > \
        np.linalg.norm(a[:n], axis=1).mean()


# ------------------------------------------------------------- LM cases ----
# arch -> (layers, prompt tokens): the reduced float32 models of the
# in-flight tests; K fixed at 4 and seg 1, so every request is captured
# three times mid-flight
LM = {"qwen3_4b": (4, 8), "recurrentgemma_2b": (14, 16),
      "rwkv6_1p6b": (8, 16)}
LM_ECFG = dict(controller="fixed", fixed_K=4, buckets=(4,), solver="euler",
               fused=True)


@functools.lru_cache(maxsize=None)
def _lm(arch):
    n_layers, n_tok = LM[arch]
    cfg_j = dataclasses.replace(jax_get(arch).reduced(), n_layers=n_layers)
    cfg_t = dataclasses.replace(torch_get(arch).reduced(), n_layers=n_layers)
    pj = jax_init_lm(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    toks = np.random.RandomState(0).randint(0, cfg_j.vocab, (4, n_tok))
    jm = jeng.lm_depth_model(pj, cfg_j, refinable=True, rank=8)
    led = jref.ResidualLedger(jm, capacity=8, seed=1)
    jwl.replay_scheduler(jsch.InflightScheduler(
        jm, jeng.EngineConfig(**LM_ECFG), slots=4, seg=1, ledger=led),
        jwl.poisson_trace(toks.astype(np.int32), rate=0.5, seed=0))
    tm = teng.lm_depth_model(pt, cfg_t, refinable=True, rank=8,
                             g_params=params_from_jax(jax.tree_util.tree_map(
                                 np.asarray, jm.g_params)))
    return tm, toks.astype(np.int32), led


@pytest.mark.parametrize("arch", list(LM))
def test_lm_capture_matches_reference(arch):
    """A reduced float32 LM served in flight with a ledger (slots 4, seg
    1, K 4): the reservoir holds the reference's rows slot for slot, dz
    and R within 1e-4."""
    tm, toks, ref = _lm(arch)
    led = ResidualLedger(tm, capacity=8, seed=1)
    with torch.no_grad():
        twl.replay_scheduler(tsch.InflightScheduler(
            tm, teng.EngineConfig(**LM_ECFG), slots=4, seg=1, ledger=led),
            twl.poisson_trace(toks, rate=0.5, seed=0))
    assert led.seen > led.capacity
    assert_ledgers_match(led, ref, 1e-4)


@pytest.mark.parametrize("arch", list(LM))
@pytest.mark.parametrize("loop", ["drain", "sync", "overlap"])
def test_lm_capture_parity_bitwise(arch, loop):
    """Capture on vs off on a reduced LM: completions bit for bit equal
    on every loop, and the ledger filled."""
    tm, toks, _ = _lm(arch)
    trace = twl.poisson_trace(toks, rate=0.5, seed=0)

    def run(led):
        if loop == "drain":
            return twl.replay_engine(teng.MultiRateEngine(
                tm, teng.EngineConfig(**LM_ECFG), ledger=led), trace)
        return twl.replay_scheduler(tsch.InflightScheduler(
            tm, teng.EngineConfig(**LM_ECFG), slots=4, seg=1,
            overlap=loop == "overlap", ledger=led), trace)

    led = ResidualLedger(tm, capacity=16, seed=0)
    with torch.no_grad():
        off, on = run(None), run(led)
    assert led.fill > 0
    assert _bitwise(off, on)
