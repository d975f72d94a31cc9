"""The port's trainer (repro_torch/launch/{steps,train}.py, the watchdog and
``FailureInjector`` of distributed/fault.py, data/loader.py, the remat
policies of models/lm.py) held against the JAX package on the CPU, with
reduced float32 configs, numpy-seeded tokens and weights drawn by the
JAX package carried across with ``convert.params_from_jax``.

The reference's ``make_train_step`` builds shardings for a mesh, and in
this container its jit fails with ``ShardingTypeError`` (the two red
reference tests of tests/test_fault_tolerance.py). So the reference step
is composed from the reference's own pure parts: ``jax.value_and_grad``
of ``repro.models.lm.lm_loss``, ``repro.optim.clip_by_global_norm``,
``repro.launch.steps.make_optimizer(settings)`` and ``apply_updates``;
with microbatches it follows ``steps.py:221–249`` (a ``lax.scan`` over
``split_microbatches``, gradients accumulated in ``acc_dtype``) without
the sharding constraints, which change no number on one device. The
reference loop of the fault scenarios is ``repro/launch/train.py``'s
loop over that step.

Tolerances: losses, grad norms, params and moments within 1e-5 of the
reference after three steps (XLA and PyTorch sum matmuls in different
orders); the in-place update, the remat policies and the fault
scenarios' replays bit for bit (one package, one order of operations).
"""
import dataclasses
import functools
import gc
import re
import subprocess
import sys
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from port_isolation import port_module_isolation  # noqa: F401
from repro import configs as jax_configs
from repro.data import ShardedLoader as JaxLoader
from repro.distributed import fault as jfault
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import encdec as jed
from repro.models import lm as jlm
from repro.optim import apply_updates as jax_apply
from repro.optim import clip_by_global_norm as jax_clip
from repro_torch import configs as torch_configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import flatten_sorted
from repro_torch.convert import params_from_jax
from repro_torch.data import ShardedLoader, token_batches
from repro_torch.distributed import fault as tfault
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import encdec as ted
from repro_torch.models import lm as tlm
from repro_torch.optim import apply_updates, clip_by_global_norm, clip_scale

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, SEED = 4, 32, 5                     # tests/test_fault_tolerance.py
SETTINGS = dict(microbatches=1, remat="none", zero_opt=False, lr=1e-3)
ARCHS = ("qwen3_4b", "recurrentgemma_2b", "rwkv6_1p6b", "olmoe_1b_7b")


def _cfgs(arch):
    return jax_configs.get(arch).reduced(), torch_configs.get(arch).reduced()


@functools.lru_cache(maxsize=None)
def _stream(vocab):
    it = token_batches(vocab, B, S, seed=SEED, device="cpu")
    return tuple(tuple(t.numpy() for t in next(it)) for _ in range(12))


def _batches(vocab, n):
    """The first ``n`` (at most 12) (tokens, targets) batches of the
    seed-5 stream, as numpy (the packages draw the same tokens from one
    seed)."""
    return list(_stream(vocab)[:n])


def _jax_init(cfg):
    """The reference's weights for ``cfg`` from ``PRNGKey(0)``."""
    return jax.jit(functools.partial(jlm.init_lm, cfg=cfg))(
        jax.random.PRNGKey(0))


def _np_leaves(tree):
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(tree)]


def _port_leaves(tree):
    return [l.numpy() for l in flatten_sorted(tree)[0]]


def _to_jax(tree):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)


def _assert_trees_close(port, ref):
    a, b = _port_leaves(port), _np_leaves(ref)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, **TOL)


_REF_STEPS = {}


def _ref_step(cfg, settings):
    """The reference's train step, composed from its pure parts (module
    docstring), jitted, once per config and settings."""
    key = (cfg, settings)
    if key in _REF_STEPS:
        return _REF_STEPS[key]
    opt = jsteps.make_optimizer(settings)

    def loss_fn(p, mb):       # steps.py's loss_fn
        if cfg.is_encdec:
            return jed.encdec_loss(p, cfg, mb["frames"], mb["tokens"],
                                   mb["targets"], remat=settings.remat)
        return jlm.lm_loss(p, cfg, mb["tokens"], mb["targets"],
                           frontend=mb.get("frontend"), remat=settings.remat)

    def step(params, opt_state, step, batch):
        m = settings.microbatches
        if m == 1:
            (loss, metrics), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params, batch)
        else:
            mbs = jsteps.split_microbatches(batch, m)

            def acc(carry, mb):
                g_acc, l_acc = carry
                (l, met), g = jax.value_and_grad(loss_fn, has_aux=True)(
                    params, mb)
                g_acc = jax.tree_util.tree_map(jnp.add, g_acc, g)
                return (g_acc, l_acc + l), met

            acc_dt = jlm.dtype_of(settings.acc_dtype)
            g0 = jax.tree_util.tree_map(
                lambda p: jnp.zeros(p.shape, acc_dt), params)
            (grads, loss), mets = jax.lax.scan(acc, (g0, 0.0), mbs)
            grads = jax.tree_util.tree_map(lambda g: g / m, grads)
            loss = loss / m
            metrics = jax.tree_util.tree_map(lambda a: jnp.mean(a, 0), mets)
        grads, gnorm = jax_clip(grads, settings.grad_clip)
        updates, opt_state = opt.update(grads, opt_state, params, step)
        params = jax_apply(params, updates)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    _REF_STEPS[key] = (opt, jax.jit(step))
    return _REF_STEPS[key]


def _ref_loop(cfg, settings, params, batches, steps):
    """``repro/launch/train.py``'s loop without a checkpoint: the history
    of ``{step, loss, grad_norm}``."""
    opt, step_fn = _ref_step(cfg, settings)
    opt_state = opt.init(params)
    hist = []
    for step in range(steps):
        t, y = batches[step]
        params, opt_state, met = step_fn(
            params, opt_state, jnp.asarray(step, jnp.int32),
            {"tokens": jnp.asarray(t), "targets": jnp.asarray(y)})
        hist.append({"step": step, "loss": float(met["loss"]),
                     "grad_norm": float(met["grad_norm"])})
    return hist


# ------------------------------------------------------------- steps ----

@pytest.mark.parametrize("arch,micro", [(a, 1) for a in ARCHS]
                         + [("qwen3_4b", 2)])
def test_train_step_matches_reference(arch, micro):
    """Three steps of ``make_train_step`` from the reference's weights on
    the seed-5 stream: losses, grad norms, params and both moments within
    1e-5 of the reference's composed step."""
    cfg_j, cfg_t = _cfgs(arch)
    settings = dict(SETTINGS, microbatches=micro)
    opt_j, step_j = _ref_step(cfg_j, jsteps.StepSettings(**settings))
    step_t, opt_t = tsteps.make_train_step(cfg_t,
                                           tsteps.StepSettings(**settings))
    pj = _jax_init(cfg_j)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    sj, st = opt_j.init(pj), opt_t.init(pt)
    for step, (t, y) in enumerate(_batches(cfg_t.vocab, 3)):
        pj, sj, mj = step_j(pj, sj, jnp.asarray(step, jnp.int32),
                            {"tokens": jnp.asarray(t),
                             "targets": jnp.asarray(y)})
        pt, st, mt = step_t(pt, st, step, {"tokens": torch.from_numpy(t),
                                           "targets": torch.from_numpy(y)})
        for k in ("loss", "grad_norm", "ce"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), **TOL)
    _assert_trees_close(pt, pj)
    _assert_trees_close(st.mu, sj.mu)
    _assert_trees_close(st.nu, sj.nu)


@pytest.mark.parametrize("chunk", [None, 7])
def test_in_place_update_equals_the_functional_one(monkeypatch, chunk):
    """``update_in_place`` (the train step's) against ``adamw.update`` +
    ``apply_updates`` on the same clipped gradients, bit for bit, with
    weight decay and a bf16 leaf (JAX's promotion of the clip factor),
    whole leaves and in ragged chunks of 7 elements."""
    if chunk is not None:
        from repro_torch.optim import optimizers
        monkeypatch.setattr(optimizers, "IN_PLACE_CHUNK", chunk)
    opt = tsteps.make_optimizer(tsteps.StepSettings(lr=1e-2))
    rs = np.random.RandomState(3)
    params = {"a": torch.from_numpy(rs.randn(5, 7).astype(np.float32)),
              "b": [torch.from_numpy(rs.randn(3).astype(np.float32)),
                    torch.from_numpy(rs.randn(4, 2).astype(np.float32))
                    .to(torch.bfloat16)]}
    live = pytree.tree_map(torch.clone, params)
    st_f, st_i = opt.init(params), opt.init(live)
    for step in range(4):
        grads = pytree.tree_map(lambda p: torch.from_numpy(
            3 * rs.randn(*p.shape).astype(np.float32)).to(p.dtype), params)
        clipped, norm = clip_by_global_norm(grads, 1.0)
        upd, st_f = opt.update(clipped, st_f, params, step)
        params = apply_updates(params, upd)
        opt.update_in_place(pytree.tree_leaves(grads), st_i, live, step,
                            clip_scale(norm, 1.0))
        for a, b in zip(pytree.tree_leaves((params, st_f)),
                        pytree.tree_leaves((live, st_i))):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen3_4b", "recurrentgemma_2b",
                                  "rwkv6_1p6b"])
def test_remat_policies_equal_none_bit_for_bit(arch):
    """``lm_loss(remat="full")`` and ``"dots"`` give ``"none"``'s loss and
    gradients bit for bit, and ``lm_forward`` its logits."""
    cfg = torch_configs.get(arch).reduced()
    params = tlm.init_lm(torch.Generator().manual_seed(0), cfg)
    t, y = (torch.from_numpy(a) for a in _batches(cfg.vocab, 1)[0])
    leaves, spec = pytree.tree_flatten(params)
    out = {}
    for remat in tlm.REMAT_POLICIES:
        live = [l.detach().requires_grad_() for l in leaves]
        loss, _ = tlm.lm_loss(pytree.tree_unflatten(live, spec), cfg, t, y,
                              remat=remat)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, live),
                      tlm.lm_forward(params, cfg, t, remat=remat)[0])
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        assert torch.equal(out[remat][2], out["none"][2])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="remat 'some'"):
        tlm.lm_loss(params, cfg, t, y, remat="some")


def _frontend_and_encdec_batch(cfg, seed=6):
    """Numpy inputs of the step builders' frontend and encoder-decoder
    branches at reduced size: tokens and targets (2, 6), with 8 patch
    embeddings (paligemma) or 12 frames (whisper)."""
    rs = np.random.RandomState(seed)
    batch = {k: rs.randint(0, cfg.vocab, (2, 6)).astype(np.int32)
             for k in ("tokens", "targets")}
    if cfg.is_encdec:
        batch["frames"] = rs.randn(2, 12, cfg.d_model).astype(np.float32)
    else:
        batch["frontend"] = rs.randn(2, cfg.n_frontend_tokens,
                                     cfg.d_model).astype(np.float32)
    return batch


def _init_pair(arch, seed=0):
    """(cfg_j, cfg_t, the reference's weights, the port's copy): an
    encoder-decoder config's ``init_encdec``, else ``init_lm``."""
    cfg_j, cfg_t = _cfgs(arch)
    init = jed.init_encdec if cfg_j.is_encdec else jlm.init_lm
    pj = jax.jit(functools.partial(init, cfg=cfg_j))(
        jax.random.PRNGKey(seed))
    return cfg_j, cfg_t, pj, params_from_jax(
        jax.tree_util.tree_map(np.asarray, pj))


def test_prefill_and_serve_steps():
    """The prefill step is ``lm_forward``'s logits, without gradient; the
    serve step is ``lm_decode_step``. The frontend and encoder-decoder
    branches (once ROADMAP item 6) against the reference's ``prefill`` and
    ``serve`` bodies (``steps.py:285–293``, ``:301–305``): paligemma's
    ``lm_forward(frontend=)`` and ``lm_decode_step``, whisper's ``encode``
    + ``decode_train`` and two ``encdec_decode_step``s over
    ``init_dec_cache``."""
    cfg = torch_configs.get("qwen3_4b").reduced()
    params = tlm.init_lm(torch.Generator().manual_seed(0), cfg)
    t = torch.from_numpy(_batches(cfg.vocab, 1)[0][0])
    settings = tsteps.StepSettings()
    logits = tsteps.make_prefill_step(cfg, settings)(params, {"tokens": t})
    assert not logits.requires_grad
    assert torch.equal(logits, tlm.lm_forward(params, cfg, t)[0])
    caches = tlm.init_lm_cache(cfg, B, 4)
    got, _ = tsteps.make_serve_step(cfg)(params, t[:, 0], caches, 0)
    want, _ = tlm.lm_decode_step(params, cfg, t[:, 0],
                                 tlm.init_lm_cache(cfg, B, 4), 0)
    assert torch.equal(got, want)
    for arch in ("paligemma_3b", "whisper_base"):
        cfg_j, cfg_t, pj, pt = _init_pair(arch)
        nb = _frontend_and_encdec_batch(cfg_t)
        bj = {k: jnp.asarray(v) for k, v in nb.items()}
        bt = {k: torch.from_numpy(v) for k, v in nb.items()}
        logits = tsteps.make_prefill_step(cfg_t, settings)(pt, bt)
        assert not logits.requires_grad
        if cfg_j.is_encdec:
            enc = jax.jit(functools.partial(jed.encode, cfg=cfg_j))(
                pj, frames=bj["frames"])
            want = jax.jit(functools.partial(jed.decode_train, cfg=cfg_j))(
                pj, enc=enc, tokens=bj["tokens"])
            cj = jed.init_dec_cache(pj, cfg_j, enc, 2, 6)
            ct = ted.init_dec_cache(pt, cfg_t, ted.encode(pt, cfg_t,
                                                          bt["frames"]), 2, 6)
            dec_j = jed.encdec_decode_step
        else:
            want = jax.jit(functools.partial(jlm.lm_forward, cfg=cfg_j))(
                pj, tokens=bj["tokens"], frontend=bj["frontend"])[0]
            assert logits.shape[1] == 6 + cfg_t.n_frontend_tokens
            cj = jlm.init_lm_cache(cfg_j, 2, 6)
            ct = tlm.init_lm_cache(cfg_t, 2, 6)
            dec_j = jlm.lm_decode_step
        dec_j = jax.jit(functools.partial(dec_j, cfg=cfg_j))
        np.testing.assert_allclose(logits.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
        serve_t = tsteps.make_serve_step(cfg_t)
        for t in range(2):
            lj, cj = dec_j(pj, token=bj["tokens"][:, t], caches=cj,
                           cur_index=jnp.asarray(t))
            lt, ct = serve_t(pt, bt["tokens"][:, t], ct, t)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["paligemma_3b", "whisper_base"])
def test_train_step_frontend_and_encdec_branches(arch):
    """Two steps of ``make_train_step`` on a batch with a ``frontend``
    (paligemma: ``lm_loss(frontend=)``) or ``frames`` (whisper:
    ``encdec_loss``) against the reference's composed step on the same
    batch: loss, ce and grad norm each step, and the params after."""
    cfg_j, cfg_t, pj, pt = _init_pair(arch)
    nb = _frontend_and_encdec_batch(cfg_t)
    settings = dict(SETTINGS)
    opt_j, step_j = _ref_step(cfg_j, jsteps.StepSettings(**settings))
    step_t, opt_t = tsteps.make_train_step(cfg_t,
                                           tsteps.StepSettings(**settings))
    sj, st = opt_j.init(pj), opt_t.init(pt)
    for step in range(2):
        pj, sj, mj = step_j(pj, sj, jnp.asarray(step, jnp.int32),
                            {k: jnp.asarray(v) for k, v in nb.items()})
        pt, st, mt = step_t(pt, st, step,
                            {k: torch.from_numpy(v) for k, v in nb.items()})
        for k in ("loss", "grad_norm", "ce"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), **TOL)
    _assert_trees_close(pt, pj)


def test_train_loop_trains_whisper_on_frames():
    """``train_loop`` on reduced whisper (``init_encdec``'s weights from
    seed 0, batches of frames, tokens and targets): three steps whose
    losses and grad norms are the reference's step, from the same
    weights on the same batches, within 1e-5."""
    _, cfg = _cfgs("whisper_base")
    cfg_j = _cfgs("whisper_base")[0]
    batches = [{k: torch.from_numpy(v) for k, v in
                _frontend_and_encdec_batch(cfg, seed=10 + i).items()
                if k != "frontend"} for i in range(3)]
    settings = tsteps.StepSettings(**SETTINGS)
    _, _, hist = ttrain.train_loop(cfg, settings, 3, batches, device="cpu")
    opt, step_fn = _ref_step(cfg_j, jsteps.StepSettings(**SETTINGS))
    pj = _to_jax(ted.init_encdec(torch.Generator().manual_seed(0), cfg))
    sj = opt.init(pj)
    for step, b in enumerate(batches):
        pj, sj, met = step_fn(pj, sj, jnp.asarray(step, jnp.int32),
                              {k: jnp.asarray(v.numpy())
                               for k, v in b.items()})
        assert hist[step]["step"] == step
        np.testing.assert_allclose(hist[step]["loss"], float(met["loss"]),
                                   **TOL)
        np.testing.assert_allclose(hist[step]["grad_norm"],
                                   float(met["grad_norm"]), **TOL)


def test_cli_refuses_whisper_as_the_reference_cannot_run_it(monkeypatch,
                                                            capsys):
    """A kept reference behaviour: the training CLI streams tokens and
    targets only, and an encoder-decoder loss needs frames. The
    reference's CLI fails inside its loss on the missing ``frames`` key;
    the port's exits before any step, naming what is missing."""
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "whisper_base",
                                      "--reduced", "--steps", "1",
                                      "--batch", "2", "--seq", "8"])
    with pytest.raises(KeyError, match="frames"):
        jtrain.main()
    with pytest.raises(SystemExit, match="trains on frames"):
        ttrain.main(["--arch", "whisper_base", "--reduced", "--device",
                     "cpu", "--steps", "1", "--batch", "2", "--seq", "8"])


# ------------------------------------------------------------ faults ----

def test_watchdog_and_injector_match_reference():
    """Scripted calls through both packages' ``StepWatchdog``: outputs,
    restarts, the budget, the NaN screen (and ``nan_is_failure=False``),
    ``reset_on_success``; ``FailureInjector`` fires once per step."""
    losses = [1.0, float("nan"), 2.0, float("inf"), float("nan"), 3.0]

    def script(fault, **cfg):
        wd = fault.StepWatchdog(fault.WatchdogConfig(max_restarts=2, **cfg))
        events = []
        for x in losses:
            try:
                out = wd.run(lambda a, b: (a, {"loss": b}), 7, x,
                             loss_of=lambda o: o[1]["loss"])
                events.append(("ok", out[0], wd.restarts))
            except fault.StepFailure as e:
                events.append(("fail", str(e), wd.record_failure(),
                               wd.restarts))
        return events, len(wd.step_times)

    for cfg in ({}, {"reset_on_success": True}, {"nan_is_failure": False}):
        assert script(tfault, **cfg) == script(jfault, **cfg)
    assert issubclass(tfault.StepFailure, RuntimeError)
    assert dataclasses.asdict(tfault.WatchdogConfig()) == \
        dataclasses.asdict(jfault.WatchdogConfig())
    inj = tfault.FailureInjector(fail_at=(1, 3))
    fired = []
    for step in (0, 1, 1, 2, 3, 3):
        try:
            inj.maybe_fail(step)
        except tfault.StepFailure as e:
            fired.append(str(e))
    assert fired == ["injected failure at step 1",
                     "injected failure at step 3"]


class _Replayable:
    """An iterable whose ``iter()`` restarts the seed-5 stream (the first
    ``n`` batches of ``token_batches``, drawn once)."""

    def __init__(self, vocab, n=12):
        self.batches = [tuple(torch.from_numpy(a) for a in b)
                        for b in _batches(vocab, n)]

    def __iter__(self):
        return ({"tokens": t, "targets": y} for t, y in self.batches)


@pytest.fixture(scope="module")
def fault_setup():
    cfg_j, cfg_t = _cfgs("qwen3_4b")
    return (cfg_j, cfg_t, tsteps.StepSettings(**SETTINGS),
            _Replayable(cfg_t.vocab))


def test_train_loop_recovers_from_injected_failures(tmp_path, fault_setup):
    """tests/test_fault_tolerance.py's first scenario on the port: failures
    at steps 6 and 9 with checkpoints every 4 give the uninterrupted
    run's losses (bit for bit here), with 2 restarts; the uninterrupted
    run's losses and grad norms are the reference loop's within 1e-5,
    from the same initial weights."""
    cfg_j, cfg, settings, data = fault_setup
    p0, _, hist_ref = ttrain.train_loop(cfg, settings, 12, data,
                                        device="cpu", seed=0)
    init = tlm.init_lm(torch.Generator().manual_seed(0), cfg)
    ref = _ref_loop(cfg_j, jsteps.StepSettings(**SETTINGS), _to_jax(init),
                    [tuple(t.numpy() for t in b) for b in data.batches], 12)
    for a, b in zip(hist_ref, ref):
        assert a["step"] == b["step"]
        np.testing.assert_allclose(a["loss"], b["loss"], **TOL)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], **TOL)
    ckpt = CheckpointManager(str(tmp_path / "ft"), keep=3)
    wd = tfault.StepWatchdog(tfault.WatchdogConfig(max_restarts=5))
    p1, _, hist = ttrain.train_loop(
        cfg, settings, 12, data, ckpt=ckpt, ckpt_every=4,
        injector=tfault.FailureInjector(fail_at=(6, 9)), watchdog=wd,
        device="cpu")
    assert wd.restarts == 2
    # replayed steps append again: 0-5, 4-8 after the first restore, 8-11
    assert [h["step"] for h in hist] == [*range(6), *range(4, 9),
                                         *range(8, 12)]
    assert {h["step"]: h for h in hist} == {h["step"]: h for h in hist_ref}
    for a, b in zip(pytree.tree_leaves(p0), pytree.tree_leaves(p1)):
        assert torch.equal(a, b)


def test_train_loop_budget_exhausted_raises(tmp_path, fault_setup):
    _, cfg, settings, data = fault_setup

    class AlwaysFail(tfault.FailureInjector):
        def maybe_fail(self, step):
            if step == 2:
                raise tfault.StepFailure("permanent")

    wd = tfault.StepWatchdog(tfault.WatchdogConfig(max_restarts=2))
    with pytest.raises(tfault.StepFailure, match="permanent"):
        ttrain.train_loop(cfg, settings, 5, data,
                          ckpt=CheckpointManager(str(tmp_path / "b"), keep=2),
                          ckpt_every=1, injector=AlwaysFail(), watchdog=wd,
                          device="cpu")
    assert wd.restarts == 3
    with pytest.raises(tfault.StepFailure, match="injected"):
        ttrain.train_loop(cfg, settings, 3, data, device="cpu",
                          injector=tfault.FailureInjector(fail_at=(1,)))


def test_train_loop_resumes_from_checkpoint(tmp_path, fault_setup):
    """A second loop on the same directory resumes at step 4 and runs 4
    steps, on the losses of one uninterrupted 8-step run."""
    _, cfg, settings, data = fault_setup
    ckpt = CheckpointManager(str(tmp_path / "elastic"), keep=2)
    _, _, h1 = ttrain.train_loop(cfg, settings, 4, data, ckpt=ckpt,
                                 ckpt_every=2, device="cpu")
    _, _, h2 = ttrain.train_loop(cfg, settings, 8, data, ckpt=ckpt,
                                 ckpt_every=4, device="cpu")
    assert h2[0]["step"] == 4 and len(h2) == 4
    _, _, whole = ttrain.train_loop(cfg, settings, 8, data, device="cpu")
    assert h1 + h2 == whole


# ------------------------------------------------------------ loader ----

def test_sharded_loader_prefetch_and_order():
    """tests/test_data.py:58–76 on both packages: order kept; a batch on
    the target device passes through as the same tensor."""
    got = [int(b["x"][0]) for b in ShardedLoader(
        iter([{"x": torch.full((2,), i)} for i in range(5)]), prefetch=2)]
    ref = [int(b["x"][0]) for b in JaxLoader(
        iter([{"x": jnp.full((2,), i)} for i in range(5)]), prefetch=2)]
    assert got == ref == [0, 1, 2, 3, 4]
    xs = [{"x": torch.arange(3) + i} for i in range(3)]
    placed = list(ShardedLoader(iter(xs), device="cpu", prefetch=1))
    assert all(a["x"] is b["x"] for a, b in zip(placed, xs))


def test_sharded_loader_propagates_errors():
    def gen():
        yield {"x": torch.zeros(2)}
        raise ValueError("boom")

    loader = ShardedLoader(gen(), prefetch=1)
    next(loader)
    with pytest.raises(ValueError, match="boom"):
        next(loader)


# --------------------------------------------------------------- CLI ----

def test_cli_prints_the_reference_lines(capsys):
    out = ttrain.main(["--arch", "qwen3_4b", "--reduced", "--device", "cpu",
                       "--steps", "3", "--batch", "2", "--seq", "16"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert re.fullmatch(r"step     0  loss \d+\.\d{4}  gnorm \d+\.\d{3}",
                        lines[0])
    assert re.fullmatch(r"step     2  loss \d+\.\d{4}  gnorm \d+\.\d{3}",
                        lines[1])
    assert re.fullmatch(r"total \d+\.\ds; final loss \d+\.\d{4}", lines[2])
    assert [h["step"] for h in out["history"]] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    flags = {a.option_strings[0] for a in ttrain.build_parser()._actions
             if a.option_strings} - {"-h"}
    assert flags == {"--arch", "--reduced", "--steps", "--batch", "--seq",
                     "--lr", "--microbatches", "--ckpt-dir", "--ckpt-every",
                     "--log-every", "--device", "--mesh"}


def test_cli_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3_4b", "--reduced", "--steps", "1"], capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr


# ---------------------------------------------------- reference cycle ----

def test_served_model_is_freed_by_del(monkeypatch):
    """An engine, an in-flight scheduler and a capturing ledger over a
    reduced model, the ledger's captures timed by ``chip_smoke.py``'s
    ``timed_captures``: with the collector off, ``del`` alone frees the
    model's weights (no reference cycle holds them)."""
    import chip_smoke
    from repro_torch.launch.engine import (EngineConfig, MultiRateEngine,
                                           lm_depth_model)
    from repro_torch.launch.refinery import ResidualLedger
    from repro_torch.launch.scheduler import InflightScheduler
    from repro_torch.launch.workload import poisson_trace, replay_scheduler

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cfg = dataclasses.replace(torch_configs.get("qwen3_4b").reduced(),
                              n_layers=4)
    prompts = np.random.RandomState(0).randint(0, cfg.vocab, (6, 8))
    gc.collect()
    gc.disable()
    try:
        params = tlm.init_lm(torch.Generator().manual_seed(0), cfg)
        alive = weakref.ref(params["embed"]["table"])
        model = lm_depth_model(params, cfg, solver="euler", fused=True,
                               refinable=True, rank=4)
        ecfg = EngineConfig(buckets=(2, 4, 8), tol=1e-6, max_batch=4,
                            solver="euler", controller="embedded",
                            fused=True)
        ledger = ResidualLedger(model, capacity=16, capture_rate=1.0, seed=0)
        sched = InflightScheduler(model, ecfg, slots=2, seg=1, ledger=ledger)
        with torch.no_grad(), chip_smoke.timed_captures(ledger) as stats:
            report = replay_scheduler(sched, poisson_trace(
                list(prompts.astype(np.int32)), rate=0.25, seed=0))
        engine = MultiRateEngine(model, ecfg)
        with torch.no_grad():
            engine.run(prompts[:4].astype(np.int32))
        assert ledger.fill and stats["ms"]
        assert "capture_pool" not in vars(ledger)
        del params, model, ledger, sched, engine, report, stats
        assert alive() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("spec", ["2x2", "1x3"])
def test_cli_refuses_a_mesh_that_is_not_the_world(monkeypatch, spec):
    """``--mesh DxM`` must match torchrun's WORLD_SIZE, as ``serve --mesh``
    must match the visible cards: refused before any process group or
    step, naming both numbers."""
    monkeypatch.setenv("WORLD_SIZE", "1")
    d, m = (int(x) for x in spec.split("x"))
    with pytest.raises(SystemExit, match=rf"asks for {d * m} devices; the "
                                         r"run has 1 processes"):
        ttrain.main(["--arch", "qwen3_4b", "--reduced", "--device", "cpu",
                     "--mesh", spec])
