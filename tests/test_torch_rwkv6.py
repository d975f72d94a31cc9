"""The port's WKV6 recurrence (repro_torch/kernels/rwkv6_scan) and RWKV-6
layers (repro_torch/nn/rwkv6.py, the channel mix of repro_torch/nn/ffn.py)
held against the JAX package on the CPU.

On a CPU tensor the recurrence's wrapper runs its plain PyTorch version
(``ref.py``); the CUDA kernel is held against that same plain version on
the card by ``chip_smoke.py``. The recurrence mirrors
tests/test_kernels.py's ``test_wkv6_kernel_sweep`` (plus a D = 64 case
with ragged T) against the Pallas kernel in interpret mode, to rtol 1e-4
and an absolute bound of 1e-6 of the largest output: the state does not
shrink under decays near 1, so outputs grow with T and an output near 0
has a large relative error from the other summation order alone. The
layers carry the JAX package's weights with ``params_from_jax`` and hold
to the reference tests' fp32 bound rtol 2e-4 / atol 2e-5
(tests/test_nn_layers.py, tests/test_kernels.py). Inputs come from numpy
RandomState.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_isolation import port_module_isolation  # noqa: F401
from repro.kernels.rwkv6_scan.ops import wkv6 as jax_wkv6
from repro.nn import ffn as jffn
from repro.nn import rwkv6 as jrw
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.rwkv6_scan.ops import wkv6
from repro_torch.kernels.rwkv6_scan.ref import (wkv6_scan_backward_ref,
                                                wkv6_scan_ref)
from repro_torch.nn import ffn as tffn
from repro_torch.nn import rwkv6 as trw

LAYER_TOL = dict(rtol=2e-4, atol=2e-5)


def _to_torch(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _operands(rs, B, T, H, D):
    """r, k, v, u normal; w = sigmoid(normal) in (0, 1), as the sweep."""
    r, k, v = (rs.randn(B, T, H, D).astype(np.float32) for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rs.randn(B, T, H, D)))).astype(np.float32)
    u = (0.3 * rs.randn(H, D)).astype(np.float32)
    return r, k, v, w, u


def _close_scaled(out, ref):
    """rtol 1e-4 and an absolute bound of 1e-6 of the largest output."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=1e-4,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("B,T,H,D,chunk", [
    (1, 8, 1, 8, 8),         # single chunk
    (2, 16, 2, 8, 8),        # two chunks: state carry across chunks
    (1, 20, 2, 8, 8),        # T not a chunk multiple
    (1, 32, 1, 16, 16),
    (2, 77, 2, 64, 32),      # RWKV6's head size, ragged T
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_matches_pallas_kernel(B, T, H, D, chunk, dtype):
    jdt = getattr(jnp, dtype)
    ops = [jnp.asarray(a).astype(jdt)
           for a in _operands(np.random.RandomState(20), B, T, H, D)]
    ref = jax_wkv6(*ops, chunk=chunk, interpret=True)
    out = wkv6(*(tensor_from_numpy(np.asarray(a)) for a in ops))
    assert out.dtype == torch.float32 and out.shape == (B, T, H, D)
    _close_scaled(out.numpy(), ref)
    assert LAUNCHES["rwkv6_scan"] == 0   # the CPU takes the plain version


@pytest.mark.parametrize("T", [0, 1, 19])
def test_wkv6_state_in_and_out_matches_jax(T):
    """S0 and S_T against the reference's ``_wkv_with_initial_state``;
    a zero start against its ``wkv6_scan_ref``. T = 0 passes S0 through."""
    B, H, D = 2, 3, 16
    rs = np.random.RandomState(21)
    ops = _operands(rs, B, T, H, D)
    S0 = rs.randn(B, H, D, D).astype(np.float32)
    oj, Sj = jrw._wkv_with_initial_state(*map(jnp.asarray, ops),
                                         jnp.asarray(S0))
    ot, St = wkv6(*map(torch.from_numpy, ops), torch.from_numpy(S0),
                  want_state=True)
    assert ot.shape == (B, T, H, D) and St.shape == (B, H, D, D)
    if T:
        _close_scaled(ot.numpy(), oj)
    _close_scaled(St.numpy(), Sj)
    oj, Sj = jrw.wkv6_scan_ref(*map(jnp.asarray, ops))
    ot, St = wkv6(*map(torch.from_numpy, ops), want_state=True)
    if T:
        _close_scaled(ot.numpy(), oj)
    np.testing.assert_allclose(St.numpy(), np.asarray(Sj), rtol=1e-4,
                               atol=1e-6 * max(np.abs(np.asarray(Sj)).max(),
                                               1.0))
    assert LAUNCHES["rwkv6_scan"] == 0


def _tree_spec(tree):
    return [(jax.tree_util.keystr(path), tuple(leaf.shape), str(leaf.dtype)
             .replace("torch.", ""))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_trees_match_jax(dtype):
    """rwkv6_init and rwkv_channel_mix_init draw the reference's tree of
    paths, shapes and dtypes; ``lead`` stacks every leaf, as the
    reference vmaps a group's init."""
    d, H, r, f = 32, 4, 4, 48
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    gen = torch.Generator().manual_seed(0)
    pairs = [(jrw.rwkv6_init(jax.random.PRNGKey(0), d, H, r, jdt),
              lambda **kw: trw.rwkv6_init(gen, d, H, r, tdt, **kw)),
             (jffn.rwkv_channel_mix_init(jax.random.PRNGKey(1), d, f, jdt),
              lambda **kw: tffn.rwkv_channel_mix_init(gen, d, f, tdt, **kw))]
    for ref, own in pairs:
        spec = _tree_spec(jax.tree_util.tree_map(np.asarray, ref))
        assert _tree_spec(own()) == spec
        assert _tree_spec(own(lead=(3,))) == [(p, (3, *s), t)
                                              for p, s, t in spec]
    p = trw.rwkv6_init(gen, d, H, r, lead=(2,))
    # decay base w0 = linspace(-6, -1): w in (0.69, 0.9975) at a zero lora
    np.testing.assert_allclose(p["w0"][1].numpy(),
                               np.linspace(-6.0, -1.0, d), rtol=1e-6)


@pytest.fixture(scope="module")
def layer():
    d, H = 32, 4
    pj = jrw.rwkv6_init(jax.random.PRNGKey(6), d, H, lora_rank=8)
    x = np.random.RandomState(22).randn(2, 16, d).astype(np.float32)
    return pj, _to_torch(pj), x, H


def test_time_mix_matches_jax(layer):
    pj, pt, x, H = layer
    oj, (xj, Sj) = jrw.rwkv6_time_mix(pj, jnp.asarray(x), H)
    ot, (xt, St) = trw.rwkv6_time_mix(pt, torch.from_numpy(x), H)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **LAYER_TOL)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_allclose(St.numpy(), np.asarray(Sj), **LAYER_TOL)
    # without a final state the output is the same, and S_T is None
    ot2, (_, none) = trw.rwkv6_time_mix(pt, torch.from_numpy(x), H,
                                        want_state=False)
    assert none is None and torch.equal(ot2, ot)


def test_time_mix_pieces_match_jax(layer):
    """Token shift, the five data-dependent mixes and the fp32 decay."""
    pj, pt, x, _ = layer
    last = np.random.RandomState(23).randn(2, x.shape[-1]).astype(np.float32)
    sj = jrw._token_shift(jnp.asarray(x), jnp.asarray(last))
    st = trw._token_shift(torch.from_numpy(x), torch.from_numpy(last))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    mj = jrw._mix_inputs(pj, jnp.asarray(x), sj)
    mt = trw._mix_inputs(pt, torch.from_numpy(x), st)
    assert list(mt) == list(jrw.MIXES) == list(trw.MIXES)
    for name in trw.MIXES:
        np.testing.assert_allclose(mt[name].numpy(), np.asarray(mj[name]),
                                   **LAYER_TOL)
    wt = trw._decay(pt, mt["w"])
    assert wt.dtype == torch.float32
    np.testing.assert_allclose(wt.numpy(), np.asarray(jrw._decay(pj, mj["w"])),
                               **LAYER_TOL)


def test_time_mix_streaming_matches_jax(layer):
    """Two halves with the carried (x_last, S) state == the reference's
    full pass, and each half's state == the reference's."""
    pj, pt, x, H = layer
    full, _ = jrw.rwkv6_time_mix(pj, jnp.asarray(x), H)
    hj, stj = jrw.rwkv6_time_mix(pj, jnp.asarray(x[:, :7]), H)
    h1, st = trw.rwkv6_time_mix(pt, torch.from_numpy(x[:, :7]), H)
    np.testing.assert_allclose(st[1].numpy(), np.asarray(stj[1]),
                               **LAYER_TOL)
    h2, st2 = trw.rwkv6_time_mix(pt, torch.from_numpy(x[:, 7:]), H, state=st)
    _, stj2 = jrw.rwkv6_time_mix(pj, jnp.asarray(x[:, 7:]), H, state=stj)
    merged = torch.cat([h1, h2], dim=1)
    np.testing.assert_allclose(merged.numpy(), np.asarray(full), **LAYER_TOL)
    np.testing.assert_allclose(st2[1].numpy(), np.asarray(stj2[1]),
                               **LAYER_TOL)


def test_decode_step_matches_jax(layer):
    """Token by token through ``rwkv6_decode_step`` == the reference's
    full pass (tests/test_nn_layers.py::test_rwkv6_decode_step_matches_full)."""
    pj, pt, x, H = layer
    full, _ = jrw.rwkv6_time_mix(pj, jnp.asarray(x[:1, :6]), H)
    state, outs = None, []
    for t in range(6):
        o, state = trw.rwkv6_decode_step(pt, torch.from_numpy(x[:1, t]),
                                         state, H)
        outs.append(o)
    np.testing.assert_allclose(torch.stack(outs, dim=1).numpy(),
                               np.asarray(full), **LAYER_TOL)
    oj, sj = jrw.rwkv6_decode_step(pj, jnp.asarray(x[:1, 0]), None, H)
    ot, st = trw.rwkv6_decode_step(pt, torch.from_numpy(x[:1, 0]), None, H)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **LAYER_TOL)
    np.testing.assert_allclose(st[1].numpy(), np.asarray(sj[1]), **LAYER_TOL)


def test_channel_mix_matches_jax():
    d, f = 32, 48
    pj = jffn.rwkv_channel_mix_init(jax.random.PRNGKey(18), d, f)
    x = np.random.RandomState(24).randn(2, 9, d).astype(np.float32)
    x_prev = np.concatenate([np.zeros_like(x[:, :1]), x[:, :-1]], axis=1)
    yj = jffn.rwkv_channel_mix(pj, jnp.asarray(x), jnp.asarray(x_prev))
    yt = tffn.rwkv_channel_mix(_to_torch(pj), torch.from_numpy(x),
                               torch.from_numpy(x_prev))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **LAYER_TOL)


def test_time_mix_bf16_matches_jax():
    """bf16 weights and activations, as served. Both sides round to bf16
    after every op of the activation type, but XLA may keep an fp32
    intermediate inside a fused elementwise chain where PyTorch rounds
    (and the reverse), so single elements differ by a few bf16 steps
    (2^-8 of the value) that the projections then mix. The bound: every
    element within 2 bf16 steps of the largest output, and the mean
    difference under a quarter of a step (measured: 1.04 and 0.18)."""
    d, H = 64, 4
    pj = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16),
        jrw.rwkv6_init(jax.random.PRNGKey(7), d, H, lora_rank=8))
    x = np.random.RandomState(25).randn(2, 16, d).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    oj, (_, Sj) = jrw.rwkv6_time_mix(pj, xj, H)
    ot, (_, St) = trw.rwkv6_time_mix(_to_torch(pj),
                                     tensor_from_numpy(np.asarray(xj)), H)
    assert ot.dtype == torch.bfloat16 and St.dtype == torch.float32
    ref = np.asarray(oj, np.float32)
    step = np.abs(ref).max() * 2.0 ** -8
    diff = np.abs(ot.float().numpy() - ref)
    assert diff.max() <= 2 * step, (diff.max(), step)
    assert diff.mean() <= 0.25 * step, (diff.mean(), step)


class _CudaLike(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the card-only
    branch of the wrapper without a card."""

    @property
    def device(self):
        return torch.device("cuda")


def test_wkv6_raises_where_it_has_no_kernel():
    x, u = torch.zeros(1, 5, 2, 16), torch.zeros(2, 16)
    meta = [t.to("meta") for t in (x, x, x, x, u)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        wkv6(*meta)
    # on the card: a dtype or head size the kernel lacks raises before any
    # build or launch
    with pytest.raises(TypeError, match="float64"):
        d = x.double().as_subclass(_CudaLike)
        wkv6(d, d, d, d, u.as_subclass(_CudaLike))
    with pytest.raises(ValueError, match="head size 48"):
        y = torch.zeros(1, 5, 2, 48).as_subclass(_CudaLike)
        wkv6(y, y, y, y, torch.zeros(2, 48).as_subclass(_CudaLike))
    with pytest.raises(ValueError, match="one device"):
        c = x.as_subclass(_CudaLike)
        wkv6(c, c, c, c, u)
    with pytest.raises(ValueError, match="one \\(B, T, H, D\\) shape"):
        wkv6(x, x, x, x[:, :4], u)
    with pytest.raises(ValueError, match="u \\(3, 16\\)"):
        wkv6(x, x, x, x, torch.zeros(3, 16))
    assert LAUNCHES["rwkv6_scan"] == 0


def _fake_launch_backward(grads, dS0, states, part, go, gS, r, k, v, w, u,
                          S0):
    """The backward kernel's outputs from the plain version: dr, dk, dv,
    dw and dS0, and u's gradient as the only nonzero partial, at the time
    row the wrapper sums last (so its sums return it exactly)."""
    want = wkv6_scan_backward_ref(go, gS, r, k, v, w, u.float(), S0)
    for out, x in zip(grads, want):
        out.copy_(x)
    if dS0 is not None:
        dS0.copy_(want[5])
    part.zero_()
    part[0, -1] = want[4]


@contextlib.contextmanager
def _cuda_implementation_on_the_cpu(monkeypatch, calls):
    """The operators' CUDA implementations for CPU tensors while open,
    each launch standing in for its kernel with the plain version (each
    launch's kind, "forward" or "backward", and shape appended to
    ``calls``)."""
    from repro_torch.kernels.rwkv6_scan import ops

    def fake_launch(o, r, k, v, w, u, S0, S_T):
        calls.append(("forward", r.shape))
        o_ref, s_ref = wkv6_scan_ref(r, k, v, w, u, S0)
        o.copy_(o_ref)
        if S_T is not None:
            S_T.copy_(s_ref)

    def fake_launch_backward(*args):
        calls.append(("backward", args[6].shape))
        _fake_launch_backward(*args)

    monkeypatch.setattr(ops, "launch", fake_launch)
    monkeypatch.setattr(ops, "launch_backward", fake_launch_backward)
    with ops._wkv6.set_kernel_enabled("cpu", False), \
            ops._wkv6_backward.set_kernel_enabled("cpu", False):
        yield


def _assert_grads_close(got, want):
    """Each gradient within 1e-6 of the largest of autograd's for that
    input: the backward operator makes autograd's sums, in its order as
    far as it can, so only a reordered reduction may round apart."""
    for name, x, y in zip("rkvwuS", got, want):
        if y is None:
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, name
        err = (x.float() - y.float()).abs().max()
        assert err <= 1e-6 * y.float().abs().max(), (name, float(err))


@pytest.mark.parametrize("with_s0,want_state", [(False, False),
                                                (True, False), (True, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_route_takes_the_plain_versions_gradient(
        monkeypatch, with_s0, want_state, dtype):
    """The operator ``repro_torch::wkv6`` as the card runs it: the
    kernel's forward (its CUDA implementation, the launch standing in for
    the kernel on the CPU) and, where autograd needs a backward, the
    backward operator's CUDA implementation (its launch standing in for
    the backward kernel with the plain version's gradients). o (and S_T),
    and the gradients of r, k, v, w, u and S0 through o and S_T, equal
    autograd of the plain loop's bit for bit (bf16 r, k, v, u as the
    serving path gives them, fp32 w); every input gets a nonzero
    gradient; the forward kernel launched once per forward and never in
    the backward, the backward kernel once per backward. Without S0 the
    gradient is ``jax.grad``'s through the reference's scan within the
    layer tolerance."""
    from repro.kernels.rwkv6_scan.ref import wkv6_ref as jax_ref
    calls = []
    rs = np.random.RandomState(12)
    B, T, H, D = 2, 7, 3, 8
    r, k, v, w, u = _operands(rs, B, T, H, D)
    s0 = rs.randn(B, H, D, D).astype(np.float32) if with_s0 else None
    xdt = getattr(torch, dtype)
    ins = [torch.from_numpy(x).to(xdt) for x in (r, k, v)] + [
        torch.from_numpy(w), torch.from_numpy(u).to(xdt)] + (
        [torch.from_numpy(s0)] if with_s0 else [None])
    mine = [None if t is None else t.clone().requires_grad_() for t in ins]
    ref = [None if t is None else t.clone().requires_grad_() for t in ins]
    with _cuda_implementation_on_the_cpu(monkeypatch, calls):
        out = wkv6(*mine, want_state=want_state)
        want = wkv6_scan_ref(*ref)
        outs = out if want_state else (out,)
        for x, y in zip(outs, want):
            assert torch.equal(x, y)
        gs = [torch.from_numpy(rs.randn(*x.shape).astype(np.float32))
              for x in outs]
        assert calls == [("forward", (B, T, H, D))]
        torch.autograd.backward(list(outs), gs)
        torch.autograd.backward(list(want[:len(outs)]), gs)
    assert calls == [("forward", (B, T, H, D)), ("backward", (B, T, H, D))]
    for x, y in zip(mine, ref):
        if x is None:
            continue
        assert x.grad.dtype == x.dtype and torch.equal(x.grad, y.grad)
        assert x.grad.float().abs().max() > 0
    if not with_s0 and dtype == "float32":
        jg = jax.grad(lambda *a: jnp.sum(jax_ref(*a) * gs[0].numpy()),
                      argnums=(0, 1, 2, 3, 4))(r, k, v, w, u)
        for x, y in zip(mine, jg):
            np.testing.assert_allclose(x.grad.numpy(), np.asarray(y),
                                       **LAYER_TOL)


def test_training_route_through_the_final_state_alone(monkeypatch):
    """A loss of S_T alone reaches k, v, w and S0 (r and u only shape o),
    through the operator's CUDA implementation and the backward operator
    as through autograd of the plain loop."""
    rs = np.random.RandomState(13)
    ops_in = [torch.from_numpy(x) for x in _operands(rs, 1, 5, 2, 8)]
    s0 = torch.from_numpy(rs.randn(1, 2, 8, 8).astype(np.float32))
    mine = [t.clone().requires_grad_() for t in ops_in + [s0]]
    ref = [t.clone().requires_grad_() for t in ops_in + [s0]]
    calls = []
    with _cuda_implementation_on_the_cpu(monkeypatch, calls):
        _, S_T = wkv6(*mine, want_state=True)
        S_T.sum().backward()
    wkv6_scan_ref(*ref)[1].sum().backward()
    assert calls == [("forward", (1, 5, 2, 8)), ("backward", (1, 5, 2, 8))]
    for name, x, y in zip("rkvwuS", mine, ref):
        if name in "ru":
            assert x.grad is None or not x.grad.any()
        else:
            assert torch.equal(x.grad, y.grad) and x.grad.abs().max() > 0


@pytest.mark.parametrize("with_s0,want_state", [(False, False),
                                                (True, False), (False, True),
                                                (True, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_operator_matches_the_plain_loop(with_s0, want_state, dtype):
    """On the CPU the operator's forward is ``ref.py``'s loop bit for bit
    (S_T an empty fp32 (0,) when not asked for), and the backward operator
    (``ref.py::wkv6_scan_backward_ref``) is within 1e-6 of autograd of
    the loop, with and without S0 and S_T."""
    rs = np.random.RandomState(17)
    B, T, H, D = 2, 33, 3, 16
    xdt = getattr(torch, dtype)
    r, k, v, w, u = (torch.from_numpy(x) for x in _operands(rs, B, T, H, D))
    ins = [r.to(xdt), k.to(xdt), v.to(xdt), w, u.to(xdt),
           torch.from_numpy(rs.randn(B, H, D, D).astype(np.float32))
           if with_s0 else None]
    o, S_T = torch.ops.repro_torch.wkv6(*ins, want_state)
    o_ref, s_ref = wkv6_scan_ref(*ins)
    assert torch.equal(o, o_ref)
    assert torch.equal(S_T, s_ref) if want_state else \
        (S_T.shape == (0,) and S_T.dtype == torch.float32)
    go = torch.from_numpy(rs.randn(B, T, H, D).astype(np.float32))
    gS = torch.from_numpy(rs.randn(B, H, D, D).astype(np.float32)) \
        if want_state else None
    got = torch.ops.repro_torch.wkv6_backward(go, gS, *ins)
    leaves = [None if t is None else t.clone().requires_grad_() for t in ins]
    outs = wkv6_scan_ref(*leaves)
    torch.autograd.backward([outs[0]] + ([outs[1]] if want_state else []),
                            [go] + ([gS] if want_state else []))
    _assert_grads_close(got, [None if t is None else t.grad for t in leaves])
    if not with_s0:
        assert got[5].shape == (0,)
    assert LAUNCHES["rwkv6_scan"] == 0


def test_backward_operator_matches_jax_grad_of_the_reference():
    """The backward operator against ``jax.grad`` of the reference's
    ``repro/nn/rwkv6.py::wkv6_scan_ref`` (no S0; a loss through o and
    S_T), in fp32 over 32 tokens at RWKV6's head size: every gradient
    within 1e-5 of its largest value."""
    rs = np.random.RandomState(18)
    B, T, H, D = 1, 32, 2, 64
    r, k, v, w, u = _operands(rs, B, T, H, D)
    go = rs.randn(B, T, H, D).astype(np.float32)
    gS = rs.randn(B, H, D, D).astype(np.float32)

    def loss(*a):
        o, S = jrw.wkv6_scan_ref(*a)
        return jnp.sum(o * go) + jnp.sum(S * gS)

    jg = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(r, k, v, w, u)
    got = torch.ops.repro_torch.wkv6_backward(
        *(torch.from_numpy(x) for x in (go, gS, r, k, v, w, u)), None)
    for name, x, y in zip("rkvwu", got, jg):
        y = np.asarray(y)
        err = np.abs(x.numpy() - y).max()
        assert err <= 1e-5 * np.abs(y).max(), (name, err, np.abs(y).max())


@pytest.mark.parametrize("B,T,H,D,with_s0,dtype", [
    (2, 7, 3, 8, False, torch.float32), (1, 1, 2, 16, True, torch.bfloat16),
    (3, 20, 2, 64, True, torch.float32)])
def test_backward_allocates_its_workspace(monkeypatch, B, T, H, D, with_s0,
                                          dtype):
    """The backward operator's CUDA implementation allocates its outputs
    and ``backward_workspace``'s bytes (the dry run's
    ``kernels.WORKSPACE``: a checkpoint of the state every 16 tokens, du's
    partials and their batch sums) and nothing more, its launch standing
    in for the kernel with the plain version's gradients, which it
    returns."""
    from repro_torch.kernels import WORKSPACE
    from repro_torch.kernels.rwkv6_scan import ops
    rs = np.random.RandomState(21)
    r, k, v, w, u = (torch.from_numpy(x) for x in _operands(rs, B, T, H, D))
    ins = [r.to(dtype), k.to(dtype), v.to(dtype), w, u.to(dtype),
           torch.from_numpy(rs.randn(B, H, D, D).astype(np.float32))
           if with_s0 else None]
    go = torch.from_numpy(rs.randn(B, T, H, D).astype(np.float32))
    gS = torch.from_numpy(rs.randn(B, H, D, D).astype(np.float32))
    want = wkv6_scan_backward_ref(go, gS, *ins)
    allocated = []
    empty = torch.empty

    def counted(*args, **kwargs):
        t = empty(*args, **kwargs)
        allocated.append(t.numel() * t.element_size())
        return t

    def fake_launch_backward(*args):
        monkeypatch.setattr(torch, "empty", empty)
        _fake_launch_backward(*args)
        monkeypatch.setattr(torch, "empty", counted)

    monkeypatch.setattr(ops, "launch_backward", fake_launch_backward)
    monkeypatch.setattr(torch, "empty", counted)
    with ops._wkv6_backward.set_kernel_enabled("cpu", False):
        got = torch.ops.repro_torch.wkv6_backward(go, gS, *ins)
    monkeypatch.setattr(torch, "empty", empty)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    outputs = sum(t.numel() * t.element_size() for t in got)
    ws = WORKSPACE[torch.ops.repro_torch.wkv6_backward](go, gS, *ins)
    assert ops.CHECKPOINT_EVERY == 16
    assert ws == ops.backward_workspace(go, gS, *ins) == 4 * (
        B * H * -(-T // 16) * D * D + B * T * H * D + T * H * D)
    assert sum(allocated) - outputs == ws


def test_backward_workspace_at_the_training_shape():
    """At RWKV6's training shape (B 8, T 128, H 32, D 64) the backward's
    workspace is at most an eighth of B H T D^2 floats, one state a token
    (536.9 MB): 8 checkpoints a head, du's partials and their sums, 43.0
    MB."""
    from repro_torch.kernels.rwkv6_scan import ops
    B, T, H, D = 8, 128, 32, 64
    x = torch.empty((B, T, H, D), dtype=torch.bfloat16, device="meta")
    u = torch.empty((H, D), dtype=torch.bfloat16, device="meta")
    ws = ops.backward_workspace(x, None, x, x, x, x.float(), u, None)
    assert ws == 4 * (B * H * 8 * D * D + B * T * H * D + T * H * D)
    assert ws <= 4 * B * H * T * D * D // 8


def _metered_flops(fn, shapes, backward):
    """The dry run's meter (``dryrun._meter_mode``) over ``fn`` on fake
    inputs of ``shapes`` that require grad, with the backward of the
    output's sum if ``backward``."""
    from repro_torch.launch import dryrun
    meter = dryrun._meter_mode()
    with meter:
        ins = [torch.empty(s).requires_grad_() for s in shapes]
        meter.metering = True
        out = fn(*ins)
        if backward:
            out.sum().backward()
    return meter.flops


@pytest.mark.parametrize("backward", [False, True])
def test_meter_counts_the_loops_flops(backward):
    """Under the dry run's meter at T 16, one operator call counts exactly
    the plain loop's FLOPs: 2 B T H D^2 forward, 4 B T H D^2 more in the
    backward (the einsum and its two gradients)."""
    B, T, H, D = 2, 16, 3, 8
    shapes = [(B, T, H, D)] * 4 + [(H, D)]
    got = _metered_flops(lambda *x: wkv6(*x), shapes, backward)
    assert got == _metered_flops(lambda *x: wkv6_scan_ref(*x)[0], shapes,
                                 backward)
    assert got == (6 if backward else 2) * B * T * H * D * D


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_fake_call_launches_nothing(device):
    """On fake tensors (the dry run's) the wrapper, on a CPU or a CUDA
    device, reaches the operator's fake implementation: fp32 o and S_T of
    their shapes, no launch counted; on the CPU (autograd on a fake CUDA
    device needs a card) the backward operator's too, each gradient in its
    input's dtype and the workspace its (B, H, D, D) checkpoints, one every
    16 tokens, du's partials and their sums."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import WORKSPACE
    B, T, H, D = 2, 4096, 4, 64
    with FakeTensorMode():
        x = torch.empty(B, T, H, D, dtype=torch.bfloat16, device=device,
                        requires_grad=device == "cpu")
        u = torch.empty(H, D, dtype=torch.bfloat16, device=device,
                        requires_grad=device == "cpu")
        o, S_T = wkv6(x, x, x, x, u, want_state=True)
        assert o.shape == x.shape and S_T.shape == (B, H, D, D)
        assert o.dtype == S_T.dtype == torch.float32
        assert o.device.type == device
        if device == "cpu":
            dx, du = torch.autograd.grad(o.sum(), (x, u))
            assert dx.dtype == du.dtype == torch.bfloat16
            assert du.shape == (H, D)
            ws = WORKSPACE[torch.ops.repro_torch.wkv6_backward](
                o, None, x, x, x, x, u, None)
            assert ws == 4 * (B * H * (T // 16) * D * D + B * T * H * D
                              + T * H * D)
    assert LAUNCHES["rwkv6_scan"] == 0


CHECKS = ("test_schema", "test_autograd_registration", "test_faketensor")


def test_operators_pass_opcheck():
    """``torch.library.opcheck``'s schema, fake-implementation and
    autograd-registration checks (not its compiled-dispatch one), with and without S0."""
    rs = np.random.RandomState(19)
    ins = [torch.from_numpy(x) for x in _operands(rs, 1, 6, 2, 8)]
    s0 = torch.from_numpy(rs.randn(1, 2, 8, 8).astype(np.float32))
    for S0, want_state in ((None, False), (s0, True)):
        args = [t.clone().requires_grad_() for t in ins]
        torch.library.opcheck(torch.ops.repro_torch.wkv6.default,
                              (*args, S0, want_state), test_utils=CHECKS)
    go = torch.from_numpy(rs.randn(1, 6, 2, 8).astype(np.float32))
    torch.library.opcheck(torch.ops.repro_torch.wkv6_backward.default,
                          (go, None, *ins, s0), test_utils=CHECKS)
