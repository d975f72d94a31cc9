"""The port's RG-LRU scan (repro_torch/kernels/rglru_scan) and Griffin
recurrent block (repro_torch/nn/rglru.py) held against the JAX package
on the CPU.

On a CPU tensor the scan's wrapper runs its plain PyTorch version
(``ref.py``); the CUDA kernel is held against that same plain version,
bit for bit, on the card by ``chip_smoke.py``. The scan mirrors
tests/test_kernels.py's ``test_rglru_kernel_sweep`` (ragged T and W
included) against the Pallas kernel in interpret mode, at its fp32
tolerance rtol 1e-5 / atol 1e-6. The layers carry the JAX package's
weights with ``params_from_jax`` and hold to rtol 2e-4 / atol 1e-5: the
reference scans associatively and the port sequentially, and
tests/test_nn_layers.py holds those two forms to that bound. Inputs come
from numpy RandomState.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_isolation import port_module_isolation  # noqa: F401
from repro.kernels.rglru_scan.ops import rglru_scan as jax_scan
from repro.nn import rglru as jrg
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.rglru_scan.ops import MAX_BATCH, rglru_scan
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_backward_ref,
                                                rglru_scan_ref)
from repro_torch.nn import rglru as trg

LAYER_TOL = dict(rtol=2e-4, atol=1e-5)


def _to_torch(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("B,T,W,chunk,bw", [
    (1, 16, 8, 8, 8),
    (2, 32, 16, 8, 8),       # several chunks and width blocks
    (1, 20, 12, 8, 8),       # ragged T and W
    (3, 64, 128, 16, 128),
    (1, 5, 40, 8, 8),        # T below one stage of the kernel's ring, B 1
    (2, 45, 333, 16, 128),   # ragged T, W past a 32-channel tile, odd rows
    (1, 77, 100, 8, 8),      # T not a multiple of 16 or 32, W % 32 = 4
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_rglru_scan_matches_jax(B, T, W, chunk, bw, dtype):
    rs = np.random.RandomState(8)
    jdt = getattr(jnp, dtype)
    aj = jax.nn.sigmoid(jnp.asarray(rs.randn(B, T, W).astype(np.float32))) \
        .astype(jdt)
    bj = jnp.asarray(rs.randn(B, T, W).astype(np.float32)).astype(jdt)
    ref = jax_scan(aj, bj, chunk=chunk, bw=bw, interpret=True)
    out = rglru_scan(tensor_from_numpy(np.asarray(aj)),
                     tensor_from_numpy(np.asarray(bj)))
    assert out.dtype == torch.float32 and out.shape == (B, T, W)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    assert LAUNCHES["rglru_scan"] == 0   # the CPU takes the plain version


@pytest.fixture(scope="module")
def griffin():
    d, W = 24, 16
    pj = jrg.griffin_recurrent_init(jax.random.PRNGKey(9), d, W)
    x = np.random.RandomState(10).randn(2, 12, d).astype(np.float32)
    return pj, _to_torch(pj), x


def test_rglru_init_tree_and_decay_range(griffin):
    """The port's init draws the reference's tree of shapes and dtypes,
    with a = exp(-8 softplus(Lambda)) in [0.9, 0.999] at r = 1."""
    _, pt, _ = griffin
    own = trg.griffin_recurrent_init(torch.Generator().manual_seed(0), 24, 16)
    flat_own = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: 0, own))[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: 0, pt))[0]
    assert [p for p, _ in flat_own] == [p for p, _ in flat_ref]
    for a, b in zip(jax.tree_util.tree_leaves(own),
                    jax.tree_util.tree_leaves(pt)):
        assert a.shape == b.shape and a.dtype == b.dtype
    a = torch.exp(-8.0 * torch.nn.functional.softplus(own["rglru"]["lam"]))
    assert bool(((a >= 0.9 - 1e-6) & (a <= 0.999 + 1e-6)).all())


def test_gates_match_jax(griffin):
    pj, pt, _ = griffin
    x = np.random.RandomState(11).randn(2, 12, 16).astype(np.float32)
    aj, bj = jrg._gates(pj["rglru"], jnp.asarray(x))
    at, bt = trg._gates(pt["rglru"], torch.from_numpy(x))
    assert at.dtype == bt.dtype == torch.float32
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), **LAYER_TOL)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), **LAYER_TOL)


@pytest.mark.parametrize("with_carry", [False, True])
def test_causal_conv1d_matches_jax(griffin, with_carry):
    pj, pt, _ = griffin
    rs = np.random.RandomState(12)
    x = rs.randn(2, 9, 16).astype(np.float32)
    carry = rs.randn(2, 3, 16).astype(np.float32) if with_carry else None
    yj, cj = jrg.causal_conv1d(pj["conv"], jnp.asarray(x),
                               None if carry is None else jnp.asarray(carry))
    yt, ct = trg.causal_conv1d(pt["conv"], torch.from_numpy(x),
                               None if carry is None
                               else torch.from_numpy(carry))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **LAYER_TOL)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


@pytest.mark.parametrize("with_state", [False, True])
def test_griffin_recurrent_apply_matches_jax(griffin, with_state):
    """The whole recurrent branch, the scan through the port's wrapper,
    from zero or from a carried (conv history, h0) state."""
    pj, pt, x = griffin
    rs = np.random.RandomState(13)
    state_np = (rs.randn(2, 3, 16).astype(np.float32),
                rs.randn(2, 16).astype(np.float32)) if with_state else None
    sj = None if state_np is None else tuple(map(jnp.asarray, state_np))
    st = None if state_np is None else tuple(map(torch.from_numpy, state_np))
    yj, (cj, hj) = jrg.griffin_recurrent_apply(pj, jnp.asarray(x), sj)
    yt, (ct, ht) = trg.griffin_recurrent_apply(pt, torch.from_numpy(x), st)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **LAYER_TOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **LAYER_TOL)
    # the conv history is the last in_rec projections (a matmul)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **LAYER_TOL)
    assert ht.dtype == torch.float32


def test_rglru_apply_matches_pallas_kernel_on_gates(griffin):
    """The port's rglru_apply == the Pallas scan over the reference's own
    gates (tests/test_kernels.py::test_rglru_kernel_matches_module)."""
    pj, pt, _ = griffin
    x = np.random.RandomState(14).randn(2, 24, 16).astype(np.float32)
    a, b = jrg._gates(pj["rglru"], jnp.asarray(x))
    ref = jax_scan(a, b, chunk=8, bw=8, interpret=True)
    y, hT = trg.rglru_apply(pt["rglru"], torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **LAYER_TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(ref)[:, -1],
                               **LAYER_TOL)


class _CudaLike(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the card-only
    branch of the wrapper without a card."""

    @property
    def device(self):
        return torch.device("cuda")


def test_rglru_scan_raises_where_it_has_no_kernel():
    a = torch.zeros(2, 5, 3)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        rglru_scan(a.to("meta"), a.to("meta"))
    with pytest.raises(TypeError, match="float64"):
        d = a.double().as_subclass(_CudaLike)
        rglru_scan(d, d)
    with pytest.raises(ValueError, match="one \\(B, T, W\\) shape"):
        rglru_scan(a, a[:, :4])
    assert LAUNCHES["rglru_scan"] == 0


def test_rglru_scan_raises_past_max_batch():
    """Batches past the launcher's grid limit raise before any launch."""
    a = torch.zeros(MAX_BATCH + 1, 1, 1).as_subclass(_CudaLike)
    with pytest.raises(ValueError, match=f"batch {MAX_BATCH + 1} > "):
        rglru_scan(a, a)
    assert LAUNCHES["rglru_scan"] == 0


@contextlib.contextmanager
def _cuda_implementation_on_the_cpu(monkeypatch, calls):
    """The operators' CUDA implementations for CPU tensors while open,
    each launch standing in for its kernel with the plain version (each
    launch's kind, "forward" or "backward", and shape appended to
    ``calls``)."""
    from repro_torch.kernels.rglru_scan import ops

    def fake_launch(h, a, b):
        calls.append(("forward", a.shape))
        h.copy_(rglru_scan_ref(a, b))

    def fake_launch_backward(da, db, grad, a, h):
        calls.append(("backward", a.shape))
        for out, ref in zip((da, db), rglru_scan_backward_ref(
                grad, a, h, db.dtype)):
            out.copy_(ref)

    monkeypatch.setattr(ops, "launch", fake_launch)
    monkeypatch.setattr(ops, "launch_backward", fake_launch_backward)
    with ops._scan.set_kernel_enabled("cpu", False), \
            ops._scan_backward.set_kernel_enabled("cpu", False):
        yield


def test_training_route_takes_the_plain_versions_gradient(monkeypatch):
    """The operator ``repro_torch::rglru_scan`` as the card runs it: the
    kernel's forward (its CUDA implementation, the launch standing in for
    the kernel on the CPU) and, where autograd needs a backward, the
    backward operator's CUDA implementation (its launch standing in for
    the backward kernel). Values and gradients equal autograd of the plain
    version's loop bit for bit, in fp32 and bf16, with either input alone
    requiring grad; the forward kernel launched once per forward and
    never in the backward, the backward kernel once per backward. The
    gradient is ``jax.grad``'s through the reference's scan to fp32
    rounding."""
    from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_ref
    calls = []
    rs = np.random.RandomState(11)
    shape = (2, 9, 12)
    with _cuda_implementation_on_the_cpu(monkeypatch, calls):
        for dtype, need in ((torch.float32, (True, True)),
                            (torch.bfloat16, (True, True)),
                            (torch.float32, (False, True)),
                            (torch.float32, (True, False))):
            a_np = (1.0 / (1.0 + np.exp(-rs.randn(*shape)))).astype(
                np.float32)
            b_np = rs.randn(*shape).astype(np.float32)
            ins = [torch.from_numpy(x).to(dtype) for x in (a_np, b_np)]
            mine = [t.clone().requires_grad_(n) for t, n in zip(ins, need)]
            ref = [t.clone().requires_grad_(n) for t, n in zip(ins, need)]
            out = rglru_scan(*mine)
            want = rglru_scan_ref(*ref)
            assert torch.equal(out, want)
            g = torch.from_numpy(rs.randn(*shape).astype(np.float32))
            n_calls = len(calls)
            out.backward(g)
            want.backward(g)
            assert calls[n_calls:] == [("backward", shape)]
            for x, y, n in zip(mine, ref, need):
                assert (x.grad is None) == (not n)
                if n:
                    assert x.grad.dtype == dtype and \
                        torch.equal(x.grad, y.grad)
            if dtype == torch.float32 and all(need):
                jg = jax.grad(lambda a, b: jnp.sum(jax_ref(a, b)
                                                   * g.numpy()),
                              argnums=(0, 1))(a_np, b_np)
                for x, y in zip(mine, jg):
                    np.testing.assert_allclose(x.grad.numpy(), np.asarray(y),
                                               rtol=1e-5, atol=1e-6)
    assert calls == [("forward", shape), ("backward", shape)] * 4
    # outside it a CPU tensor takes the plain version, grad or not
    a = torch.rand(1, 4, 3, requires_grad=True)
    rglru_scan(a, a).sum().backward()
    assert len(calls) == 8
    assert LAUNCHES["rglru_scan"] == LAUNCHES["rglru_scan_backward"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_operator_forward_is_the_plain_version(dtype):
    """On the CPU the operator is ``ref.py``'s loop, bit for bit."""
    rs = np.random.RandomState(14)
    a, b = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (
        (1.0 / (1.0 + np.exp(-rs.randn(3, 21, 10)))).astype(np.float32),
        rs.randn(3, 21, 10).astype(np.float32)))
    out = torch.ops.repro_torch.rglru_scan(a, b)
    assert out.dtype == torch.float32
    assert torch.equal(out, rglru_scan_ref(a, b))
    assert LAUNCHES["rglru_scan"] == 0


@pytest.mark.parametrize("shape", [(2, 37, 8), (1, 1, 5), (3, 64, 33)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_operator_equals_autograd_of_the_loop(shape, dtype):
    """``repro_torch::rglru_scan_backward`` (the reverse-time recurrence
    of ``ref.py::rglru_scan_backward_ref``) is ``torch.equal`` to
    autograd of the plain loop, gradients in the inputs' dtype."""
    rs = np.random.RandomState(15)
    dt = getattr(torch, dtype)
    a = torch.from_numpy((1.0 / (1.0 + np.exp(-rs.randn(*shape)))).astype(
        np.float32)).to(dt)
    b = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dt)
    g = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    h = rglru_scan_ref(a, b)
    da, db = torch.ops.repro_torch.rglru_scan_backward(g, a, h, dt)
    a2, b2 = a.clone().requires_grad_(), b.clone().requires_grad_()
    rglru_scan_ref(a2, b2).backward(g)
    assert da.dtype == db.dtype == dt
    assert torch.equal(da, a2.grad) and torch.equal(db, b2.grad)


@pytest.mark.parametrize("shape,dtype", [
    ((2, 37, 8), torch.float32), ((1, 1, 5), torch.bfloat16),
    ((3, 64, 33), torch.float16)])
def test_backward_allocates_its_workspace(monkeypatch, shape, dtype):
    """The backward operator's CUDA implementation allocates its outputs
    and ``backward_workspace``'s bytes (the dry run's
    ``kernels.WORKSPACE``) and nothing more: 0, the kernel writes da and
    db directly. Its launch stands in for the kernel, handed the
    expanded gradient (stride 0) as it is."""
    from repro_torch.kernels import WORKSPACE
    from repro_torch.kernels.rglru_scan import ops
    rs = np.random.RandomState(20)
    a = torch.from_numpy(rs.rand(*shape).astype(np.float32)).to(dtype)
    h = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    g = torch.from_numpy(rs.randn(shape[0], 1, shape[2]).astype(
        np.float32)).expand(shape)
    want = rglru_scan_backward_ref(g, a, h, dtype)
    allocated, launched = [], []
    empty = torch.empty

    def counted(*args, **kwargs):
        t = empty(*args, **kwargs)
        allocated.append(t.numel() * t.element_size())
        return t

    def fake_launch_backward(da, db, grad, a_, h_):
        launched.append(grad.stride())
        da.copy_(want[0])
        db.copy_(want[1])

    monkeypatch.setattr(ops, "launch_backward", fake_launch_backward)
    monkeypatch.setattr(torch, "empty", counted)
    with ops._scan_backward.set_kernel_enabled("cpu", False):
        da, db = torch.ops.repro_torch.rglru_scan_backward(g, a, h, dtype)
    monkeypatch.setattr(torch, "empty", empty)
    assert launched == [g.stride()]
    assert torch.equal(da, want[0]) and torch.equal(db, want[1])
    outputs = sum(t.numel() * t.element_size() for t in (da, db))
    ws = WORKSPACE[torch.ops.repro_torch.rglru_scan_backward](g, a, h, dtype)
    assert ws == ops.backward_workspace(g, a, h, dtype) == 0
    assert sum(allocated) - outputs == ws


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
    the plain loop's FLOPs, forward and forward + backward (0: the loop
    multiplies elementwise, and the meter counts matrix products), and a
    formula is registered for both operators."""
    from torch.utils.flop_counter import flop_registry
    assert torch.ops.repro_torch.rglru_scan in flop_registry
    assert torch.ops.repro_torch.rglru_scan_backward in flop_registry
    shapes = [(2, 16, 8)] * 2
    assert _metered_flops(rglru_scan, shapes, backward) == \
        _metered_flops(rglru_scan_ref, shapes, backward) == 0


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_fake_call_launches_nothing(device):
    """On fake tensors (the dry run's) the wrapper, on a CPU or a CUDA
    device, reaches the operator's fake implementation: the fp32 output's
    shape, no launch counted; on the CPU (autograd on a fake CUDA device
    needs a card) the backward operator's too, the gradients in the
    inputs' dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        a = torch.empty(3, 4096, 16, dtype=torch.bfloat16, device=device,
                        requires_grad=device == "cpu")
        h = rglru_scan(a, a)
        assert h.shape == a.shape and h.dtype == torch.float32
        assert h.device.type == device
        if device == "cpu":
            (da,) = torch.autograd.grad(h.sum(), a)
            assert da.shape == a.shape and da.dtype == torch.bfloat16
    assert LAUNCHES["rglru_scan"] == 0


CHECKS = ("test_schema", "test_autograd_registration", "test_faketensor")


def test_operators_pass_opcheck():
    """``torch.library.opcheck``'s schema, fake-implementation and
    autograd-registration checks (not its compiled-dispatch one)."""
    rs = np.random.RandomState(16)
    a = torch.from_numpy(rs.rand(2, 7, 5).astype(np.float32))
    b = torch.from_numpy(rs.randn(2, 7, 5).astype(np.float32))
    g = torch.from_numpy(rs.randn(2, 7, 5).astype(np.float32))
    torch.library.opcheck(torch.ops.repro_torch.rglru_scan.default,
                          (a.requires_grad_(), b.requires_grad_()),
                          test_utils=CHECKS)
    torch.library.opcheck(torch.ops.repro_torch.rglru_scan_backward.default,
                          (g, a.detach(), rglru_scan_ref(a, b).detach(),
                           torch.float32), test_utils=CHECKS)
