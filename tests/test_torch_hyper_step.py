"""The port's fused hypersolver update (repro_torch/kernels/hyper_step) held
against the JAX package's Pallas kernel in interpret mode, on the CPU.

On a CPU tensor the port's wrapper runs its plain PyTorch version
(``ref.py``); the CUDA kernel is held against that same plain version on
the card by ``chip_smoke.py``. Mirrors tests/test_kernels.py's
``test_fused_rk_update_sweep``, ``_per_sample_eps_sweep`` and
``test_hyper_step_sweep``. Tolerances: fp32 rtol = atol = 1e-6; bf16 and
fp16 at most one unit in the last place of the storage type (the two
frameworks may round a float32 product or the eps**(p+1) power
differently); frozen rows equal bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_isolation import port_module_isolation  # noqa: F401
from repro.core import get_tableau as jax_tableau
from repro.kernels.hyper_step.ops import fused_rk_update as jax_fused
from repro.kernels.hyper_step.ops import hyper_step as jax_hyper_step
from repro_torch.convert import tensor_from_numpy
from repro_torch.core.tableaus import get as torch_tableau
from repro_torch.kernels.hyper_step.ops import (
    LAUNCHES, fused_rk_update, hyper_step, row_operands)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}
SHAPE = (4, 3, 37)


def _pair(x: np.ndarray, dtype: str):
    """The same values in both frameworks: rounded once by JAX, carried
    to torch bit for bit."""
    xj = jnp.asarray(x).astype(DTYPES[dtype][0])
    return xj, tensor_from_numpy(np.asarray(xj))


def _ordered_bits(a: np.ndarray) -> np.ndarray:
    """16-bit float patterns mapped to integers ordered like the values
    (+0 and -0 both map to 0), so one ulp is a difference of 1."""
    b = a.view(np.int16).astype(np.int32)
    return np.where(b < 0, -(b & 0x7FFF), b)


def assert_matches(out_t: torch.Tensor, out_j, dtype: str):
    assert str(out_t.dtype) == f"torch.{dtype}"
    oj = np.asarray(out_j)
    assert out_t.shape == oj.shape
    if dtype == "float32":
        np.testing.assert_allclose(out_t.numpy(), oj, rtol=1e-6, atol=1e-6)
        return
    bits_t = out_t.view(torch.int16).numpy()
    ulps = np.abs(_ordered_bits(bits_t) - _ordered_bits(oj.view(np.int16)))
    assert ulps.max() <= 1, f"{dtype}: {ulps.max()} ulp apart"


def _live(tab_name):
    tab = torch_tableau(tab_name)
    assert tab.b == jax_tableau(tab_name).b
    return tuple(bj for bj in tab.b if bj != 0.0), tab.order


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tab_name",
                         ["euler", "heun", "midpoint", "rk4", "dopri5"])
@pytest.mark.parametrize("with_g", [True, False])
def test_fused_rk_update_matches_jax(dtype, tab_name, with_g):
    """Every step-size form — Python float, 0-d tensor, per-sample (B,)
    row with an active mask — against the Pallas kernel; only live stages
    (nonzero b) reach the kernel, as Integrator.step passes them."""
    b, order = _live(tab_name)
    rs = np.random.RandomState(3)
    zj, zt = _pair(rs.randn(*SHAPE), dtype)
    stages = [_pair(rs.randn(*SHAPE), dtype) for _ in b]
    sj, st = [s[0] for s in stages], [s[1] for s in stages]
    gj, gt = _pair(rs.randn(*SHAPE), dtype) if with_g else (None, None)

    for eps_j, eps_t in [(0.125, 0.125),
                         (jnp.asarray(0.3, jnp.float32),
                          torch.tensor(0.3, dtype=torch.float32))]:
        out_j = jax_fused(zj, tuple(sj), gj, eps_j, b, order, interpret=True)
        out_t = fused_rk_update(zt, st, gt, eps_t, b, order)
        assert_matches(out_t, out_j, dtype)

    eps = np.linspace(0.05, 0.5, SHAPE[0]).astype(np.float32)
    active = (np.arange(SHAPE[0]) % 2).astype(np.int32)
    out_j = jax_fused(zj, tuple(sj), gj, jnp.asarray(eps), b, order,
                      active=jnp.asarray(active), interpret=True)
    out_t = fused_rk_update(zt, st, gt, torch.from_numpy(eps), b, order,
                            active=torch.from_numpy(active))
    assert_matches(out_t, out_j, dtype)
    # frozen rows are bitwise the input state
    assert torch.equal(out_t[::2], zt[::2])
    # the CPU path is the plain version: no kernel launch is counted
    assert LAUNCHES["hyper_step"] == 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("eps,order", [(0.1, 1), (0.25, 2)])
def test_hyper_step_matches_jax(dtype, eps, order):
    rs = np.random.RandomState(0)
    zj, zt = _pair(rs.randn(33, 5), dtype)
    fj, ft = _pair(rs.randn(33, 5), dtype)
    gj, gt = _pair(rs.randn(33, 5), dtype)
    out_j = jax_hyper_step(zj, fj, gj, eps, order, interpret=True)
    assert_matches(hyper_step(zt, ft, gt, eps, order), out_j, dtype)


def test_fused_rk_update_rejects_bad_shapes():
    z = torch.zeros(4, 5)
    with pytest.raises(ValueError):
        fused_rk_update(z, [z], None, 0.1, (0.5, 0.5), 2)


@pytest.mark.parametrize("eps,active,rows", [
    (0.25, None, 1),                                   # scalar eps: one row
    (np.linspace(0.1, 0.4, 4, dtype=np.float32), None, 4),
    (0.5, np.array([1, 0, 1, 0]), 4),                  # mask alone batches
])
def test_row_operands(eps, active, rows):
    z = torch.zeros(4, 3, 5)
    eps_t = torch.as_tensor(eps, dtype=torch.float32)
    act = None if active is None else torch.from_numpy(active)
    eps_row, epsp_row, act_row = row_operands(z, eps_t, 2, act)
    assert eps_row.shape == epsp_row.shape == act_row.shape == (rows,)
    assert eps_row.dtype == epsp_row.dtype == torch.float32
    assert act_row.dtype == torch.int32
    assert torch.equal(epsp_row, eps_row ** 3)
    assert torch.equal(eps_row, eps_t.reshape(-1).expand(rows))
    want = np.ones(rows) if active is None else active
    assert act_row.tolist() == list(want)


@pytest.mark.parametrize("case", ["ragged-n", "all-frozen", "b1-scalar-eps",
                                  "heun-promoted"])
def test_fused_rk_update_edge_cases_match_jax(case):
    """The cases chip_smoke.py adds for the kernel's edges, against the
    Pallas kernel: rows of N % 8 != 0, every row frozen, one row under a
    scalar eps, and a bf16 state with a float32 later stage (heun under a
    per-sample eps, the reference's promotion)."""
    rs = np.random.RandomState(21)
    shape = (4, 3, 7) if case == "ragged-n" else (4, 16)
    eps = np.linspace(0.1, 0.4, 4).astype(np.float32)
    active = np.array([1, 1, 0, 1], np.int32)
    b, order, g_on = (1.0,), 1, True
    dts = ["bfloat16", "bfloat16"]
    if case == "all-frozen":
        active = np.zeros(4, np.int32)
    if case == "heun-promoted":
        b, order, g_on, dts = (0.5, 0.5), 2, False, ["bfloat16", "bfloat16",
                                                     "float32"]
    zj, zt = _pair(rs.randn(*shape), dts[0])
    pairs = [_pair(rs.randn(*shape), d) for d in dts[1:]]
    gj, gt = _pair(rs.randn(*shape), "bfloat16") if g_on else (None, None)
    sj, st = tuple(p[0] for p in pairs), [p[1] for p in pairs]
    if case == "b1-scalar-eps":
        out_j = jax_fused(zj, sj, gj, 0.25, b, order, interpret=True)
        out_t = fused_rk_update(zt, st, gt, 0.25, b, order)
    else:
        out_j = jax_fused(zj, sj, gj, jnp.asarray(eps), b, order,
                          active=jnp.asarray(active), interpret=True)
        out_t = fused_rk_update(zt, st, gt, torch.from_numpy(eps), b, order,
                                active=torch.from_numpy(active))
        frozen = torch.from_numpy(active == 0)
        assert torch.equal(out_t[frozen], zt[frozen])
    assert_matches(out_t, out_j, "bfloat16")
    assert LAUNCHES["hyper_step"] == 0
