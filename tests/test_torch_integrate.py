"""The port's integration engine (repro_torch/core) held against the JAX
package's on the README's toy field: ``Integrator.step``, ``solve``,
``solve_multirate`` and the controller-driven solve, fused and unfused,
with and without a correction g; the tableaus equal the reference's; and
the result dtypes of a bf16 state follow the reference's type promotion.
Tolerance fp32 rtol = atol = 1e-6 (the two frameworks round softplus and
the mean differently in the last place)."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from port_isolation import port_module_isolation  # noqa: F401
from repro.core import tableaus as jax_tableaus
from repro.core.controllers import EmbeddedErrorController as JaxEmbedded
from repro.core.controllers import HypersolverResidualController as JaxResid
from repro.core.integrate import Integrator as JaxIntegrator
from repro.core.integrate import tree_axpy as jax_axpy
from repro.core.solvers import FixedGrid as JaxGrid
from repro_torch.core import tableaus as torch_tableaus
from repro_torch.core.controllers import EmbeddedErrorController
from repro_torch.core.controllers import HypersolverResidualController
from repro_torch.core.integrate import (Integrator,
                                        reset_fused_fallback_warning,
                                        tree_axpy)
from repro_torch.core.solvers import FixedGrid

TOL = dict(rtol=1e-6, atol=1e-6)
B, D = 6, 32


@pytest.fixture(autouse=True)
def _rearm_fused_fallback_warning():
    """Re-arm the port's one-time fused-fallback latch per test, so a
    warning assertion does not depend on test order."""
    reset_fused_fallback_warning()
    yield


def f_jax(s, z):
    return -z * jax.nn.softplus(jnp.mean(z, axis=-1, keepdims=True))


def f_torch(s, z):
    return -z * F.softplus(torch.mean(z, dim=-1, keepdim=True))


def g_jax(eps, s, z, dz):
    return 0.3 * jnp.tanh(dz) + 0.1 * z


def g_torch(eps, s, z, dz):
    return 0.3 * torch.tanh(dz) + 0.1 * z


def _integrators(tab_name, with_g, fused):
    jt = JaxIntegrator(jax_tableaus.get(tab_name),
                       g=g_jax if with_g else None, fused=fused)
    tt = Integrator(torch_tableaus.get(tab_name),
                    g=g_torch if with_g else None, fused=fused)
    return jt, tt


def _z0(seed=0):
    z = np.random.RandomState(seed).randn(B, D).astype(np.float32)
    return jnp.asarray(z), torch.from_numpy(z)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_tableaus_equal_reference():
    assert set(torch_tableaus.REGISTRY) == set(jax_tableaus.REGISTRY)
    for name, tab in jax_tableaus.REGISTRY.items():
        assert dataclasses.asdict(torch_tableaus.get(name)) == \
            dataclasses.asdict(tab)
    assert dataclasses.asdict(torch_tableaus.alpha_family(0.7)) == \
        dataclasses.asdict(jax_tableaus.alpha_family(0.7))


@pytest.mark.parametrize("tab_name", ["euler", "heun", "rk4"])
@pytest.mark.parametrize("with_g", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_step_and_solve_match_jax(tab_name, with_g, fused):
    jt, tt = _integrators(tab_name, with_g, fused)
    zj, zt = _z0()
    # one step, Python eps
    _close(tt.step(f_torch, 0.0, 0.25, zt)[0],
           jt.step(f_jax, 0.0, 0.25, zj)[0])
    # one step, per-sample eps and a freeze mask
    eps = np.linspace(0.1, 0.6, B).astype(np.float32)
    act = np.arange(B) % 3 != 0
    out_t = tt.step(f_torch, 0.0, torch.from_numpy(eps), zt,
                    active=torch.from_numpy(act))[0]
    out_j = jt.step(f_jax, 0.0, jnp.asarray(eps), zj,
                    active=jnp.asarray(act))[0]
    _close(out_t, out_j)
    assert torch.equal(out_t[~torch.from_numpy(act)],
                       zt[~torch.from_numpy(act)])
    # fixed-grid solve, dense trajectory
    traj_t = tt.solve(f_torch, zt, FixedGrid.over(0.0, 1.0, 4))
    traj_j = jt.solve(f_jax, zj, JaxGrid.over(0.0, 1.0, 4))
    assert traj_t.shape == (5, B, D)
    _close(traj_t, traj_j)


@pytest.mark.parametrize("tab_name", ["euler", "heun"])
@pytest.mark.parametrize("with_g", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_solve_multirate_matches_jax(tab_name, with_g, fused):
    jt, tt = _integrators(tab_name, with_g, fused)
    zj, zt = _z0(1)
    Ks = np.array([1, 2, 4, 3, 4, 2], np.int32)
    out_t = tt.solve_multirate(f_torch, zt, (0.0, 1.0), Ks, 4,
                               return_traj=True)
    out_j = jt.solve_multirate(f_jax, zj, (0.0, 1.0), jnp.asarray(Ks), 4,
                               return_traj=True)
    _close(out_t, out_j)
    with pytest.raises(ValueError):
        tt.solve_multirate(f_torch, zt, (0.0, 1.0), Ks, 3)


def assert_off_bucket_edges(err, tol, q):
    """No row's (err/tol)^(1/q) lies within 1e-3 of an integer, so rounding
    differences between the frameworks cannot flip its K."""
    r = (np.asarray(err, np.float64) / tol) ** (1.0 / q)
    assert np.abs(r - np.round(r)).min() > 1e-3, r


@pytest.mark.parametrize("fused", [False, True])
def test_controlled_solve_matches_jax(fused):
    """The README quickstart's multi-rate solve (embedded probe), and the
    residual probe of a hypersolver: same K, same NFE, same states, with
    rows of mixed difficulty."""
    z = np.random.RandomState(2).randn(B, D).astype(np.float32)
    z *= np.array([0.1, 0.3, 1, 2, 4, 8], np.float32)[:, None]
    zj, zt = jnp.asarray(z), torch.from_numpy(z)
    for with_g, ctrl_j, ctrl_t in [
            (False, JaxEmbedded(tol=1e-2, k_min=2, k_max=16),
             EmbeddedErrorController(tol=1e-2, k_min=2, k_max=16)),
            (True, JaxResid(tol=2e-2, k_min=1, k_max=8),
             HypersolverResidualController(tol=2e-2, k_min=1, k_max=8))]:
        jt, tt = _integrators("euler", with_g, fused)
        zT_t, st_t = tt.solve(f_torch, zt, FixedGrid.over(0.0, 1.0, 16),
                              return_traj=False, controller=ctrl_t)
        zT_j, st_j = jt.solve(f_jax, zj, JaxGrid.over(0.0, 1.0, 16),
                              return_traj=False, controller=ctrl_j)
        assert_off_bucket_edges(st_j.err_probe, ctrl_j.tol, 1)
        np.testing.assert_allclose(st_t.err_probe.numpy(),
                                   np.asarray(st_j.err_probe), rtol=1e-5)
        np.testing.assert_array_equal(st_t.K.numpy(), np.asarray(st_j.K))
        np.testing.assert_array_equal(st_t.nfe.numpy(), np.asarray(st_j.nfe))
        assert len(set(st_t.K.tolist())) > 2, "K is not mixed"
        _close(zT_t, zT_j)


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("eps_kind", ["python", "0d", "batched"])
def test_bf16_promotion_matches_jax(eps_kind):
    """JAX promotes a bf16 state against a float32 array coefficient (0-d
    included) and keeps it for a Python float; the port does the same on
    the unfused update, and the fused kernel always stores the state's
    dtype."""
    zj, zt = _z0(3)
    zj, zt = zj.astype(jnp.bfloat16), zt.to(torch.bfloat16)
    eps_np = np.linspace(0.1, 0.6, B).astype(np.float32)
    eps_j, eps_t = {
        "python": (0.25, 0.25),
        "0d": (jnp.asarray(0.25, jnp.float32),
               torch.tensor(0.25, dtype=torch.float32)),
        "batched": (jnp.asarray(eps_np), torch.from_numpy(eps_np)),
    }[eps_kind]
    assert _dtype_name(tree_axpy(eps_t, zt, zt)) == \
        str(jax_axpy(eps_j, zj, zj).dtype)
    for fused in (False, True):
        jt, tt = _integrators("euler", True, fused)
        out_j = jt.step(f_jax, 0.0, eps_j, zj)[0]
        out_t = tt.step(f_torch, 0.0, eps_t, zt)[0]
        assert _dtype_name(out_t) == str(out_j.dtype)
        if fused:
            assert out_t.dtype == torch.bfloat16


class _CudaLike(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the card-only
    branch of ``Integrator.step`` without a card."""

    @property
    def device(self):
        return torch.device("cuda")


@pytest.mark.parametrize("where", ["cpu", "cuda"])
def test_fused_state_outside_kernel_dtypes(where):
    """A float64 state under fused=True: on the CPU the step takes the
    leaf-wise update and equals the unfused step; on the card it raises
    rather than run anything but the kernel."""
    z = torch.from_numpy(np.random.RandomState(4).randn(B, D))
    fused = Integrator(torch_tableaus.get("heun"), g=g_torch, fused=True)
    if where == "cuda":
        calls = []
        with pytest.raises(TypeError, match="float64"):
            fused.step(lambda s, x: calls.append(s) or f_torch(s, x), 0.0,
                       0.25, z.as_subclass(_CudaLike))
        assert not calls
        return
    plain = Integrator(torch_tableaus.get("heun"), g=g_torch, fused=False)
    with pytest.warns(RuntimeWarning, match="falling back"):
        out = fused.step(f_torch, 0.0, 0.25, z)[0]
    with warnings.catch_warnings():     # one-time: silent until re-armed
        warnings.simplefilter("error", RuntimeWarning)
        fused.step(f_torch, 0.0, 0.25, z)
    assert out.dtype == torch.float64
    assert torch.equal(out, plain.step(f_torch, 0.0, 0.25, z)[0])
