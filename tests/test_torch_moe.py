"""The port's mixture-of-experts layer (repro_torch/nn/moe.py) held against
the JAX package's ``repro/nn/moe.py``: ``moe_apply`` (slot-major queues)
and ``moe_apply_sorted`` (token-major queues) with and without slots
dropped, gated and ungated experts, top-1 to top-8, their aux, z and
dropped terms and the sorted dispatch's gradients; the grouped dispatches
(each row alone, each position alone) against the reference's ``vmap``;
and the MoE depth field under a per-sample depth with slots dropped.
Weights are drawn by the JAX package (``moe_init``) and carried across
with ``convert.params_from_jax``; inputs come from numpy. Tolerance fp32
rtol = atol = 1e-5 through one expert FFN (1e-4 through a model); bf16
within two units in the last place of the largest |value| (the
convention of tests/test_torch_decode.py's bf16 cases). Every token
the port routes has its k-th router probability above its (k+1)-th by
more than ``MARGIN`` (asserted), so no rounding difference can move a
token to another expert (tests/test_nn_layers.py holds the reference's
own dispatches to its loop oracle)."""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_isolation import port_module_isolation  # noqa: F401
from repro import configs as jax_configs
from repro.models import cdepth as jcd
from repro.models import lm as jlm
from repro.nn import moe as jmoe
from repro_torch import configs as torch_configs
from repro_torch.convert import params_from_jax
from repro_torch.models import cdepth as tcd
from repro_torch.models import lm as tlm
from repro_torch.nn import moe as tmoe

# the least gap between a token's k-th and (k+1)-th router probability
MARGIN = 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)
D, D_FF = 16, 32


@contextlib.contextmanager
def routing_margins():
    """Records, while open, the least gap between the k-th and (k+1)-th
    router probability over the tokens each port routing call sees."""
    gaps = []
    orig = tmoe._route

    def recorded(params, xt, top_k, renorm_gates):
        out = orig(params, xt, top_k, renorm_gates)
        probs = out[1].detach()
        if top_k < probs.shape[-1]:
            top = torch.sort(probs, dim=-1, descending=True).values
            gaps.append(float((top[:, top_k - 1] - top[:, top_k]).min()))
        return out

    tmoe._route = recorded
    try:
        yield gaps
    finally:
        tmoe._route = orig


@functools.lru_cache(maxsize=None)
def _layer_jax(E, gated, seed, dtype):
    """The reference's layer params, drawn once per file for each key."""
    return jmoe.moe_init(jax.random.PRNGKey(seed), D, D_FF, E, gated=gated,
                         param_dtype=dtype)


def _layer(E, gated=True, seed=0, dtype=jnp.float32):
    """(JAX params, a fresh copy for the port)."""
    pj = _layer_jax(E, gated, seed, dtype)
    return pj, params_from_jax(jax.tree_util.tree_map(np.asarray, pj))


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


FNS = {"einsum": (jmoe.moe_apply, tmoe.moe_apply),
       "sorted": (jmoe.moe_apply_sorted, tmoe.moe_apply_sorted)}


def _both(name, pj, pt, x, **kw):
    fj, ft = FNS[name]
    oj = fj(pj, jnp.asarray(x), **kw)
    with routing_margins() as gaps:
        ot = ft(pt, torch.from_numpy(x), **kw)
    assert not gaps or min(gaps) > MARGIN, min(gaps)
    return oj, ot


def _held(ot, oj, **tol):
    _close(ot.y, oj.y, **tol)
    for a, b in zip(ot[1:], oj[1:]):
        assert a.shape == () and a.dtype == torch.float32
        _close(a, b, rtol=1e-6, atol=1e-6)


def test_moe_init_tree_matches_jax():
    for gated in (True, False):
        pj, pt = _layer(4, gated)
        own = tmoe.moe_init(torch.Generator().manual_seed(0), D, D_FF, 4,
                            gated=gated)
        assert sorted(own) == sorted(pj) == sorted(pt)
        for k in ("wi", "wd") + (("wg",) if gated else ()):
            assert tuple(own[k].shape) == pj[k].shape == tuple(pt[k].shape)
        assert own["router"]["kernel"].shape == (D, 4)
    lead = tmoe.moe_init(torch.Generator().manual_seed(0), D, D_FF, 4,
                         lead=(3,))
    assert lead["wi"].shape == (3, 4, D, D_FF)
    assert lead["router"]["kernel"].shape == (3, D, 4)


@pytest.mark.parametrize("T,k,cf,E", [(8, 8, 2.0, 64), (128, 8, 1.25, 64),
                                      (1024, 8, 1.25, 64), (3, 1, 0.5, 4),
                                      (24, 2, 1.25, 4), (7, 3, 0.3, 5)])
def test_capacity_matches_reference_arithmetic(T, k, cf, E):
    """The reference's C = int(max(1, -(-k*T*cf // E))): OLMoE's decode
    step at B 8 (2), a drain row of 128 tokens (20), the 8 x 128
    forward (160)."""
    assert tmoe.capacity(k, T, cf, E) == int(max(1, -(-k * T * cf // E)))


@pytest.mark.parametrize("name", list(FNS))
@pytest.mark.parametrize("gated", [True, False], ids=["gated", "plain"])
@pytest.mark.parametrize("top_k,E", [(1, 4), (2, 8), (8, 8)])
@pytest.mark.parametrize("drops", [False, True], ids=["kept", "dropped"])
def test_moe_matches_jax(name, gated, top_k, E, drops):
    """y, aux, z and the dropped fraction; with a capacity factor of E
    nothing drops, with 0.3 slots past C are dropped (top-8 of 8 at
    0.3 keeps C of every expert's T)."""
    pj, pt = _layer(E, gated)
    x = _x((2, 12, D))
    cf = 0.3 if drops else float(E)
    oj, ot = _both(name, pj, pt, x, n_experts=E, top_k=top_k,
                   capacity_factor=cf)
    assert (float(oj.fraction_dropped) > 0) == drops
    _held(ot, oj)


@pytest.mark.parametrize("name", list(FNS))
@pytest.mark.parametrize("top_k,E", [(1, 4), (2, 8), (8, 8)])
def test_moe_matches_loop_oracle_with_big_capacity(name, top_k, E):
    """With nothing dropped both dispatches are the loop oracle
    (``moe_apply_reference``), which matches the reference's."""
    pj, pt = _layer(E)
    x = _x((2, 10, D), seed=7)
    out = FNS[name][1](pt, torch.from_numpy(x), n_experts=E, top_k=top_k,
                       capacity_factor=float(E))
    assert float(out.fraction_dropped) == 0.0
    ref = tmoe.moe_apply_reference(pt, torch.from_numpy(x), n_experts=E,
                                   top_k=top_k)
    _close(out.y, ref.numpy())
    _close(ref, jmoe.moe_apply_reference(pj, jnp.asarray(x), n_experts=E,
                                         top_k=top_k))


def test_dispatch_orders_drop_different_slots():
    """Top-2 with slots dropped: the einsum dispatch keeps every token's
    first choice before any second choice, the sorted one keeps slots in
    token order; they drop different slots, so their outputs differ, and
    each equals its own reference."""
    pj, pt = _layer(4)
    x = _x((1, 32, D), seed=3)
    kw = dict(n_experts=4, top_k=2, capacity_factor=0.5)
    outs = {}
    for name in FNS:
        oj, ot = _both(name, pj, pt, x, **kw)
        assert float(oj.fraction_dropped) > 0
        _held(ot, oj)
        outs[name] = ot.y
    assert (outs["einsum"] - outs["sorted"]).abs().max() > 1e-2


def test_top1_orders_agree_under_drops():
    """At top-1 slot-major and token-major order coincide: the two
    dispatches keep the same slots (tests/test_nn_layers.py's
    ``test_moe_sorted_matches_einsum_dispatch_incl_drops``)."""
    pj, pt = _layer(4)
    x = _x((1, 32, D), seed=22)
    kw = dict(n_experts=4, top_k=1, capacity_factor=0.5)
    a = tmoe.moe_apply(pt, torch.from_numpy(x), **kw)
    b = tmoe.moe_apply_sorted(pt, torch.from_numpy(x), **kw)
    assert float(a.fraction_dropped) == float(b.fraction_dropped) > 0
    _close(a.y, b.y.numpy())


def test_top_k_ties_break_toward_lower_index():
    """A zero router gives every expert the same probability:
    ``jax.lax.top_k`` then picks the lowest indices, and so must the
    port (``torch.topk`` promises no order on ties)."""
    pj, pt = _layer(8)
    pj = dict(pj, router={"kernel": jnp.zeros((D, 8))})
    pt = dict(pt, router={"kernel": torch.zeros(D, 8)})
    xt = torch.from_numpy(_x((6, D)))
    _, _, gate, expert = tmoe._route(pt, xt, 3, True)
    _, ref = jax.lax.top_k(jax.nn.softmax(jnp.zeros((6, 8))), 3)
    np.testing.assert_array_equal(expert.numpy(), np.asarray(ref))
    x = _x((1, 6, D))
    for name in FNS:
        oj = FNS[name][0](pj, jnp.asarray(x), n_experts=8, top_k=3,
                          capacity_factor=0.5)
        ot = FNS[name][1](pt, torch.from_numpy(x), n_experts=8, top_k=3,
                          capacity_factor=0.5)
        _held(ot, oj)


@pytest.mark.parametrize("drops", [False, True], ids=["kept", "dropped"])
@pytest.mark.parametrize("gated", [True, False], ids=["gated", "plain"])
def test_moe_sorted_grads_match_jax(drops, gated):
    """Gradients of sum(y^2) + aux + z through the sorted dispatch with
    respect to every parameter and the input (the reference's
    ``test_moe_sorted_grads_flow``, held to its values)."""
    pj, pt = _layer(4, gated)
    x = _x((1, 16, D), seed=23)
    kw = dict(n_experts=4, top_k=2, capacity_factor=0.5 if drops else 4.0)

    def loss_j(p, xx):
        o = jmoe.moe_apply_sorted(p, xx, **kw)
        return jnp.sum(o.y ** 2) + o.aux_loss + o.router_z_loss, \
            o.fraction_dropped

    (lj, dropped), (gpj, gxj) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(pj, jnp.asarray(x))
    assert (float(dropped) > 0) == drops
    pt = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(), pt)
    xt = torch.from_numpy(x).requires_grad_()
    with routing_margins() as gaps:
        o = tmoe.moe_apply_sorted(pt, xt, **kw)
    assert min(gaps) > MARGIN
    lt = torch.sum(o.y ** 2) + o.aux_loss + o.router_z_loss
    lt.backward()
    _close(lt, lj)
    _close(xt.grad, gxj, rtol=1e-4, atol=1e-5)
    for key in gpj:
        gj = gpj[key]["kernel"] if key == "router" else gpj[key]
        gt = pt[key]["kernel"].grad if key == "router" else pt[key].grad
        assert float(jnp.abs(gj).sum()) > 0
        _close(gt, gj, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", list(FNS))
@pytest.mark.parametrize("groups", ["row", "position"])
def test_grouped_dispatch_matches_vmapped_reference(name, groups):
    """``groups="row"``: each batch row dispatches alone, the reference
    ``vmap``ped over rows (a per-sample depth field); ``"position"``:
    each position's B tokens alone, the reference ``vmap``ped over
    positions (a decode step per position). Capacities are per group, so
    the grouped call differs from the whole-batch one when slots drop."""
    pj, pt = _layer(4)
    x = _x((4, 12, D), seed=5)
    kw = dict(n_experts=4, top_k=2, capacity_factor=0.5)
    fj, ft = FNS[name]
    if groups == "row":
        yj = jax.vmap(lambda xi: fj(pj, xi[None], **kw).y[0])(jnp.asarray(x))
    else:
        yj = jax.vmap(lambda xi: fj(pj, xi[:, None], **kw).y[:, 0],
                      in_axes=1, out_axes=1)(jnp.asarray(x))
    with routing_margins() as gaps:
        out = ft(pt, torch.from_numpy(x), groups=groups, **kw)
    assert min(gaps) > MARGIN and float(out.fraction_dropped) > 0
    _close(out.y, yj)
    whole = ft(pt, torch.from_numpy(x), **kw)
    assert (whole.y - out.y).abs().max() > 1e-3


@pytest.mark.parametrize("name", list(FNS))
def test_moe_bf16_within_one_ulp(name):
    """bf16 weights and activations, slots dropped: router logits in
    float32 from the bf16 operands, expert GEMMs accumulated in float32
    and rounded once; the port's y within 2 bf16 ulps of the largest
    |y| of the reference's (readings 1.62 for the einsum dispatch and
    1.56 for the sorted one: the frameworks round silu and the GEMM
    outputs an ulp apart, as for the dense FFN), the routing and the
    float32 aux terms as in float32."""
    pj, pt = _layer(8, dtype=jnp.bfloat16)
    x = _x((2, 16, D), seed=9)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = params_from_jax(np.asarray(xj))
    kw = dict(n_experts=8, top_k=2, capacity_factor=0.5)
    oj = FNS[name][0](pj, xj, **kw)
    with routing_margins() as gaps:
        ot = FNS[name][1](pt, xt, **kw)
    assert min(gaps) > MARGIN and float(oj.fraction_dropped) > 0
    assert ot.y.dtype == torch.bfloat16
    yj = np.asarray(oj.y.astype(jnp.float32))
    err = np.abs(ot.y.float().numpy() - yj).max() / np.abs(yj).max()
    assert err <= 2 * 2.0 ** -8, err / 2.0 ** -8
    for a, b in zip(ot[1:], oj[1:]):
        _close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "llama4_maverick_400b_a17b"])
def test_depth_field_rows_dispatch_alone(arch):
    """A (B,) depth on a MoE model, every row in one group, capacity
    factor 0.5 so slots drop: the reference ``vmap``s over samples, each
    row dispatching alone; the port's field equals it, and differs from
    the same group run on the whole batch (a scalar depth)."""
    cfg_j = dataclasses.replace(jax_configs.get(arch).reduced(),
                                capacity_factor=0.5)
    cfg_t = dataclasses.replace(torch_configs.get(arch).reduced(),
                                capacity_factor=0.5)
    pj = jlm.init_lm(jax.random.PRNGKey(2), cfg_j)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    toks = np.random.RandomState(4).randint(0, cfg_j.vocab, (3, 12))
    hj = jlm._embed(pj, cfg_j, jnp.asarray(toks.astype(np.int32)))
    ht = tlm._embed(pt, cfg_t, torch.from_numpy(toks))
    same = np.full((3,), 0.25, np.float32)
    ref = jcd.depth_field(pj, cfg_j)(jnp.asarray(same), hj)
    with routing_margins() as gaps:
        out = tcd.depth_field(pt, cfg_t)(torch.from_numpy(same), ht)
    assert min(gaps) > MARGIN
    _close(out, ref, rtol=1e-4, atol=1e-4)
    whole = tcd.depth_field(pt, cfg_t)(0.25, ht)
    _close(whole, jcd.depth_field(pj, cfg_j)(0.25, hj), rtol=1e-4,
           atol=1e-4)
    assert (whole - out).abs().max() > 1e-2
