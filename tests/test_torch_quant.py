"""The port's quantized paths held against the JAX package's on the CPU:
``optim/quantized_state.py`` (blockwise int8, ``adamw8bit`` and its
in-place update), ``optim/grad_compress.py``, the q-chunked attention of
``nn/attention.py::set_attention_chunking``, the int8 KV cache's
quantizer and decode, the MoE ``int8_dispatch`` and ``models/lm.py``'s
``PERF_OPT``. Each mirrors a reference test (``tests/test_optim.py``'s
int8 cases, ``tests/test_nn_layers.py``'s chunked, int8 MoE and int8
KV cases) at its own bound, and holds the port to the reference on the
same inputs. The LM prefill and decode into an int8 cache are in
tests/test_torch_decode.py.

Inputs come from numpy ``RandomState``; weights are drawn by the JAX
package and carried across with ``convert.params_from_jax``.
Tolerances: int8 payloads within one unit of the reference's (the value
divided by the scale may round the other way where the float32 inputs
differ by an ulp; on these inputs they are equal), scales and the
update algebra (``adamw8bit``'s params over 20 steps) at rtol = atol =
1e-6; through matmuls rtol 1e-4, atol 1e-5 (XLA and PyTorch sum in
different orders). The in-place update equals the functional one bit
for bit."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from port_isolation import port_module_isolation  # noqa: F401
from repro import configs as jax_configs
from repro.models import lm as jlm
from repro.nn import attention as jatt
from repro.nn import moe as jmoe
from repro.optim import apply_updates as jax_apply
from repro.optim import grad_compress as jgc
from repro.optim import quantized_state as jqs
from repro.optim.schedules import linear_warmup_cosine as jax_warmup_cosine
from repro_torch import configs as torch_configs
from repro_torch.convert import params_from_jax, quantized_state_from_jax
from repro_torch.models import lm as tlm
from repro_torch.nn import attention as tatt
from repro_torch.nn import moe as tmoe
from repro_torch.optim import (BLOCK, Adam8bitState, QTensor, adamw,
                               adamw8bit, apply_updates, clip_by_global_norm,
                               compress_with_feedback,
                               compressed_allreduce_mean,
                               dequantize_blockwise, init_error_feedback,
                               linear_warmup_cosine, optimizers,
                               quantize_blockwise, sgd)
from repro_torch.optim.quantized_state import zeros_blockwise

ALGEBRA = dict(rtol=1e-6, atol=1e-6)
MATMUL = dict(rtol=1e-4, atol=1e-5)


def to_torch(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or MATMUL))


def _payload_close(t, j):
    """int8 payloads within one unit of the reference's."""
    assert t.dtype == torch.int8 and tuple(t.shape) == np.shape(j)
    diff = np.abs(t.numpy().astype(np.int32) - np.asarray(j, np.int32))
    assert diff.max(initial=0) <= 1, diff.max()


def _qtensor_close(t: QTensor, j):
    assert isinstance(t, QTensor)
    _payload_close(t.q, j.q)
    _close(t.scale, j.scale, **ALGEBRA)


# ------------------------------------------------------------- blockwise ----

@pytest.mark.parametrize("n", [1000, 256, 3])
def test_blockwise_quant_roundtrip_error(n):
    """tests/test_optim.py's bound, and the reference's payload and
    scales on the same input (zero padding to whole blocks)."""
    x = (np.random.RandomState(0).randn(n) * 3.0).astype(np.float32)
    qt = quantize_blockwise(torch.from_numpy(x))
    blocks = -(-n // BLOCK)
    assert qt.q.shape == (blocks, BLOCK) and qt.scale.shape == (blocks, 1)
    assert qt.scale.dtype == torch.float32
    assert not qt.q.reshape(-1)[n:].any()
    y = dequantize_blockwise(qt, x.shape)
    rel = float((torch.from_numpy(x) - y).abs().max() / np.abs(x).max())
    assert rel < 1.5 / 127
    _qtensor_close(qt, jqs.quantize_blockwise(jnp.asarray(x)))
    _close(y, jqs.dequantize_blockwise(jqs.quantize_blockwise(
        jnp.asarray(x)), x.shape), **ALGEBRA)


def test_zeros_blockwise_is_quantized_zeros():
    for shape in [(3, 700), (5,), (2, 128)]:
        z, ref = zeros_blockwise(shape), quantize_blockwise(torch.zeros(shape))
        assert torch.equal(z.q, ref.q) and torch.equal(z.scale, ref.scale)


# -------------------------------------------------------------- adamw8bit ----

SHAPES = {"a": (3, 700), "b": (5,), "c": {"d": (2, 128)}}


def _tree(rs, scale=1.0):
    return pytree.tree_map(lambda s: (rs.randn(*s) * scale).astype(
        np.float32), SHAPES, is_leaf=lambda s: isinstance(s, tuple))


def test_adam8bit_tracks_fp32_adam():
    """tests/test_optim.py::test_adam8bit_tracks_fp32_adam on the port."""
    target = torch.tensor([0.5, -1.5, 2.5, 0.1])
    loss = lambda x: torch.sum((x - target) ** 2)
    p32, p8 = {"x": torch.zeros(4)}, {"x": torch.zeros(4)}
    o32, o8 = adamw(0.05), adamw8bit(0.05)
    s32, s8 = o32.init(p32), o8.init(p8)
    for i in range(200):
        g32 = {"x": 2 * (p32["x"] - target)}
        g8 = {"x": 2 * (p8["x"] - target)}
        u32, s32 = o32.update(g32, s32, p32, i)
        u8, s8 = o8.update(g8, s8, p8, i)
        p32, p8 = apply_updates(p32, u32), apply_updates(p8, u8)
    assert float(loss(p8["x"])) < 1e-2
    np.testing.assert_allclose(p8["x"].numpy(), p32["x"].numpy(), atol=5e-2)
    np.testing.assert_allclose(p8["x"].numpy(), target.numpy(), atol=5e-2)


def test_adamw8bit_matches_jax():
    """20 steps of numpy gradients under the warmup-cosine schedule with
    weight decay, from the reference's init carried across
    (``quantized_state_from_jax``, equal to the port's own init): every
    payload within one unit, scales and params at 1e-6."""
    rs = np.random.RandomState(0)
    pj = jax.tree_util.tree_map(jnp.asarray, _tree(rs))
    pt = to_torch(pj)
    oj = jqs.adamw8bit(jax_warmup_cosine(1e-2, 1e-3, 5, 20),
                       weight_decay=0.1)
    ot = adamw8bit(linear_warmup_cosine(1e-2, 1e-3, 5, 20), weight_decay=0.1)
    sj = oj.init(pj)
    st = quantized_state_from_jax(jax.tree_util.tree_map(np.asarray, sj))
    assert type(st) is Adam8bitState
    own = ot.init(pt)
    for a, b in zip(pytree.tree_leaves(st), pytree.tree_leaves(own)):
        assert torch.equal(a, b)
    for i in range(20):
        g = _tree(rs, scale=i + 1.0)
        uj, sj = oj.update(jax.tree_util.tree_map(jnp.asarray, g), sj, pj, i)
        ut, st = ot.update(pytree.tree_map(torch.from_numpy, g), st, pt, i)
        pj, pt = jax_apply(pj, uj), apply_updates(pt, ut)
        for mt, mj in ((st.mu, sj.mu), (st.nu, sj.nu)):
            for a, b in zip(pytree.tree_leaves(mt, is_leaf=lambda t:
                                               isinstance(t, QTensor)),
                            jax.tree_util.tree_leaves(
                                mj, is_leaf=lambda t: isinstance(
                                    t, jqs.QTensor))):
                _qtensor_close(a, b)
        for a, b in zip(pytree.tree_leaves(pt), jax.tree_util.tree_leaves(pj)):
            _close(a, b, **ALGEBRA)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_update_in_place_equals_update_bit_for_bit(monkeypatch, dtype):
    """``update_in_place`` (chunks of whole blocks: 700 elements forced,
    512 taken, so the (3, 700) leaf spans five chunks, the last with the
    leaf's padding) against ``update`` + ``apply_updates`` on the clipped
    gradients: payloads, scales and params bit for bit over 3 steps."""
    monkeypatch.setattr(optimizers, "IN_PLACE_CHUNK", 700)
    rs = np.random.RandomState(5)
    p0 = pytree.tree_map(lambda a: torch.from_numpy(a).to(dtype), _tree(rs))
    opt = adamw8bit(linear_warmup_cosine(1e-2, 1e-3, 2, 20),
                    weight_decay=0.1)
    pf = pytree.tree_map(torch.clone, p0)
    pi = pytree.tree_map(torch.clone, p0)
    sf, si = opt.init(pf), opt.init(pi)
    for step in range(3):
        g = pytree.tree_map(lambda a: torch.from_numpy(a).to(dtype),
                            _tree(rs, scale=3.0))
        clipped, norm = clip_by_global_norm(g, 1.0)
        u, sf = opt.update(clipped, sf, pf, step)
        pf = apply_updates(pf, u)
        grads = pytree.tree_leaves(g)
        opt.update_in_place(grads, si, pi, step,
                            optimizers.clip_scale(norm, 1.0))
        assert grads == [None] * len(grads)
        for a, b in zip(pytree.tree_leaves(pi), pytree.tree_leaves(pf)):
            assert a.dtype == dtype and torch.equal(a, b)
        for a, b in zip(pytree.tree_leaves(si), pytree.tree_leaves(sf)):
            assert torch.equal(a, b)


def test_update_in_place_refuses_a_mismatched_tree():
    opt = adamw8bit(1e-3)
    p = {"w": torch.zeros(4)}
    with pytest.raises(ValueError, match="1 gradients for 2"):
        opt.update_in_place([torch.zeros(4)], opt.init(
            {"w": p["w"], "v": p["w"]}), {"w": p["w"], "v": p["w"]}, 0)


# ---------------------------------------------------------- grad compress ----

def test_grad_compression_error_feedback_unbiased():
    """tests/test_optim.py::test_grad_compression_error_feedback_unbiased
    on the port: SGD with compressed gradients converges."""
    target = torch.tensor([1.0, -1.0, 0.5])
    p = {"x": torch.zeros(3)}
    opt = sgd(0.05)
    st, ef = opt.init(p), init_error_feedback(p)
    for i in range(400):
        g_hat, ef = compress_with_feedback({"x": 2 * (p["x"] - target)}, ef)
        upd, st = opt.update(g_hat, st, p, i)
        p = apply_updates(p, upd)
    np.testing.assert_allclose(p["x"].numpy(), target.numpy(), atol=1e-2)


def test_compress_with_feedback_matches_jax():
    """Three steps on a tree: g_hat and the carried error against the
    reference's; g_hat + e' = g + e to float32 rounding, and each block's
    error at most half its scale (to the float32 rounding of its
    dequantized values)."""
    rs = np.random.RandomState(9)
    ej = jgc.init_error_feedback(jax.tree_util.tree_map(jnp.asarray,
                                                        _tree(rs)))
    et = init_error_feedback(pytree.tree_map(torch.from_numpy, _tree(rs)))
    for _ in range(3):
        g = _tree(rs, scale=2.0)
        gt = pytree.tree_map(torch.from_numpy, g)
        hj, ej_new = jgc.compress_with_feedback(
            jax.tree_util.tree_map(jnp.asarray, g), ej)
        ht, et_new = compress_with_feedback(gt, et)
        for a, b in zip(pytree.tree_leaves(ht), jax.tree_util.tree_leaves(hj)):
            _close(a, b, **ALGEBRA)
        for a, b in zip(pytree.tree_leaves(et_new),
                        jax.tree_util.tree_leaves(ej_new)):
            _close(a, b, **ALGEBRA)
        for h, e2, gg, e in zip(*(pytree.tree_leaves(t) for t in
                                  (ht, et_new, gt, et))):
            np.testing.assert_allclose((h + e2).numpy(), (gg + e).numpy(),
                                       rtol=1e-6, atol=1e-6)
            scale = quantize_blockwise(gg + e).scale
            err = torch.nn.functional.pad(
                e2.reshape(-1), (0, (-e2.numel()) % BLOCK)).reshape(-1, BLOCK)
            # half a scale, up to the float32 rounding of g / scale and of
            # q * scale (2^-24 of 128 scales each: 2^-15 of half a scale)
            assert bool((err.abs() <= scale / 2 * (1 + 2.0 ** -15)).all())
        ej, et = ej_new, et_new


@contextlib.contextmanager
def _one_rank_mesh():
    """A (data 1, model 1) mesh over a one-rank gloo group."""
    import socket
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_compressed_allreduce_mean_names_its_roadmap_item():
    """Ported by ROADMAP item 12 (it raised naming that item before): over
    a one-rank gloo group the int8 mean of x is x's own int8 round trip,
    dequantize(quantize(x)), bit for bit; four ranks are
    tests/test_torch_distributed.py's."""
    with _one_rank_mesh() as mesh:
        x = torch.from_numpy(np.random.RandomState(2).randn(37, 11)
                             .astype(np.float32))
        got = compressed_allreduce_mean(x, mesh, axis="data")
        want = dequantize_blockwise(quantize_blockwise(x), x.shape)
        assert got.dtype == x.dtype and torch.equal(got, want)


def test_8bit_moments_refuse_a_mesh():
    """8-bit moments have no sharded update: DTensor params raise, naming
    ROADMAP.md (the reference's TRAIN_SETTINGS never pair them with a
    mesh)."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    with _one_rank_mesh() as mesh:
        p = distribute_tensor(torch.ones(4, 300), mesh,
                              (Replicate(), Replicate()))
        opt = adamw8bit(1e-3)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            opt.update_in_place([torch.ones(4, 300)], opt.init([p]), [p], 0)


# ------------------------------------------------------ chunked attention ----

@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None)])
def test_chunked_attention_matches_dense(monkeypatch, causal, window):
    """tests/test_nn_layers.py::test_chunked_attention_matches_dense on
    the port (its bound against the unchunked plain version), and
    against the reference's chunked ``mha`` on the same input. Under
    chunking the CPU attends chunk by chunk (the flash wrapper is never
    called)."""
    d, H, KV, hd, S = 16, 4, 2, 4, 32
    pj = jatt.attention_init(jax.random.PRNGKey(0), d, H, KV, hd)
    pt = to_torch(pj)
    x = np.random.RandomState(30).randn(2, S, d).astype(np.float32)
    kw = dict(n_heads=H, n_kv=KV, d_head=hd, causal=causal, window=window)
    dense = tatt.mha(pt, torch.from_numpy(x), **kw)

    def no_flash(*a, **k):
        raise AssertionError("flash_attention called under chunking")

    jatt.set_attention_chunking(8)
    tatt.set_attention_chunking(8)
    try:
        ref = jatt.mha(pj, jnp.asarray(x), **kw)
        with monkeypatch.context() as m:
            m.setattr(tatt, "flash_attention", no_flash)
            out = tatt.mha(pt, torch.from_numpy(x), **kw)
    finally:
        jatt.set_attention_chunking(None)
        tatt.set_attention_chunking(None)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), rtol=2e-4,
                               atol=2e-5)
    _close(out, ref)


def test_chunking_applies_where_the_reference_chunks(monkeypatch):
    """Only self-attention with S > chunk and S % chunk == 0 is chunked:
    S 12 under a chunk of 8, S 8 and cross-attention go through the
    flash wrapper."""
    pj = jatt.attention_init(jax.random.PRNGKey(0), 16, 4, 2, 4)
    pt = to_torch(pj)
    calls = []
    flash = tatt.flash_attention
    monkeypatch.setattr(tatt, "flash_attention",
                        lambda *a, **k: calls.append(1) or flash(*a, **k))
    kw = dict(n_heads=4, n_kv=2, d_head=4)
    tatt.set_attention_chunking(8)
    try:
        for S in (12, 8):
            tatt.mha(pt, torch.zeros(1, S, 16), **kw)
        tatt.mha(pt, torch.zeros(1, 16, 16), kv_x=torch.ones(1, 16, 16),
                 **kw)
        assert len(calls) == 3
        tatt.mha(pt, torch.zeros(1, 16, 16), **kw)
        assert len(calls) == 3
    finally:
        tatt.set_attention_chunking(None)


def test_chunked_lm_loss_matches_jax():
    """``lm_loss`` of reduced qwen3_4b (2 layers) over 16 positions under
    a chunk of 4 on both sides."""
    cfg_j = dataclasses.replace(jax_configs.get("qwen3_4b").reduced(),
                                n_layers=2)
    cfg_t = dataclasses.replace(torch_configs.get("qwen3_4b").reduced(),
                                n_layers=2)
    pj = jlm.init_lm(jax.random.PRNGKey(1), cfg_j)
    pt = to_torch(pj)
    rs = np.random.RandomState(2)
    toks, tgts = (rs.randint(0, cfg_j.vocab, (2, 16)).astype(np.int32)
                  for _ in range(2))
    jatt.set_attention_chunking(4)
    tatt.set_attention_chunking(4)
    try:
        lj, _ = jlm.lm_loss(pj, cfg_j, jnp.asarray(toks), jnp.asarray(tgts))
        lt, _ = tlm.lm_loss(pt, cfg_t, torch.from_numpy(toks),
                            torch.from_numpy(tgts))
    finally:
        jatt.set_attention_chunking(None)
        tatt.set_attention_chunking(None)
    _close(lt, lj)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
def test_chunked_prefill_matches_unchunked(kv_int8):
    """``lm_prefill`` of reduced qwen3_4b over 16 positions (a chunk of 4,
    with either cache) against the unchunked prefill: logits and caches
    to the float32 tolerance (the two attend in other orders)."""
    cfg = dataclasses.replace(torch_configs.get("qwen3_4b").reduced(),
                              n_layers=2)
    pt = tlm.init_lm(torch.Generator().manual_seed(3), cfg)
    toks = torch.from_numpy(np.random.RandomState(5).randint(
        0, cfg.vocab, (2, 16)))
    out = []
    tlm.set_perf_options(kv_int8=kv_int8)
    try:
        for chunk in (None, 4):
            tatt.set_attention_chunking(chunk)
            try:
                out.append(tlm.lm_prefill(pt, cfg, toks, tlm.init_lm_cache(
                    cfg, 2, 20)))
            finally:
                tatt.set_attention_chunking(None)
    finally:
        tlm.set_perf_options(kv_int8=False)
    (l0, c0), (l1, c1) = out
    _close(l1, l0.numpy())
    for a, b in zip(pytree.tree_leaves(c1), pytree.tree_leaves(c0)):
        assert a.dtype == (torch.int8 if kv_int8 and a.ndim == 5
                           else torch.float32)
        if a.dtype == torch.int8:
            _payload_close(a, b.numpy())
        else:
            _close(a, b.numpy())


# ----------------------------------------------------------- MoE int8 ----

D, D_FF = 16, 32


def _moe(E=4, seed=0):
    pj = jmoe.moe_init(jax.random.PRNGKey(seed), D, D_FF, E)
    return pj, to_torch(pj)


def test_moe_int8_dispatch_close_to_fp():
    """tests/test_nn_layers.py::test_moe_int8_dispatch_close_to_fp on the
    port, and its int8 output and terms against the reference's."""
    pj, pt = _moe()
    x = np.random.RandomState(41).randn(2, 16, D).astype(np.float32)
    kw = dict(n_experts=4, top_k=2, capacity_factor=4.0)
    fp = tmoe.moe_apply_sorted(pt, torch.from_numpy(x), **kw)
    q = tmoe.moe_apply_sorted(pt, torch.from_numpy(x), int8_dispatch=True,
                              **kw)
    err = float(torch.mean(torch.abs(fp.y - q.y)))
    assert err / (float(torch.mean(torch.abs(fp.y))) + 1e-9) < 0.05
    assert not torch.equal(fp.y, q.y)
    qj = jmoe.moe_apply_sorted(pj, jnp.asarray(x), int8_dispatch=True, **kw)
    _close(q.y, qj.y)
    for a, b in zip(q[1:], qj[1:]):
        _close(a, b, **ALGEBRA)
    for a, b in zip(q[1:], fp[1:]):     # the router reads unquantized x
        assert torch.equal(a, b)


@pytest.mark.parametrize("drops", [False, True], ids=["kept", "dropped"])
def test_moe_int8_dispatch_grads_match_jax(drops):
    """Gradients of sum(y^2) + aux + z through the int8 dispatch against
    ``jax.grad``: the int8 cast cuts the expert input's gradient, which
    reaches x only through the scales' amax; token 0 has its largest
    |value| twice (a tie, whose gradient both packages split evenly)."""
    pj, pt = _moe()
    x = np.random.RandomState(23).randn(1, 16, D).astype(np.float32)
    top = np.abs(x[0, 0]).max() + 0.5
    x[0, 0, 3], x[0, 0, 5] = -top, top
    kw = dict(n_experts=4, top_k=2, capacity_factor=0.5 if drops else 4.0,
              int8_dispatch=True)

    def loss_j(p, xx):
        o = jmoe.moe_apply_sorted(p, xx, **kw)
        return jnp.sum(o.y ** 2) + o.aux_loss + o.router_z_loss, \
            o.fraction_dropped

    (lj, dropped), (gpj, gxj) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(pj, jnp.asarray(x))
    assert (float(dropped) > 0) == drops
    pt = pytree.tree_map(lambda t: t.clone().requires_grad_(), pt)
    xt = torch.from_numpy(x).requires_grad_()
    o = tmoe.moe_apply_sorted(pt, xt, **kw)
    lt = torch.sum(o.y ** 2) + o.aux_loss + o.router_z_loss
    lt.backward()
    _close(lt, lj)
    _close(xt.grad, gxj)
    assert float(xt.grad[0, 0, 3]) != 0 and float(xt.grad[0, 0, 5]) != 0
    for key in gpj:
        gj = gpj[key]["kernel"] if key == "router" else gpj[key]
        gt = pt[key]["kernel"].grad if key == "router" else pt[key].grad
        _close(gt, gj)


def test_int8_dispatch_through_lm_loss_matches_jax():
    """``set_perf_options(int8_dispatch=True)`` on both sides: reduced
    olmoe_1b_7b's ``lm_loss`` (the full-sequence rule, sorted dispatch in
    int8) against the reference's, and apart from the loss without int8
    (the gradients are held at the layer, above)."""
    cfg_j = dataclasses.replace(jax_configs.get("olmoe_1b_7b").reduced(),
                                n_layers=2)
    cfg_t = dataclasses.replace(torch_configs.get("olmoe_1b_7b").reduced(),
                                n_layers=2)
    pj = jlm.init_lm(jax.random.PRNGKey(1), cfg_j)
    pt = to_torch(pj)
    rs = np.random.RandomState(4)
    toks, tgts = (rs.randint(0, cfg_j.vocab, (2, 8)).astype(np.int32)
                  for _ in range(2))
    plain, _ = tlm.lm_loss(pt, cfg_t, torch.from_numpy(toks),
                           torch.from_numpy(tgts))
    jlm.set_perf_options(int8_dispatch=True)
    tlm.set_perf_options(int8_dispatch=True)
    try:
        lj, _ = jlm.lm_loss(pj, cfg_j, jnp.asarray(toks), jnp.asarray(tgts))
        lt, _ = tlm.lm_loss(pt, cfg_t, torch.from_numpy(toks),
                            torch.from_numpy(tgts))
    finally:
        jlm.set_perf_options(int8_dispatch=False)
        tlm.set_perf_options(int8_dispatch=False)
    _close(lt, lj)
    assert float(lt) != float(plain)


def test_perf_options_as_the_reference():
    assert tlm.PERF_OPT == jlm.PERF_OPT == {"int8_dispatch": False,
                                            "kv_int8": False}
    with pytest.raises(KeyError, match="unknown performance option"):
        tlm.set_perf_options(weights_int8=True)
    assert tlm.PERF_OPT == {"int8_dispatch": False, "kv_int8": False}


# -------------------------------------------------------------- KV int8 ----

def test_quantize_kv_matches_jax():
    x = np.random.RandomState(3).randn(2, 5, 3, 8).astype(np.float32)
    x[0, 0, 0] = 0.0                    # a zero row: the floored scale
    qt, st = tatt._quantize_kv(torch.from_numpy(x))
    qj, sj = jatt._quantize_kv(jnp.asarray(x))
    assert st.shape == (2, 5, 3) and st.dtype == torch.float32
    _payload_close(qt, qj)
    _close(st, sj, **ALGEBRA)
    assert float(st[0, 0, 0]) == np.float32(1e-12)


def test_int8_kv_cache_decode_close_to_bf16():
    """tests/test_nn_layers.py::test_int8_kv_cache_decode_close_to_bf16
    on the port (token-by-token decode through an int8 cache against the
    full-sequence ``mha``), and each step's output and the cache against
    the reference's decode chain."""
    d, H, KV, hd, S = 32, 4, 2, 8, 12
    pj = jatt.attention_init(jax.random.PRNGKey(0), d, H, KV, hd)
    pt = to_torch(pj)
    x = np.random.RandomState(42).randn(2, S, d).astype(np.float32)
    kw = dict(n_heads=H, n_kv=KV, d_head=hd)
    full = tatt.mha(pt, torch.from_numpy(x), **kw)
    cj = jatt.init_cache(2, S, KV, hd, kv_int8=True)
    ct = tatt.init_cache(2, S, KV, hd, kv_int8=True)
    assert {k: (v.dtype, tuple(v.shape)) for k, v in ct.items()} == {
        "k": (torch.int8, (2, S, KV, hd)), "v": (torch.int8, (2, S, KV, hd)),
        "k_scale": (torch.float32, (2, S, KV)),
        "v_scale": (torch.float32, (2, S, KV))}
    outs = []
    for t in range(S):
        oj, cj = jatt.mha_decode(pj, jnp.asarray(x[:, t:t + 1]), cj,
                                 jnp.asarray(t), **kw)
        o, ct = tatt.mha_decode(pt, torch.from_numpy(x[:, t:t + 1]), ct, t,
                                **kw)
        _close(o, oj)
        outs.append(o)
    dec = torch.cat(outs, dim=1)
    err = float(torch.mean(torch.abs(full - dec)))
    assert err / (float(torch.mean(torch.abs(full))) + 1e-9) < 0.02
    for k in ("k", "v"):
        _payload_close(ct[k], cj[k])
        _close(ct[k + "_scale"], cj[k + "_scale"], rtol=1e-5, atol=1e-12)
