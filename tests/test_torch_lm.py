"""The port's LM (repro_torch/models, repro_torch/nn) held against the JAX
package's, fp32, vocab 256, d 64, 4 heads, on five reduced models:
``qwen3_4b.reduced()`` at 4 layers (dense blocks, kv 2, 12 tokens),
``recurrentgemma_2b.reduced()`` at 14 layers (4 groups of rec, rec, attn
plus 2 tail rec layers, MQA, local window 8, 16 tokens so the window
binds), ``rwkv6_1p6b.reduced()`` at 8 layers (8 rwkv groups, 4 WKV
heads of 16, 16 tokens), ``olmoe_1b_7b.reduced()`` at 4 layers (moe
blocks, MHA 4/4, qk-norm, top-2 of 4 experts, 12 tokens) and
``llama4_maverick_400b_a17b.reduced()`` at 4 layers (2 groups of dense,
moe; top-1 of 4 experts and a shared expert; 12 tokens). Weights are
drawn by the JAX package and carried across with
``convert.params_from_jax``; tokens come from numpy. Tolerance fp32
rtol = atol = 1e-4: XLA and PyTorch sum matmuls in different orders (and
the reference scans the RG-LRU associatively, the port sequentially).
Every token the port routes has its k-th router probability above its
(k+1)-th by more than ``MARGIN`` (asserted), so no rounding difference
can move a token to another expert."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from port_isolation import port_module_isolation  # noqa: F401
from test_torch_moe import MARGIN, routing_margins

from repro import configs as jax_configs
from repro.models import cdepth as jcd
from repro.models import lm as jlm
from repro_torch import configs as torch_configs
from repro_torch.convert import params_from_jax
from repro_torch.core.integrate import Integrator
from repro_torch.core.solvers import FixedGrid
from repro_torch.core.tableaus import EULER
from repro_torch.models import cdepth as tcd
from repro_torch.models import lm as tlm

TOL = dict(rtol=1e-4, atol=1e-4)

# arch -> (layers, prompt tokens) of the reduced model under test
ARCHS = {"qwen3_4b": (4, 12), "recurrentgemma_2b": (14, 16),
         "rwkv6_1p6b": (8, 16), "olmoe_1b_7b": (4, 12),
         "llama4_maverick_400b_a17b": (4, 12)}


@pytest.fixture(scope="module", params=list(ARCHS))
def model(request):
    n_layers, n_tok = ARCHS[request.param]
    cfg_j = dataclasses.replace(jax_configs.get(request.param).reduced(),
                                n_layers=n_layers)
    cfg_t = dataclasses.replace(torch_configs.get(request.param).reduced(),
                                n_layers=n_layers)
    pj = jlm.init_lm(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    toks = np.random.RandomState(0).randint(0, cfg_j.vocab, (3, n_tok))
    return cfg_j, cfg_t, pj, pt, toks.astype(np.int32)


def test_griffin_model_layout():
    """The Griffin model under test: 4 groups of (rec, rec, attn) plus 2
    tail rec layers, whose attn blocks attend over the local window."""
    n_layers, n_tok = ARCHS["recurrentgemma_2b"]
    cfg = dataclasses.replace(torch_configs.get("recurrentgemma_2b")
                              .reduced(), n_layers=n_layers)
    assert tlm.group_layout(cfg) == (("rec", "rec", "attn"), 4, 2)
    assert tlm._attn_kwargs(cfg, "attn")["window"] == cfg.local_window == 8
    assert n_tok > cfg.local_window
    assert tlm._attn_kwargs(torch_configs.get("qwen3_4b"),
                            "dense")["window"] is None


def test_moe_model_layouts():
    """The MoE models under test: OLMoE's every block a moe block with
    stacked experts; llama4's groups of (dense, moe), the moe block with
    a shared expert of the dense width."""
    cfg = dataclasses.replace(torch_configs.get("olmoe_1b_7b").reduced(),
                              n_layers=ARCHS["olmoe_1b_7b"][0])
    assert tlm.group_layout(cfg) == (("moe",), 4, 0)
    assert (cfg.n_experts, cfg.top_k, cfg.n_kv) == (4, 2, cfg.n_heads)
    moe = tlm.init_lm(torch.Generator().manual_seed(0), cfg)["groups"]["b0"]
    assert sorted(moe) == ["attn", "ln1", "ln2", "moe"]
    assert moe["moe"]["wi"].shape == (4, 4, cfg.d_model, cfg.d_ff_expert)
    assert moe["moe"]["wd"].shape == (4, 4, cfg.d_ff_expert, cfg.d_model)
    cfg = torch_configs.get("llama4_maverick_400b_a17b").reduced()
    assert tlm.group_layout(cfg) == (("dense", "moe"), 2, 0)
    blocks = tlm.init_lm(torch.Generator().manual_seed(0), cfg)["groups"]
    assert sorted(blocks["b1"]) == ["attn", "ln1", "ln2", "moe", "shared"]
    assert blocks["b1"]["shared"]["wi"]["kernel"].shape == \
        (2, cfg.d_model, cfg.d_ff)
    assert (cfg.n_experts, cfg.top_k) == (4, 1)


def test_rwkv6_model_layout():
    """The RWKV6 model under test: one rwkv block per group, 8 groups, no
    tail, 4 WKV heads of the kernel's head size 16, an untied head."""
    n_layers, n_tok = ARCHS["rwkv6_1p6b"]
    cfg = dataclasses.replace(torch_configs.get("rwkv6_1p6b").reduced(),
                              n_layers=n_layers)
    assert tlm.group_layout(cfg) == (("rwkv",), 8, 0)
    assert cfg.d_model // cfg.rwkv_heads == 16 and not cfg.tie_embeddings
    params = tlm.init_lm(torch.Generator().manual_seed(0), cfg)
    assert sorted(params["groups"]["b0"]) == ["cmix", "ln1", "ln2", "tmix"]
    assert params["groups"]["b0"]["tmix"]["lora_a2"].shape == \
        (8, 5, cfg.lora_rank, cfg.d_model)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


def test_configs_equal_reference():
    assert torch_configs.ARCH_IDS == jax_configs.ARCH_IDS
    for name in jax_configs.ARCH_IDS:
        cj, ct = jax_configs.get(name), torch_configs.get(name)
        assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
        assert dataclasses.asdict(ct.reduced()) == \
            dataclasses.asdict(cj.reduced())
    assert {k: dataclasses.asdict(v) for k, v in torch_configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jax_configs.SHAPES.items()}


def test_params_carry_across_leaf_for_leaf(model):
    _, cfg_t, pj, pt, _ = model
    flat_j = jax.tree_util.tree_flatten_with_path(pj)[0]
    assert len(flat_j) == len(jax.tree_util.tree_leaves(pt))
    for path, leaf in flat_j:
        node = pt
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    # the port's own init draws the same tree of shapes and dtypes
    own = tlm.init_lm(torch.Generator().manual_seed(0), cfg_t)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, own)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0, pt))
    for a, b in zip(jax.tree_util.tree_leaves(own),
                    jax.tree_util.tree_leaves(pt)):
        assert a.shape == b.shape and a.dtype == b.dtype


def _margin_held(gaps, cfg):
    """Every routed token cleared the margin (and a MoE config routed)."""
    assert bool(gaps) == bool(cfg.n_experts)
    assert not gaps or min(gaps) > MARGIN, min(gaps)


def test_lm_forward_matches_jax(model):
    """Logits and the aux tree (the MoE load-balance and z terms summed
    over groups, the dropped fraction a max within a group)."""
    cfg_j, cfg_t, pj, pt, toks = model
    lj, aj = jlm.lm_forward(pj, cfg_j, jnp.asarray(toks))
    with routing_margins() as gaps:
        lt, at = tlm.lm_forward(pt, cfg_t, torch.from_numpy(toks))
    _margin_held(gaps, cfg_t)
    assert lt.dtype == torch.float32 and lt.shape == (*toks.shape, cfg_t.vocab)
    _close(lt, lj)
    assert sorted(at) == sorted(aj)
    for k in aj:
        assert at[k].shape == () and at[k].dtype == torch.float32
        _close(at[k], aj[k], rtol=1e-5, atol=1e-6)
    if cfg_t.n_experts:
        assert float(at["moe_aux"]) > 0 and float(at["moe_z"]) > 0


def test_lm_loss_and_grads_match_jax(model):
    """``lm_loss`` (cross-entropy plus the weighted MoE aux and z terms)
    and its gradient with respect to every parameter leaf."""
    cfg_j, cfg_t, pj, pt, toks = model
    tgts = np.random.RandomState(1).randint(
        0, cfg_j.vocab, toks.shape).astype(np.int32)
    (lj, mj), gj = jax.value_and_grad(
        lambda p: jlm.lm_loss(p, cfg_j, jnp.asarray(toks),
                              jnp.asarray(tgts)), has_aux=True)(pj)
    pt = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(), pt)
    with routing_margins() as gaps:
        lt, mt = tlm.lm_loss(pt, cfg_t, torch.from_numpy(toks),
                             torch.from_numpy(tgts))
    _margin_held(gaps, cfg_t)
    lt.backward()
    _close(lt, lj, rtol=1e-5, atol=1e-5)
    assert sorted(mt) == sorted(mj)
    for k in mj:
        _close(mt[k], mj[k], rtol=1e-5, atol=1e-5)
    flat = jax.tree_util.tree_flatten_with_path(gj)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(pt))
    for path, g in flat:
        node = pt
        for k in path:
            node = node[k.key]
        _close(node.grad, g, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("s", [0.0, 0.3, 0.5, 0.75, 0.999, 1.0])
def test_depth_field_scalar_s_matches_jax(model, s):
    cfg_j, cfg_t, pj, pt, toks = model
    hj = jlm._embed(pj, cfg_j, jnp.asarray(toks))
    ht = tlm._embed(pt, cfg_t, torch.from_numpy(toks))
    fj, ft = jcd.depth_field(pj, cfg_j), tcd.depth_field(pt, cfg_t)
    _close(ft(s, ht), fj(s, hj))
    _close(ft(torch.tensor(s, dtype=torch.float32), ht),
           fj(jnp.asarray(s, jnp.float32), hj))


def test_depth_field_per_sample_s_matches_jax(model):
    """A (B,) depth row sends samples to different layer groups in one
    evaluation (the port splits the batch by group); on a MoE model every
    row routes alone, the reference's ``vmap`` over samples, also when
    every row maps to the same group."""
    cfg_j, cfg_t, pj, pt, toks = model
    hj = jlm._embed(pj, cfg_j, jnp.asarray(toks))
    ht = tlm._embed(pt, cfg_t, torch.from_numpy(toks))
    s = np.array([0.75, 0.0, 0.5], np.float32)
    out_j = jcd.depth_field(pj, cfg_j)(jnp.asarray(s), hj)
    out_t = tcd.depth_field(pt, cfg_t)(torch.from_numpy(s), ht)
    _close(out_t, out_j)
    same = np.array([0.25, 0.25, 0.25], np.float32)
    _close(tcd.depth_field(pt, cfg_t)(torch.from_numpy(same), ht),
           jcd.depth_field(pj, cfg_j)(jnp.asarray(same), hj))


def _jax_mesh_indices(n_groups, Ks, k_max, batched):
    """Group indices of the reference's mesh points, with its float32
    arithmetic (integrate.py solve / solve_multirate, cdepth.py f)."""
    out = []
    for k in range(k_max):
        if batched:
            eps = jnp.asarray(1.0) / jnp.asarray(Ks, jnp.int32)
            s = jnp.zeros_like(eps) if k == 0 else 0.0 + jnp.int32(k) * eps
        else:
            s = 0.0 + jnp.int32(k) * (1.0 / k_max)
        out.append(np.asarray(jnp.clip(
            jnp.floor(s * n_groups).astype(jnp.int32), 0, n_groups - 1)))
    return out


@pytest.mark.parametrize("n_groups", [4, 36])
def test_group_index_at_mesh_points_matches_jax(n_groups):
    """floor(s * n_groups) at every mesh point the solvers visit, fixed-K
    and multi-rate, including meshes where s * n_groups lands on an
    integer (n_groups = 36 with K = 4, 8, 36): an index off by one would
    run the wrong layer group."""
    for K in range(1, 37):
        seen = []
        f = lambda s, z: (seen.append(tcd._group_index(s, n_groups)),  # noqa
                          torch.zeros_like(z))[1]
        Integrator(EULER).solve(f, torch.zeros(1, 1),
                                FixedGrid.over(0.0, 1.0, K),
                                return_traj=False)
        ref = _jax_mesh_indices(n_groups, None, K, batched=False)
        assert [int(i) for i in seen] == [int(i) for i in ref], K
    Ks = np.array([1, 3, 4, 8, 9, 12, 16, 36], np.int32)
    seen = []
    f = lambda s, z: (seen.append(tcd._group_index(s, n_groups)),  # noqa
                      torch.zeros_like(z))[1]
    Integrator(EULER).solve_multirate(f, torch.zeros(len(Ks), 1),
                                      (0.0, 1.0), Ks, 36)
    ref = _jax_mesh_indices(n_groups, Ks, 36, batched=True)
    assert len(seen) == len(ref)
    for a, b in zip(seen, ref):
        np.testing.assert_array_equal(a.numpy(), b)


def test_cdepth_full_k_equals_lm_forward(model):
    cfg_j, cfg_t, pj, pt, toks = model
    n = tlm.group_layout(cfg_t)[1]
    full, _ = tlm.lm_forward(pt, cfg_t, torch.from_numpy(toks))
    cd = tcd.lm_forward_cdepth(pt, cfg_t, torch.from_numpy(toks), K=n)
    _close(cd, full.numpy(), rtol=1e-5, atol=1e-5)
    for K in (2, n):
        _close(tcd.lm_forward_cdepth(pt, cfg_t, torch.from_numpy(toks), K=K),
               jcd.lm_forward_cdepth(pj, cfg_j, jnp.asarray(toks), K=K))


def test_lm_g_apply_matches_jax(model):
    cfg_j, cfg_t, pj, pt, toks = model
    gj = jcd.lm_g_init(jax.random.PRNGKey(5), cfg_j, rank=8)
    gj = dict(gj, w_out=0.1 * jax.random.normal(jax.random.PRNGKey(6),
                                                gj["w_out"].shape))
    gt = params_from_jax(jax.tree_util.tree_map(np.asarray, gj))
    rs = np.random.RandomState(7)
    h = rs.randn(3, 12, cfg_t.d_model).astype(np.float32)
    dh = rs.randn(3, 12, cfg_t.d_model).astype(np.float32)
    for s_j, s_t in [(0.0, 0.0), (0.375, 0.375),
                     (jnp.asarray([0.0, 0.5, 0.875]),
                      torch.tensor([0.0, 0.5, 0.875]))]:
        out_j = jcd.lm_g_apply(gj, 0.5, s_j, None, jnp.asarray(h),
                               jnp.asarray(dh))
        out_t = tcd.lm_g_apply(gt, 0.5, s_t, None, torch.from_numpy(h),
                               torch.from_numpy(dh))
        _close(out_t, out_j)


def _same_tree(own, ref):
    """``own`` has ``ref``'s tree (keys at every level), shapes and
    dtypes."""
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, own)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0, ref))
    for a, b in zip(jax.tree_util.tree_leaves(own),
                    jax.tree_util.tree_leaves(ref)):
        assert tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype


@pytest.mark.parametrize("arch", ["paligemma_3b", "whisper_base"])
def test_unported_block_kinds_name_their_roadmap_item(arch):
    """paligemma's patch frontend and whisper's learned positions and
    encoder-decoder, once ROADMAP item 6, are ported: ``init_lm`` (and for
    whisper ``init_encdec``) draw the reference's tree of shapes and
    dtypes (``patch_proj``; ``pos_embed`` of 8,192 rows; the stacked
    encoder and decoder blocks), and ``params_from_jax`` carries the
    reference's weights leaf for leaf."""
    from repro.models import encdec as jed
    from repro_torch.models import encdec as ted
    cfg_j = jax_configs.get(arch).reduced()
    cfg_t = torch_configs.get(arch).reduced()
    inits = [(jlm.init_lm, tlm.init_lm)]
    if cfg_t.is_encdec:
        inits.append((jed.init_encdec, ted.init_encdec))
    for init_j, init_t in inits:
        ref = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda k: init_j(k, cfg_j))(jax.random.PRNGKey(0)))
        carried = params_from_jax(ref)
        _same_tree(init_t(torch.Generator().manual_seed(0), cfg_t), carried)
        for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
            node = carried
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(node.numpy(), leaf)
    own = tlm.init_lm(torch.Generator().manual_seed(0), cfg_t)
    assert ("patch_proj" in own) == (arch == "paligemma_3b")
    assert ("pos_embed" in own) == (arch == "whisper_base")


def test_lm_loss_refuses_unported_options():
    """``lm_loss(frontend=)`` (reduced paligemma: 8 patch embeddings
    projected and prepended, the loss over the text positions only) and
    its gradient against the reference's; every remat policy is accepted
    and gives the same loss (bit for bit: tests/test_torch_train.py)."""
    cfg_j = jax_configs.get("paligemma_3b").reduced()
    cfg = torch_configs.get("paligemma_3b").reduced()
    pj = jax.jit(lambda k: jlm.init_lm(k, cfg_j))(jax.random.PRNGKey(2))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    rs = np.random.RandomState(3)
    toks = rs.randint(0, cfg.vocab, (2, 6)).astype(np.int32)
    tgts = rs.randint(0, cfg.vocab, (2, 6)).astype(np.int32)
    fe = rs.randn(2, cfg.n_frontend_tokens, cfg.d_model).astype(np.float32)
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, cfg_j, jnp.asarray(toks), jnp.asarray(tgts),
                              frontend=jnp.asarray(fe)), has_aux=True))(pj)
    live = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(),
                                  params)
    lt, mt = tlm.lm_loss(live, cfg, torch.from_numpy(toks),
                         torch.from_numpy(tgts), frontend=torch.from_numpy(fe))
    lt.backward()
    _close(lt, lj, rtol=1e-5, atol=1e-5)
    for path, g in jax.tree_util.tree_flatten_with_path(gj)[0]:
        node = live
        for k in path:
            node = node[k.key]
        _close(node.grad, g, rtol=1e-4, atol=1e-5)
    assert float(live["patch_proj"]["kernel"].grad.abs().max()) > 0
    t = torch.from_numpy(toks)
    losses = [tlm.lm_loss(params, cfg, t, t, frontend=torch.from_numpy(fe),
                          remat=r)[0] for r in ("none", "dots", "full")]
    assert all(torch.equal(l, losses[0]) for l in losses)
