"""The port's patch frontend and learned positions (repro_torch/models/lm.py,
models/cdepth.py) held against the JAX package on the CPU, float32.

Mirrors tests/test_cdepth.py on the two configs that ROADMAP item 6
added: ``paligemma_3b.reduced()`` (2 dense layers, d 64, MQA 4/1 of 16,
GeGLU, tied and scaled embeddings, 8 patch embeddings projected by
``patch_proj`` and prepended to 6 text tokens) through ``lm_forward``,
``discrete_depth_trajectory``, ``lm_forward_cdepth`` and ``depth_probe``
with ``frontend=``; and ``whisper_base.reduced()`` through ``init_lm``
(the reference's decoder-only LM with a learned position table, as its
serving CLI builds it) through ``lm_forward``, the cached prefill and
decode, and the depth path, which leaves the learned positions out in
both packages (a kept reference behaviour). Weights are drawn by the JAX
package and carried across with ``convert.params_from_jax``; inputs come
from numpy. Tolerance through matmuls: rtol = atol = 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_isolation import port_module_isolation  # noqa: F401
from repro import configs as jax_configs
from repro.core.controllers import EmbeddedErrorController as JaxProbe
from repro.models import cdepth as jcd
from repro.models import lm as jlm
from repro_torch import configs as torch_configs
from repro_torch.convert import params_from_jax
from repro_torch.core.controllers import EmbeddedErrorController
from repro_torch.models import cdepth as tcd
from repro_torch.models import lm as tlm

TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 6


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


@pytest.fixture(scope="module", params=["paligemma_3b", "whisper_base"])
def model(request):
    """(cfg_j, cfg_t, JAX params, the port's copy, tokens, frontend or
    None) of the reduced config."""
    cfg_j = jax_configs.get(request.param).reduced()
    cfg_t = torch_configs.get(request.param).reduced()
    pj = jax.jit(lambda k: jlm.init_lm(k, cfg_j))(jax.random.PRNGKey(1))
    rs = np.random.RandomState(2)
    toks = rs.randint(0, cfg_j.vocab, (B, S)).astype(np.int32)
    fe = rs.randn(B, cfg_j.n_frontend_tokens, cfg_j.d_model).astype(
        np.float32) if cfg_j.frontend == "patches" else None
    return (cfg_j, cfg_t, pj, params_from_jax(jax.tree_util.tree_map(
        np.asarray, pj)), toks, fe)


def _inputs(toks, fe):
    """(JAX kwargs, port kwargs) of the tokens and the frontend."""
    return (dict(tokens=jnp.asarray(toks),
                 frontend=None if fe is None else jnp.asarray(fe)),
            dict(tokens=torch.from_numpy(toks),
                 frontend=None if fe is None else torch.from_numpy(fe)))


def test_lm_forward_matches_jax(model):
    """Logits over the frontend's rows and the text (paligemma), and with
    learned positions added over the sequence (whisper_base)."""
    cfg_j, cfg_t, pj, pt, toks, fe = model
    kj, kt = _inputs(toks, fe)
    lj, _ = jlm.lm_forward(pj, cfg_j, **kj)
    lt, _ = tlm.lm_forward(pt, cfg_t, **kt)
    n_fe = 0 if fe is None else fe.shape[1]
    assert lt.shape == (B, n_fe + S, cfg_t.vocab)
    _close(lt, lj)


def test_cdepth_with_frontend_matches_jax(model):
    """``discrete_depth_trajectory``, ``lm_forward_cdepth`` (K 1 and
    n_groups, euler and a fused euler) and ``depth_probe`` (K, error and
    first stage of an embedded probe) with ``frontend=``."""
    cfg_j, cfg_t, pj, pt, toks, fe = model
    kj, kt = _inputs(toks, fe)
    n = tlm.group_layout(cfg_t)[1]
    _close(tcd.discrete_depth_trajectory(pt, cfg_t, **kt),
           jcd.discrete_depth_trajectory(pj, cfg_j, **kj))
    for K in (1, n):
        want = jcd.lm_forward_cdepth(pj, cfg_j, K=K, **kj)
        _close(tcd.lm_forward_cdepth(pt, cfg_t, K=K, **kt), want)
        _close(tcd.lm_forward_cdepth(pt, cfg_t, K=K, fused=True, **kt), want)
    pj_ = jcd.depth_probe(pj, cfg_j, kj["tokens"], JaxProbe(tol=1e-2),
                          frontend=kj["frontend"])
    pt_ = tcd.depth_probe(pt, cfg_t, kt["tokens"],
                          EmbeddedErrorController(tol=1e-2),
                          frontend=kt["frontend"])
    _close(pt_.err, pj_.err)
    _close(pt_.dz0, pj_.dz0)
    np.testing.assert_array_equal(pt_.K.numpy(), np.asarray(pj_.K))


def test_depth_path_leaves_learned_positions_out_as_the_reference(model):
    """A kept reference behaviour: the depth path embeds without the
    learned positions (the reference's ``cdepth.py`` embeds through
    ``lm._embed``), so for ``whisper_base`` ``lm_forward_cdepth`` at K =
    n_groups is not ``lm_forward`` in either package, while for
    paligemma (RoPE) it is, up to rounding."""
    cfg_j, cfg_t, pj, pt, toks, fe = model
    kj, kt = _inputs(toks, fe)
    n = tlm.group_layout(cfg_t)[1]
    fwd_j = jlm.lm_forward(pj, cfg_j, **kj)[0]
    cd_j = jcd.lm_forward_cdepth(pj, cfg_j, K=n, **kj)
    fwd_t = tlm.lm_forward(pt, cfg_t, **kt)[0]
    cd_t = tcd.lm_forward_cdepth(pt, cfg_t, K=n, **kt)
    _close(cd_t, cd_j)
    learned = cfg_t.pos == "learned"
    assert learned == (cfg_t.name == "whisper_base")
    for fwd, cd in ((np.asarray(fwd_j), np.asarray(cd_j)),
                    (fwd_t.numpy(), cd_t.numpy())):
        assert np.allclose(fwd, cd, rtol=1e-4, atol=1e-4) != learned


def test_cached_decode_matches_jax(model):
    """``lm_prefill`` of 4 tokens from position 0 and from position 2,
    then decode steps, each adding the learned position at its index,
    against the reference's (text only: the reference's prefill and
    decode take no frontend)."""
    cfg_j, cfg_t, pj, pt, toks, _ = model
    cj = jlm.init_lm_cache(cfg_j, B, S)
    ct = tlm.init_lm_cache(cfg_t, B, S)
    lj, cj = jlm.lm_prefill(pj, cfg_j, jnp.asarray(toks[:, :4]), cj)
    lt, ct = tlm.lm_prefill(pt, cfg_t, torch.from_numpy(toks[:, :4]), ct)
    _close(lt, lj)
    for t in (4, 5):
        lj, cj = jlm.lm_decode_step(pj, cfg_j, jnp.asarray(toks[:, t]), cj,
                                    jnp.asarray(t))
        lt, ct = tlm.lm_decode_step(pt, cfg_t, torch.from_numpy(toks[:, t]),
                                    ct, t)
        _close(lt, lj)
    cj = jlm.init_lm_cache(cfg_j, B, S)
    ct = tlm.init_lm_cache(cfg_t, B, S)
    _, cj = jlm.lm_prefill(pj, cfg_j, jnp.asarray(toks[:, :2]), cj)
    _, ct = tlm.lm_prefill(pt, cfg_t, torch.from_numpy(toks[:, :2]), ct)
    lj, _ = jlm.lm_prefill(pj, cfg_j, jnp.asarray(toks[:, 2:]), cj,
                           start_index=2)
    lt, _ = tlm.lm_prefill(pt, cfg_t, torch.from_numpy(toks[:, 2:]), ct,
                           start_index=2)
    _close(lt, lj)
