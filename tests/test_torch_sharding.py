"""The port's sharding rules (``repro_torch/distributed/sharding.py``) and
the specs of ``repro_torch/launch/steps.py`` held to the reference's.

The reference's eight ``tests/test_sharding_rules.py`` cases on the port;
``_RULES`` equal to the reference's; and, for every config at full size,
the param, ZeRO and sanitized specs of every leaf (the port's over
``abstract_params``' meta tensors, the reference's over ``jax.eval_shape``)
and the cache and data specs of every applicable (arch x shape) cell,
equal leaf for leaf on the (16, 16) and (2, 16, 16) production shapes.
The meshes are stand-ins with ``shape`` and ``axis_names``: the rules
read only the axis sizes, so no 256-device mesh is made. The
reference's trees are traced once for the module.
"""
from types import SimpleNamespace

import jax
import pytest

from port_isolation import port_module_isolation  # noqa: F401
from repro import configs as jconfigs
from repro.distributed import sharding as jshd
from repro.launch import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.distributed import sharding as tshd
from repro_torch.distributed.sharding import (param_pspec, sanitize_spec,
                                              set_ep_axis, zero_pspec)
from repro_torch.launch import steps as tsteps
from torch.utils import _pytree as pytree

MESH = SimpleNamespace(shape={"data": 16, "model": 16},
                       axis_names=("data", "model"))
MESHES = {"sp": MESH,
          "mp": SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16},
                                axis_names=("pod", "data", "model"))}


# ------------------------------------ tests/test_sharding_rules.py, ported

def test_attention_projections():
    assert param_pspec("groups/b0/attn/wq/kernel", 3) == (None, None, "model")
    assert param_pspec("groups/b0/attn/wo/kernel", 3) == (None, "model", None)
    assert param_pspec("tail/t0/attn/wk/kernel", 2) == (None, "model")


def test_embed_vocab_sharding_and_sanitize():
    assert param_pspec("embed/table", 2) == ("model", None)
    # whisper vocab 51865 not divisible by 16 -> replicate dim 0
    assert sanitize_spec(MESH, ("model", None), (51865, 512)) == (None, None)
    assert sanitize_spec(MESH, ("model", None), (256000, 512)) == \
        ("model", None)


def test_moe_expert_parallel_axis_flip():
    assert param_pspec("groups/b1/moe/wi", 4) == (None, "model", None, None)
    set_ep_axis("data")
    try:
        assert param_pspec("groups/b1/moe/wi", 4) == \
            (None, "data", None, "model")
        assert param_pspec("groups/b1/moe/wd", 4) == \
            (None, "data", "model", None)
    finally:
        set_ep_axis("model")
    assert param_pspec("groups/b1/moe/wd", 4) == (None, "model", None, None)


def test_zero_pspec_skips_scanned_stack_axis():
    spec = zero_pspec("groups/b0/ffn/wi/kernel", (96, 18432, 73728), 16)
    assert spec == (None, "data", "model")
    assert zero_pspec("head/kernel", (4096, 151936), 16) == ("data", "model")


def test_zero_pspec_no_duplicate_data_axis():
    set_ep_axis("data")
    try:
        spec = zero_pspec("groups/b1/moe/wi", (24, 128, 5120, 8192), 16)
        flat = [a for ax in spec for a in
                ([ax] if isinstance(ax, str) else list(ax or ()))]
        assert flat.count("data") <= 1, spec
    finally:
        set_ep_axis("model")


def test_unknown_params_replicate():
    assert param_pspec("something/new/weird", 3) == (None, None, None)


def test_norms_replicated():
    assert param_pspec("groups/b0/ln1/scale", 2) == (None, None)
    assert param_pspec("ln_f/scale", 1) == (None,)


def test_rwkv_and_griffin_rules():
    assert param_pspec("groups/b0/tmix/wr/kernel", 3) == \
        (None, None, "model")
    assert param_pspec("groups/b0/tmix/wo/kernel", 3) == \
        (None, "model", None)
    assert param_pspec("groups/b0/griffin/rglru/lam", 2) == (None, "model")
    assert param_pspec("groups/b0/griffin/conv/w", 3) == \
        (None, None, "model")


def test_rules_equal_the_reference():
    assert tshd._RULES == jshd._RULES


def test_to_placements_shards_a_dim_over_every_axis_it_names():
    from torch.distributed.tensor import Replicate, Shard
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert tshd.to_placements(mesh, (("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert tshd.to_placements(mesh, (None, "data")) == \
        (Replicate(), Shard(1), Replicate())


# --------------------------------------------- every config at full size

def _spec(p) -> tuple:
    """A reference PartitionSpec as the port's plain tuple."""
    return tuple(tuple(a) if isinstance(a, (list, tuple)) else a for a in p)


def _jax_param_specs(mesh, tree):
    """path -> (sanitized param spec, sanitized ZeRO spec), reference."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, leaf in flat:
        ps, shape = jshd.path_str(path), tuple(leaf.shape)
        out[ps] = (
            _spec(jshd.sanitize_spec(mesh, jshd.param_pspec(ps, len(shape)),
                                     shape)),
            _spec(jshd.sanitize_spec(mesh, jshd.zero_pspec(
                ps, shape, mesh.shape["data"]), shape)))
    return out


def _torch_param_specs(mesh, tree):
    """The same from the port's rules (``param_specs``, ``grad_specs``)."""
    def by_path(specs):
        flat, _ = pytree.tree_flatten_with_path(specs, is_leaf=tshd.is_layout)
        return {tshd.path_str(p): s for p, s in flat}
    params = by_path(tshd.param_specs(mesh, tree))
    zero = by_path(tshd.grad_specs(mesh, tree))
    return {ps: (params[ps], zero[ps]) for ps in params}


def _jax_data_specs(mesh, specs):
    """The reference's ``data_shardings`` body, its specs without a
    NamedSharding (which would need the 256 devices)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(specs)
    out = {}
    for path, leaf in flat:
        ps = jshd.path_str(path)
        B = leaf.shape[0] if leaf.ndim else 1
        if ps in ("tokens", "targets", "token", "frames", "frontend"):
            out[ps] = _spec(jsteps._batch_spec(mesh, B, leaf.ndim - 1))
        elif ps == "cur_index":
            out[ps] = ()
        else:
            out[ps] = _spec(jsteps.cache_pspec(mesh, ps, leaf))
    return out


@pytest.fixture(scope="module")
def reference():
    """Per arch: the reference's param and ZeRO specs on both meshes, and
    its data specs per applicable shape (traced once here)."""
    out = {}
    for arch in jconfigs.ARCH_IDS:
        cfg = jconfigs.get(arch)
        a = jsteps.abstract_params(cfg)
        out[arch] = {m: _jax_param_specs(mesh, a)
                     for m, mesh in MESHES.items()}
        for name, shape in jconfigs.SHAPES.items():
            if jconfigs.cell_is_applicable(cfg, shape)[0]:
                specs = jsteps.input_specs(cfg, shape)
                for m, mesh in MESHES.items():
                    out[arch][(m, name)] = _jax_data_specs(mesh, specs)
    return out


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_and_zero_specs_equal_the_reference(reference, arch):
    a = tsteps.abstract_params(tconfigs.get(arch))
    assert all(t.device.type == "meta" for t in pytree.tree_leaves(a))
    for m, mesh in MESHES.items():
        assert _torch_param_specs(mesh, a) == reference[arch][m], m


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_cache_and_data_specs_equal_the_reference(reference, arch):
    cfg = tconfigs.get(arch)
    for name, shape in tconfigs.SHAPES.items():
        ok, _ = tconfigs.cell_is_applicable(cfg, shape)
        assert ok == (("sp", name) in reference[arch]), name
        if not ok:
            continue
        specs = tsteps.input_specs(cfg, shape)
        for m, mesh in MESHES.items():
            flat, _ = pytree.tree_flatten_with_path(
                tsteps.data_specs(mesh, cfg, specs), is_leaf=tshd.is_layout)
            got = {tshd.path_str(p): s for p, s in flat}
            assert got == reference[arch][(m, name)], (name, m)
