"""Name-path sharding rules — the port of ``repro/distributed/sharding.py``:
DP / TP / EP / SP without touching model code.

``param_pspec(path, ndim)`` maps a parameter's tree path to a spec, a
tuple with one entry per dim: a mesh axis name, a tuple of names (the
dim sharded over all of them, the first outermost) or None; stacked
layer params (a leading group axis) get a None prepended. The spec
functions return the reference's ``PartitionSpec`` entries as plain
tuples, so the tests compare the two leaf for leaf. ``zero_pspec``
further shards a leaf over ``"data"`` (ZeRO: optimizer moments,
accumulated gradients, FSDP params). ``to_placements`` turns a spec into
DTensor placements on a ``DeviceMesh`` (``Shard(i)`` on each mesh dim
that dim i names, ``Replicate()`` on the rest), and the ``*_shardings``
functions give a placement tree for a parameter tree.

The reference's ``with_sharding_constraint`` hooks become
``DTensor.redistribute``: ``constrain`` (the activations between
blocks) and ``constrain_group_params`` (FSDP's per-group all-gather,
with the gradient reduce-scattered in its backward) act only while they
are switched on and only on DTensors, so model code calls them
unconditionally and a run without a mesh is unchanged bit for bit.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

Spec = Tuple[Any, ...]

# (regex on 'a/b/c' path, spec for the UNSTACKED param). Order matters.
_RULES: Tuple[Tuple[str, Tuple], ...] = (
    (r"embed/table$", ("model", None)),          # vocab sharding
    (r"head/kernel$", (None, "model")),
    (r"patch_proj/kernel$", (None, "model")),
    (r"pos_embed$", (None, None)),
    (r"enc_pos$", (None, None)),
    (r"dec_pos$", (None, None)),
    # attention
    (r"(attn|self_attn|cross_attn)/w[qkv]/kernel$", (None, "model")),
    (r"(attn|self_attn|cross_attn)/wo/kernel$", ("model", None)),
    (r"(q_norm|k_norm)/scale$", (None,)),
    # dense ffn
    (r"ffn/w[ig]/kernel$", (None, "model")),
    (r"ffn/wd/kernel$", ("model", None)),
    (r"shared/w[ig]/kernel$", (None, "model")),
    (r"shared/wd/kernel$", ("model", None)),
    # MoE: expert-parallel over 'model'
    (r"moe/router/kernel$", (None, None)),
    (r"moe/w[igd]$", ("model", None, None)),
    # RWKV6
    (r"tmix/w[rkvg]/kernel$", (None, "model")),
    (r"tmix/wo/kernel$", ("model", None)),
    (r"tmix/(mu_x|u|w0)$", ("model",)),
    (r"tmix/mu$", (None, "model")),
    (r"tmix/lora_a1$", (None, None)),
    (r"tmix/lora_a2$", (None, None, "model")),
    (r"tmix/w_lora1$", (None, None)),
    (r"tmix/w_lora2$", (None, "model")),
    (r"tmix/gn_(scale|bias)$", ("model", None)),
    (r"cmix/w[k]/kernel$", (None, "model")),
    (r"cmix/wv/kernel$", ("model", None)),
    (r"cmix/wr/kernel$", (None, "model")),
    (r"cmix/mix_[kr]$", ("model",)),
    # Griffin / RG-LRU (recurrence width sharded over 'model')
    (r"griffin/in_(rec|gate)/kernel$", (None, "model")),
    (r"griffin/out/kernel$", ("model", None)),
    (r"griffin/conv/w$", (None, "model")),
    (r"griffin/conv/b$", ("model",)),
    (r"rglru/w[ax]/kernel$", (None, "model")),
    (r"rglru/(ba|bx|lam)$", ("model",)),
    # norms & anything 1-D: replicate
    (r"(ln1|ln2|ln_x|ln_f|ln_enc|ln_dec)/(scale|bias)$", (None,)),
)


def path_str(path) -> str:
    """A ``torch.utils._pytree`` key path as ``'a/b/c'`` (dict keys,
    sequence indices and attribute names, as the reference's)."""
    parts = []
    for k in path:
        if isinstance(k, pytree.MappingKey):
            parts.append(str(k.key))
        elif isinstance(k, pytree.SequenceKey):
            parts.append(str(k.idx))
        elif isinstance(k, pytree.GetAttrKey):
            parts.append(k.name)
        else:
            parts.append(str(k))
    return "/".join(parts)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (its ``mesh_dim_names``)
    or of a stand-in whose ``shape`` is that dict already."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axes(ax) -> Tuple[str, ...]:
    """The mesh axes one spec entry names."""
    return (ax,) if isinstance(ax, str) else tuple(ax or ())


# Expert-parallel placement: 'model' (default, Switch/GShard style: the
# all-to-all shares the TP axis) or 'data' (DeepSpeed-MoE style: expert
# weights live on the DP axis).
_EP = {"axis": "model"}


def set_ep_axis(axis: str) -> None:
    assert axis in ("model", "data")
    _EP["axis"] = axis


def param_pspec(path: str, ndim: int) -> Spec:
    if _EP["axis"] == "data" and re.search(r"moe/w[igd]$", path):
        # wi/wg: (E, d, f) -> E over data, f over model;
        # wd:    (E, f, d) -> E over data, f over model
        spec = ("data", None, "model") if not path.endswith("wd") \
            else ("data", "model", None)
        if ndim > 3:
            spec = (None,) * (ndim - 3) + spec
        return spec
    spec: Optional[Tuple] = None
    for pat, sp in _RULES:
        if re.search(pat, path):
            spec = sp
            break
    if spec is None:
        spec = (None,) * ndim  # replicate unknowns (safe default)
    if len(spec) < ndim:  # stacked group/layer leading axes
        spec = (None,) * (ndim - len(spec)) + tuple(spec)
    assert len(spec) == ndim, (path, spec, ndim)
    return tuple(spec)


def sanitize_spec(mesh, spec: Spec, shape) -> Spec:
    """Drop mesh axes from dims they don't divide (e.g. whisper's 51865
    vocab on a 16-way model axis -> replicate that dim)."""
    sizes = axis_sizes(mesh)
    out = []
    for ax, dim in zip(spec, shape):
        if ax is None:
            out.append(None)
            continue
        n = 1
        for a in _axes(ax):
            n *= sizes[a]
        out.append(ax if dim % n == 0 else None)
    return tuple(out)


def to_placements(mesh, spec: Spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(i)`` where ``spec[i]`` names it (alone or in a tuple, which
    shards dim i over all its axes, the first outermost), else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, ax in enumerate(spec) if name in _axes(ax)]
        assert len(dims) <= 1, (spec, name)
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def is_layout(x) -> bool:
    """True for a leaf of a spec or placement tree: a plain tuple (not a
    NamedTuple such as ``AdamState``) of spec entries or placements."""
    from torch.distributed.tensor.placement_types import Placement
    return type(x) is tuple and all(
        e is None or isinstance(e, (str, tuple, Placement)) for e in x)


def _placements_of(mesh, specs):
    return pytree.tree_map(lambda s: to_placements(mesh, s), specs,
                           is_leaf=is_layout)


def _leaf_specs(abstract, spec_of):
    """``spec_of(path string, leaf)`` over every leaf of ``abstract``."""
    return pytree.tree_map_with_path(
        lambda path, leaf: spec_of(path_str(path), leaf), abstract)


def param_specs(mesh, abstract_params):
    """The sanitized spec of every parameter leaf (``param_pspec``)."""
    return _leaf_specs(abstract_params, lambda ps, leaf: sanitize_spec(
        mesh, param_pspec(ps, leaf.ndim), leaf.shape))


def param_shardings(mesh, abstract_params):
    """Placement tree for a (meta or live) param tree."""
    return _placements_of(mesh, param_specs(mesh, abstract_params))


_STACKED_RE = re.compile(r"^(groups|enc_blocks|dec_blocks)/")


def _stack_skip(path: str) -> int:
    """Parameters under a stack have a leading layer axis that the group
    loop slices each iteration: it must stay unsharded, or every slice
    would gather its layer from other devices."""
    return 1 if _STACKED_RE.search(path) else 0


def zero_pspec(path: str, shape: Tuple[int, ...], data_size: int,
               skip: int | None = None) -> Spec:
    """ZeRO/FSDP: param spec plus 'data' sharding on the first eligible
    dim (unsharded, divisible) — skipping the stack axis."""
    base = list(param_pspec(path, len(shape)))
    skip = _stack_skip(path) if skip is None else skip
    in_use = {a for ax in base for a in _axes(ax)}
    if "data" in in_use:          # e.g. EP-over-data expert weights
        return tuple(base)
    for i in range(skip, len(shape)):
        ax, dim = base[i], shape[i]
        if ax is None and dim % data_size == 0 and dim >= data_size:
            base[i] = "data"
            break
    return tuple(base)


def grad_specs(mesh, abstract_params, zero: bool = True):
    """Sanitized spec of each gradient accumulator: the param spec plus
    'data' on the first divisible unsharded dim (ZeRO-2: gradients live
    reduce-scattered across the data axis)."""
    data_size = axis_sizes(mesh).get("data", 1)

    def one(ps, leaf):
        spec = zero_pspec(ps, tuple(leaf.shape), data_size) if zero \
            else param_pspec(ps, leaf.ndim)
        return sanitize_spec(mesh, spec, leaf.shape)
    return _leaf_specs(abstract_params, one)


def grad_shardings(mesh, abstract_params, zero: bool = True):
    """Placement tree of ``grad_specs``."""
    return _placements_of(mesh, grad_specs(mesh, abstract_params, zero))


def opt_state_specs(mesh, abstract_opt_state, zero: bool = True):
    """Sanitized spec of each optimizer-state leaf: an ``AdamState``'s
    ``mu/...`` and ``nu/...`` leaves take their parameter's rule."""
    data_size = axis_sizes(mesh).get("data", 1)

    def one(ps, leaf):
        # strip AdamState prefix (mu/..., nu/..., index keys) for matching
        ps = re.sub(r"^(mu|nu|momentum|[01])/", "", ps)
        spec = zero_pspec(ps, tuple(leaf.shape), data_size) if zero \
            else param_pspec(ps, leaf.ndim)
        return sanitize_spec(mesh, spec, leaf.shape)
    return _leaf_specs(abstract_opt_state, one)


def opt_state_shardings(mesh, abstract_opt_state, zero: bool = True):
    """Placement tree of ``opt_state_specs``."""
    return _placements_of(
        mesh, opt_state_specs(mesh, abstract_opt_state, zero))


# ------------------------------------------------ activation constraints ----

_ACT: dict = {"enabled": False, "batch": ("data",), "seq": None}
_PARAM_RESHARD: dict = {"enabled": False, "mesh": None}


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def set_param_resharding(mesh) -> None:
    """FSDP mode: inside the group loop, redistribute each group's param
    slice to its TP-only placements, so the 'data' all-gather happens on
    ONE group's weights at a time (and its backward is a per-group
    reduce-scatter of the gradient)."""
    _PARAM_RESHARD["enabled"] = True
    _PARAM_RESHARD["mesh"] = mesh


def clear_param_resharding() -> None:
    _PARAM_RESHARD["enabled"] = False
    _PARAM_RESHARD["mesh"] = None


class _ReshardGroup(torch.autograd.Function):
    """Forward: each slice to its TP-only placements. Backward: each
    cotangent cast to its param's dtype and redistributed to the ZeRO
    placements, so the gradient leaves the loop reduce-scattered over
    'data' in the param dtype, never as a full float32 replica."""

    @staticmethod
    def forward(ctx, fwd, bwd, dtypes, *leaves):
        ctx.bwd, ctx.dtypes = bwd, dtypes
        return tuple(l.redistribute(placements=p) for l, p in zip(leaves,
                                                                    fwd))

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g, dt, p in zip(grads, ctx.dtypes, ctx.bwd):
            out.append(None if g is None else
                       g.to(dt).redistribute(placements=p))
        return (None, None, None, *out)


def constrain_group_params(gp):
    """FSDP in-loop resharding (``set_param_resharding``) of one group's
    param slices; ``gp`` itself when the hook is off or its leaves are
    not DTensors."""
    if not _PARAM_RESHARD["enabled"]:
        return gp
    mesh = _PARAM_RESHARD["mesh"]
    data_size = axis_sizes(mesh).get("data", 1)
    flat, spec = pytree.tree_flatten_with_path(gp)
    if not flat or not is_dtensor(flat[0][1]):
        return gp
    paths = [path_str(p) for p, _ in flat]
    leaves = [l for _, l in flat]
    fwd = [to_placements(mesh, sanitize_spec(
        mesh, param_pspec(p, l.ndim), l.shape)) for p, l in zip(paths, leaves)]
    # cotangent: TP spec + 'data' on the first eligible dim (the slice
    # has no stack axis, so skip=0)
    bwd = [to_placements(mesh, sanitize_spec(
        mesh, zero_pspec(p, tuple(l.shape), data_size, skip=0), l.shape))
        for p, l in zip(paths, leaves)]
    out = _ReshardGroup.apply(fwd, bwd, [l.dtype for l in leaves], *leaves)
    return pytree.tree_unflatten(list(out), spec)


def set_activation_sharding(batch_axes: Sequence[str],
                            seq_axis: Optional[str] = None):
    """Enable the ``constrain`` hooks inside model code. seq_axis='model'
    activates sequence partitioning (SP) of the residual stream between
    blocks."""
    _ACT["enabled"] = True
    _ACT["batch"] = tuple(batch_axes)
    _ACT["seq"] = seq_axis


def clear_activation_sharding():
    _ACT["enabled"] = False
    _ACT["seq"] = None


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """kind: 'residual' (B,S,d) | 'logits' (B,S,V) | 'batch' (B, ...).
    A DTensor redistributed to the kind's placements while the hooks are
    on (a dim its axes do not divide stays replicated); anything else
    unchanged."""
    if not _ACT["enabled"] or not is_dtensor(x):
        return x
    b = tuple(_ACT["batch"]) if len(_ACT["batch"]) > 1 else _ACT["batch"][0]
    if kind == "residual":
        spec = (b, _ACT["seq"], None)
    elif kind == "logits":
        spec = (b, None, "model")
    elif kind == "batch":
        spec = (b, *([None] * (x.ndim - 1)))
    else:
        return x
    mesh = x.device_mesh
    return x.redistribute(placements=to_placements(
        mesh, sanitize_spec(mesh, spec, x.shape)))


# ------------------------------------------------ kernels on local shards ----

BATCH_AXES = ("pod", "data")


def shard_layout(mesh, shape, batch_dim: Optional[int] = 0,
                 model_dim: Optional[int] = None) -> tuple:
    """Placements that put dim ``batch_dim`` over the batch axes ('pod',
    'data') and dim ``model_dim`` over 'model', each where the axes divide
    it; every other dim, and a dim they do not divide, replicated."""
    sizes = axis_sizes(mesh)
    spec = [None] * len(shape)
    ba = tuple(a for a in BATCH_AXES if a in sizes)
    n_b = 1
    for a in ba:
        n_b *= sizes[a]
    if batch_dim is not None and ba and shape[batch_dim] % n_b == 0:
        spec[batch_dim] = ba if len(ba) > 1 else ba[0]
    if model_dim is not None and "model" in sizes \
            and shape[model_dim] % sizes["model"] == 0:
        spec[model_dim] = "model"
    return to_placements(mesh, spec)


def shard_index(mesh, placements, dim: int) -> Tuple[int, int]:
    """(index, count) of this device's block of dim ``dim`` under
    ``placements``: the mesh dims that shard it, the first outermost."""
    from torch.distributed.tensor import Shard
    idx, n = 0, 1
    for i, p in enumerate(placements):
        if p == Shard(dim):
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
            n *= mesh.size(i)
    return idx, n


def splittable(t, dim: int, outer: int):
    """``t`` ready to have dim ``dim`` split into ``(outer, -1)`` (heads
    out of a fused projection): a DTensor whose mesh axes sharding that
    dim do not divide ``outer`` is replicated over those axes first
    (DTensor will not split an unevenly sharded dim); anything else is
    ``t`` itself. The replicated tensor is one projection's output, the
    heads of a reduced model or Qwen3-8B's 8 key/value heads over 16."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    dim = dim % t.ndim
    n = shard_index(t.device_mesh, t.placements, dim)[1]
    if outer % n == 0:
        return t
    return t.redistribute(placements=tuple(
        Replicate() if p == Shard(dim) else p for p in t.placements))


def matmul_ready(x, w):
    """``x`` ready for ``x @ w`` with ``w`` column-sharded: over a mesh
    axis that shards w's last dim, x is gathered wherever that axis
    shards it past the batch dim (the contraction, or the sequence under
    sequence parallelism), as Megatron's column-parallel layer takes its
    input. DTensor would otherwise move the weight, or flatten a
    sequence-sharded batch into a strided layout, and leave a partial
    sum that a later non-linear op scatters along the sequence. Anything
    else is ``x`` itself."""
    if not (is_dtensor(x) and is_dtensor(w)):
        return x
    from torch.distributed.tensor import Replicate, Shard
    ws = Shard(w.ndim - 1)
    pl = tuple(Replicate() if q == ws and isinstance(p, Shard) and p.dim > 0
               else p for p, q in zip(x.placements, w.placements))
    return x if pl == tuple(x.placements) else x.redistribute(placements=pl)


def whole(t):
    """A small DTensor (a mixing vector, a bias) replicated over every
    mesh axis, so products with a replicated activation stay replicated;
    anything else as is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(placements=(Replicate(),) * len(t.placements))


class _GradLike(torch.autograd.Function):
    """Identity forward; the gradient redistributed to the forward
    tensor's placements in the backward."""

    @staticmethod
    def forward(ctx, t):
        from torch.distributed.tensor import Replicate
        # a partial sum's gradient is the same on every device
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(placements=ctx.placements)


def grad_like(t):
    """``t``, whose gradient is brought back to ``t``'s own placements
    before it flows further back. DTensor picks a gradient's placements
    op by op: after heads are merged (``(B, S, H, hd)`` to ``(B, S,
    H·hd)``) it may hand the merged tensor's gradient back sharded where
    the heads are not, which the merge's backward cannot split; and a
    projection's output gradient may come back replicated, so that its
    weight gradient is computed whole on every device. A plain tensor is
    returned as is."""
    if not is_dtensor(t) or not t.requires_grad:
        return t
    return _GradLike.apply(t)


class _Contiguous(torch.autograd.Function):
    """Identity forward; the gradients made contiguous in the backward."""

    @staticmethod
    def forward(ctx, *ts):
        return ts

    @staticmethod
    def backward(ctx, *grads):
        return tuple(None if g is None else g.contiguous() for g in grads)


def _contiguous(t):
    """``t`` made contiguous, forward and backward (a no-op for a plain
    tensor that is, and for a non-tensor)."""
    if not isinstance(t, torch.Tensor):
        return t
    t = t.contiguous()
    return _Contiguous.apply(t)[0] if t.requires_grad else t


def on_local_shards(fn, out_placements, in_placements, mesh,
                    in_grad_placements=None):
    """``fn`` run on each device's local shards: the DTensor arguments
    redistributed to ``in_placements`` (None for a non-tensor argument),
    ``fn`` called on their local tensors, its outputs wrapped as DTensors
    of ``out_placements``. The counterpart of running a kernel per shard
    under the reference's ``shard_map``. DTensor takes a local block to
    be contiguous, so the blocks ``fn`` gets and gives, and their
    gradients, are made so (on a card the kernels' are already)."""
    from torch.distributed.tensor.experimental import local_map

    def contiguous_fn(*args):
        out = fn(*(_contiguous(a) for a in args))
        if isinstance(out, tuple):
            return tuple(_contiguous(o) for o in out)
        return _contiguous(out)

    return local_map(contiguous_fn, out_placements=out_placements,
                     in_placements=in_placements,
                     in_grad_placements=in_grad_placements,
                     device_mesh=mesh, redistribute_inputs=True)
