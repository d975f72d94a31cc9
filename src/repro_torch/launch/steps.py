"""Train, prefill and serve step functions — the port of
``repro/launch/steps.py``, on one device or over a device mesh.

  * train step   = one optimizer update: value and gradient of
    ``lm_loss`` (``encdec_loss`` for an encoder-decoder config; a batch's
    ``frontend`` goes to ``lm_loss``) (microbatched gradient accumulation when
    ``microbatches > 1``), the global-norm clip, AdamW. Params and
    moments are updated in place, leaf by leaf and a stacked leaf in
    chunks (``Optimizer.update_in_place``): the counterpart of the reference's donated
    params and optimizer state (``steps.py:260``, ``donate_argnums=(0,
    1)``), with which XLA updates the buffers in place. A 4 B-parameter
    model holds ~48 GB at rest in training (bf16 params and grads,
    float32 moments); a whole-tree functional update would hold ~56 GB
    more. The values are the functional update's, bit for bit.
  * prefill step = the full-sequence forward (logits), no gradient: for
    an encoder-decoder config ``encode`` then ``decode_train``.
  * serve step   = one cached decode step (``lm_decode_step``, or
    ``encdec_decode_step``), which updates the caches in place (the
    reference donates them).

Over a device mesh (``mesh=``): the
params, the moments and the gradients are DTensors on a ``DeviceMesh``
(``launch/mesh.py``), placed by the name rules of
``distributed/sharding.py``, and the model runs on them unchanged, with
the ``constrain`` hooks on (the residual over the batch axes, and over
``"model"`` along the sequence under ``seq_shard``; the logits' vocabulary
over ``"model"``) and the kernels on each device's local shards. The
step's settings take the reference's multi-device meaning:
  * ``zero_opt``: the moments (and the gradients) further sharded over
    ``"data"`` (``opt_state_shardings``, ``grad_shardings``); the update
    runs on each device's block of them and all-gathers the params'
    blocks back (ZeRO-1/2);
  * ``fsdp``: the params themselves ZeRO-sharded; each group's slice is
    gathered to its tensor-parallel placements inside the group loop and
    its gradient reduce-scattered there (``constrain_group_params``);
  * ``seq_shard``: sequence parallelism of the residual between blocks.
Gradients leave the backward in their ZeRO placements (a DTensor
gradient otherwise comes out as a full-size partial sum on every
device), and the microbatch accumulator in ``acc_dtype`` lives there too.
``shard_state`` places a param tree and a fresh optimizer state for a
step; ``init_params_sharded`` draws a dense or MoE LM's weights already
in their placements, each device only its own blocks (a model no card
holds; under expert parallelism a device draws its own experts), and
``place_caches`` places ``init_lm_cache``'s caches for the sharded serve
step. Every device takes the same global batch (``token_batches`` with
one seed), each microbatch is split from it exactly as on one device
(rows ``[i·B/m, (i+1)·B/m)``) and placed over the batch axes, so the
sharded step computes the unsharded step's values up to the order of
floating-point sums. ``abstract_params`` (meta tensors), ``input_specs``,
``data_shardings`` and ``cache_pspec`` serve the dry run
(``launch/dryrun.py``). The 8-bit moments
(``optim/quantized_state.py::adamw8bit``) carry the same
``update_in_place`` on one device, so a step composed of
``_value_and_grad``, the clip and that update trains with int8 moments;
they have no sharded update (ROADMAP.md item 12's leftovers), and the
reference's ``TRAIN_SETTINGS`` never pairs them with a mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import ArchConfig, ShapeSpec
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import batch_axes
from repro_torch.models import encdec
from repro_torch.models.lm import (block_pattern, dtype_of, init_lm,
                                   init_lm_cache, lm_decode_step, lm_forward,
                                   lm_loss)
from repro_torch.nn.module import truncated_normal_init
from repro_torch.optim import (Optimizer, adamw, clip_scale, global_norm,
                               linear_warmup_cosine)


@dataclasses.dataclass(frozen=True)
class StepSettings:
    microbatches: int = 1
    remat: str = "dots"            # none | dots | full
    zero_opt: bool = True          # ZeRO-1 opt-state sharding
    seq_shard: bool = False        # SP: shard residual seq over 'model'
    fsdp: bool = False             # params data+model sharded (>= ~100B)
    grad_clip: float = 1.0
    lr: float = 3e-4
    moment_dtype: str = "float32"  # float32 | bfloat16
    acc_dtype: str = "float32"     # grad-accumulator dtype (bf16 >= ~340B)


def make_optimizer(s: StepSettings) -> Optimizer:
    return adamw(linear_warmup_cosine(s.lr, s.lr * 0.1, 200, 10_000),
                 weight_decay=0.1, moment_dtype=dtype_of(s.moment_dtype))


# -------------------------------------------------------------- specs ----

def abstract_params(cfg: ArchConfig):
    """The param tree of ``cfg`` as meta tensors (shapes and dtypes, no
    storage): the counterpart of ``jax.eval_shape(init)``."""
    init = encdec.init_encdec if cfg.is_encdec else init_lm
    return init(torch.Generator(), cfg, device="meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of the cell, with the
    reference's shapes and dtypes (int32 tokens)."""
    B, S = shape.global_batch, shape.seq_len
    dt = dtype_of(cfg.dtype)
    i32 = torch.int32
    if cfg.is_encdec:
        L = cfg.max_target_len
        if shape.kind == "train":
            return {"frames": _meta((B, S, cfg.d_model), dt),
                    "tokens": _meta((B, L), i32),
                    "targets": _meta((B, L), i32)}
        if shape.kind == "prefill":
            return {"frames": _meta((B, S, cfg.d_model), dt),
                    "tokens": _meta((B, L), i32)}
        # decode: cross KV over S encoder frames, self cache of max_target
        kv = lambda n: {"k": _meta((cfg.dec_layers, B, n, cfg.n_kv,
                                    cfg.d_head), dt),
                        "v": _meta((cfg.dec_layers, B, n, cfg.n_kv,
                                    cfg.d_head), dt)}
        return {"token": _meta((B,), i32),
                "caches": {"self": kv(L), "cross": kv(S)},
                "cur_index": _meta((), i32)}
    # decoder-only families
    fe = None
    if cfg.frontend == "patches":
        fe = _meta((B, cfg.n_frontend_tokens, cfg.d_model), dt)
    if shape.kind in ("train", "prefill"):
        out = {"tokens": _meta((B, S), i32)}
        if shape.kind == "train":
            out["targets"] = _meta((B, S), i32)
        if fe is not None:
            out["frontend"] = fe
        return out
    return {"token": _meta((B,), i32),
            "caches": init_lm_cache(cfg, B, S, device="meta"),
            "cur_index": _meta((), i32)}


# ---------------------------------------------------------- shardings ----

def _batch_spec(mesh, B: int, extra_dims: int) -> tuple:
    ba = batch_axes(mesh)
    sizes = shd.axis_sizes(mesh)
    n = 1
    for a in ba:
        n *= sizes[a]
    first = (ba if len(ba) > 1 else ba[0]) if B % n == 0 else None
    return (first, *([None] * extra_dims))


def data_specs(mesh, cfg: ArchConfig, specs) -> Any:
    """The spec of every leaf of an ``input_specs`` tree: batch over the
    batch axes where they divide it, caches by ``cache_pspec``."""
    def one(path, leaf):
        ps = shd.path_str(path)
        B = leaf.shape[0] if leaf.ndim else 1
        if ps in ("tokens", "targets", "token", "frames", "frontend"):
            return _batch_spec(mesh, B, leaf.ndim - 1)
        if ps == "cur_index":
            return ()
        return cache_pspec(mesh, ps, leaf)
    return pytree.tree_map_with_path(one, specs)


def data_shardings(mesh, cfg: ArchConfig, specs) -> Any:
    """Placements for the ``input_specs`` tree (``data_specs``)."""
    return pytree.tree_map(lambda s: shd.to_placements(mesh, s),
                           data_specs(mesh, cfg, specs), is_leaf=shd.is_layout)


def cache_pspec(mesh, path: str, leaf) -> tuple:
    """Cache sharding: batch over data axes when divisible, else the
    longest non-head axis; head/width axes over 'model'."""
    ba = batch_axes(mesh)
    sizes = shd.axis_sizes(mesh)
    n_b = 1
    for a in ba:
        n_b *= sizes[a]
    ba = ba if len(ba) > 1 else ba[0]
    n_m = sizes["model"]
    shape = leaf.shape
    spec = [None] * leaf.ndim

    def try_axis(i, axes, size_needed):
        if spec[i] is None and shape[i] % size_needed == 0 \
                and shape[i] >= size_needed:
            spec[i] = axes
            return True
        return False

    if path.endswith("/k") or path.endswith("/v"):
        # (G?, B, S, KV, hd): model on KV if divisible else hd else S
        kv_i, hd_i = leaf.ndim - 2, leaf.ndim - 1
        s_i, b_i = leaf.ndim - 3, leaf.ndim - 4
        (try_axis(kv_i, "model", n_m) or try_axis(hd_i, "model", n_m)
         or try_axis(s_i, "model", n_m))
        (try_axis(b_i, ba, n_b) or try_axis(s_i, ba, n_b))
        return tuple(spec)
    if path.endswith("_scale"):
        # int8 KV scales (G?, B, S, KV)
        kv_i, s_i, b_i = leaf.ndim - 1, leaf.ndim - 2, leaf.ndim - 3
        (try_axis(kv_i, "model", n_m) or try_axis(s_i, "model", n_m))
        (try_axis(b_i, ba, n_b) or try_axis(s_i, ba, n_b))
        return tuple(spec)
    nd = leaf.ndim  # tail-layer caches lack the leading group axis
    if path.endswith("/S"):          # (G?, B, H, hd, hd)
        try_axis(nd - 3, "model", n_m)
        try_axis(nd - 4, ba, n_b)
        return tuple(spec)
    if path.endswith("x_tmix") or path.endswith("x_cmix"):  # (G?, B, d)
        try_axis(nd - 1, "model", n_m)
        try_axis(nd - 2, ba, n_b)
        return tuple(spec)
    if path.endswith("/conv"):       # (G?, B, 3, W)
        try_axis(nd - 1, "model", n_m)
        try_axis(nd - 3, ba, n_b)
        return tuple(spec)
    if path.endswith("/h"):          # (G?, B, W)
        try_axis(nd - 1, "model", n_m)
        try_axis(nd - 2, ba, n_b)
        return tuple(spec)
    return tuple(spec)


def param_placements(mesh, settings: StepSettings, params):
    """The params' placements: their rules', or the ZeRO spec's under
    ``fsdp``."""
    if settings.fsdp:
        return shd.grad_shardings(mesh, params, zero=True)
    return shd.param_shardings(mesh, params)


def _placed(tree, placements, mesh, src_data_rank):
    from torch.distributed.tensor import distribute_tensor
    return pytree.tree_map(
        lambda t, p: distribute_tensor(t, mesh, p,
                                       src_data_rank=src_data_rank),
        tree, placements, is_leaf=lambda x: isinstance(x, torch.Tensor))


def shard_state(mesh, settings: StepSettings, params, opt: Optimizer,
                src_data_rank: Optional[int] = 0):
    """(params as DTensors in ``param_placements``, a fresh optimizer
    state whose moments are zero DTensors in ``opt_state_shardings``).
    ``params`` holds the whole tree on every rank; with
    ``src_data_rank=0`` rank 0's values are scattered (every rank then
    holds the same weights whatever its own copy), with None each rank
    cuts its blocks from its own copy, with no communication. A placed
    leaf may share storage with its ``params`` leaf (a replicated one is
    that tensor), and the step updates it in place: pass a copy to keep
    ``params``."""
    from torch.distributed.tensor import zeros as dzeros
    dparams = _placed(params, param_placements(mesh, settings, params),
                      mesh, src_data_rank)
    state = opt.init(pytree.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
        params))
    o_pl = shd.opt_state_shardings(mesh, state, zero=settings.zero_opt)
    dstate = pytree.tree_map(
        lambda t, p: dzeros(t.shape, dtype=t.dtype, device_mesh=mesh,
                            placements=p),
        state, o_pl, is_leaf=lambda x: isinstance(x, torch.Tensor))
    return dparams, dstate


# The sharded draw's tiling: each group slice of a leaf is cut into
# DRAW_TILES equal blocks along the dim its rule puts over "model", and
# each block drawn from a generator of its own, so that a device's block
# on a model axis of 1, 2 or 4 is a union of whole tiles. An expert stack
# (``moe/w[igd]``, experts over "model") is cut into its experts instead:
# one tile, and one generator, an expert.
DRAW_TILES = 4
_EXPERT_STACK = re.compile(r"moe/w[igd]$")


def _leaf_init(path: str, shape) -> Tuple[str, float]:
    """``init_lm``'s distribution of one leaf of a decoder-only LM of
    dense and MoE blocks: ``("normal", scale)`` for
    ``truncated_normal_init`` at that scale (``dense_init``'s fan-in rule,
    ``attention_init``'s ``wo``, the router and the shared expert
    included: ``wo``'s fan-in is ``n_heads * d_head``; ``moe_init``'s
    expert stacks ``(E, d, f)`` and ``(E, f, d)`` at ``d ** -0.5`` and
    ``f ** -0.5``, their fan-in too; 1 for the embedding, 0.02 for learned
    positions), ``("ones", 1.0)`` for a norm's scale."""
    if path.endswith("/kernel") or _EXPERT_STACK.search(path):
        return "normal", shape[-2] ** -0.5
    if path == "embed/table":
        return "normal", 1.0
    if path == "pos_embed":
        return "normal", 0.02
    if path.endswith("/scale"):
        return "ones", 1.0
    raise ValueError(f"init_params_sharded: no rule for leaf {path!r}")


def _tile_seed(seed: int, leaf: int, g: int, tile: int) -> int:
    """The generator seed of tile ``tile`` of group slice ``g`` of leaf
    number ``leaf`` (in ``tree_leaves`` order)."""
    import numpy as np
    return int(np.random.SeedSequence((seed, leaf, g, tile))
               .generate_state(1, np.uint64)[0])


def _drawn_block(seed: int, idx: int, path: str, leaf, placements, mesh,
                 device) -> torch.Tensor:
    """This device's block of leaf ``idx`` under ``placements``, drawn
    tile by tile: the union of the tiles its block covers, each drawn
    alone (float32, then cast) and copied into place. A group slice has
    DRAW_TILES tiles along its "model" dim, or, for an expert stack
    ``moe/w[igd]`` (``(G, E, d, f)``, E over "model"), E tiles: one
    expert each, so its float32 transient is one expert's matrix and a
    device's experts on a model axis dividing E are whole tiles. Dense
    leaves keep DRAW_TILES tiles (their values do not change with the
    expert rule)."""
    from torch.distributed.tensor import Shard
    kind, scale = _leaf_init(path, leaf.shape)
    spec = shd.param_pspec(path, leaf.ndim)
    model = [i for i, ax in enumerate(spec) if "model" in shd._axes(ax)]
    dim = model[0] if model else None
    if dim is not None and _EXPERT_STACK.search(path):
        n_tiles = leaf.shape[dim]
    else:
        n_tiles = DRAW_TILES if dim is not None \
            and leaf.shape[dim] % DRAW_TILES == 0 else 1
    sharded = {p.dim for p in placements if isinstance(p, Shard)}
    if sharded - {dim}:
        raise ValueError(f"init_params_sharded: {path} sharded on dims "
                         f"{sorted(sharded)}, its tiles on {dim}")
    i, n = shd.shard_index(mesh, placements, dim) if sharded else (0, 1)
    if n_tiles % n:
        raise ValueError(f"init_params_sharded: {path} {tuple(leaf.shape)} "
                         f"cut {n} ways is not a union of {n_tiles} tiles")
    shape = list(leaf.shape)
    if dim is not None:
        shape[dim] //= n
    if kind == "ones":
        return torch.ones(shape, dtype=leaf.dtype, device=device)
    block = torch.empty(shape, dtype=leaf.dtype, device=device)
    skip = shd._stack_skip(path)
    per = n_tiles // n
    for g in range(leaf.shape[0] if skip else 1):
        view = block[g] if skip else block
        for t in range(per):
            part = view if n_tiles == 1 else view.narrow(
                dim - skip, t * view.shape[dim - skip] // per,
                view.shape[dim - skip] // per)
            gen = torch.Generator(device=device).manual_seed(
                _tile_seed(seed, idx, g, i * per + t))
            part.copy_(truncated_normal_init(gen, part.shape, scale,
                                             leaf.dtype, device))
    return block


def init_params_sharded(seed: int, cfg: ArchConfig, mesh,
                        settings: Optional[StepSettings] = None):
    """Random weights of ``cfg`` drawn already sharded: ``init_lm``'s tree
    as DTensors in ``param_placements``, the counterpart of the
    reference's ``jax.jit(init, out_shardings=p_sh)``. Each device draws
    only its own blocks, on its own device, tile by tile (``DRAW_TILES``
    tiles a group slice along the dim its rule shards over ``"model"``;
    the MoE expert stacks ``moe/wi``, ``moe/wg`` and ``moe/wd``, whose
    experts lie over ``"model"``, one tile an expert; each tile from a
    generator seeded by (``seed``, leaf, slice, tile)), in ``init_lm``'s
    distributions (``_leaf_init``); no device and no host holds a whole
    leaf, and no tensor larger than one tile is made beside the blocks.
    The values depend on ``seed`` and on the device type, not on the
    mesh: the same global weights on a (1, 1), (1, 2), (2, 2) or (1, 4)
    mesh. They are not ``init_lm``'s values (one generator there draws
    each leaf whole). A dense leaf's values are those of the draw before
    the expert rule existed.

    Supports a ``make_debug_mesh`` mesh (axes ``("data", "model")``)
    whose model axis divides ``DRAW_TILES`` and the expert count (1, 2 or
    4 over any data size: the params replicate over "data"), without
    ``fsdp``, with the experts over ``"model"`` (``set_ep_axis``'s
    default), for a decoder-only config of ``dense`` and ``moe`` blocks
    (attention and FFN, attention and experts with the router and the
    shared expert: Nemotron, Mistral-NeMo, Qwen3, Llama-4 Maverick,
    OLMoE); raises on any other: ``rec`` and ``rwkv`` blocks and
    encoder-decoder configs have no draw rules yet (ROADMAP.md item
    32)."""
    from torch.distributed.tensor import DTensor
    settings = settings or StepSettings()
    sizes = shd.axis_sizes(mesh)
    kinds = {"encoder-decoder"} if cfg.is_encdec else set(block_pattern(cfg))
    if not kinds <= {"dense", "moe"}:
        raise ValueError(
            f"init_params_sharded: {cfg.name} is not a decoder-only LM of "
            f"dense and moe blocks ({', '.join(sorted(kinds))}): the other "
            "families' draw rules are ROADMAP.md item 32")
    if settings.fsdp:
        raise ValueError("init_params_sharded: no draw for fsdp placements")
    if "moe" in kinds and shd._EP["axis"] != "model":
        raise ValueError("init_params_sharded: experts over "
                         f"{shd._EP['axis']!r}: the draw tiles expert "
                         "stacks over 'model' only")
    if set(sizes) != {"data", "model"} or DRAW_TILES % sizes["model"] or (
            "moe" in kinds and cfg.n_experts % sizes["model"]):
        raise ValueError(f"init_params_sharded: mesh {sizes}: a (data, "
                         f"model) mesh with model dividing {DRAW_TILES} "
                         "and the expert count")
    device = torch.device(mesh.device_type,
                          torch.cuda.current_device()
                          if mesh.device_type == "cuda" else None)
    abstract = abstract_params(cfg)
    flat, spec = pytree.tree_flatten_with_path(abstract)
    placements = pytree.tree_leaves(
        param_placements(mesh, settings, abstract), is_leaf=shd.is_layout)
    out = []
    for idx, ((path, leaf), pl) in enumerate(zip(flat, placements)):
        block = _drawn_block(seed, idx, shd.path_str(path), leaf, pl, mesh,
                             device)
        out.append(DTensor.from_local(block, mesh, pl, run_check=False,
                                      shape=leaf.shape,
                                      stride=leaf.stride()))
    return pytree.tree_unflatten(out, spec)


def place_caches(mesh, cfg: ArchConfig, caches):
    """``init_lm_cache``'s tree (the same on every rank) as DTensors in
    ``data_shardings``' placements (``cache_pspec``), each rank cutting
    its blocks from its own copy."""
    from torch.distributed.tensor import distribute_tensor
    pl = data_shardings(mesh, cfg, {"caches": caches})["caches"]
    return pytree.tree_map(
        lambda t, p: distribute_tensor(t, mesh, p, src_data_rank=None),
        caches, pl, is_leaf=lambda x: isinstance(x, torch.Tensor))


def place_batch(mesh, batch):
    """Each tensor of ``batch`` (the global batch, the same on every
    rank) as a DTensor over the batch axes where they divide its first
    dim, cut locally from each rank's copy."""
    from torch.distributed.tensor import distribute_tensor

    def one(x):
        if not isinstance(x, torch.Tensor) or shd.is_dtensor(x):
            return x
        return distribute_tensor(
            x, mesh, shd.shard_layout(mesh, x.shape, 0 if x.ndim else None),
            src_data_rank=None)
    return pytree.tree_map(one, batch)


@contextlib.contextmanager
def sharded_context(mesh, settings: StepSettings, kind: str = "train"):
    """The model hooks of a step over ``mesh``: the activation
    constraints (sequence-parallel under ``seq_shard`` for a non-decode
    step), FSDP's in-loop resharding under ``fsdp``, and plain tensors
    made in model code (positions, masks, zeros) taken as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    seq = "model" if settings.seq_shard and kind != "decode" else None
    shd.set_activation_sharding(batch_axes(mesh), seq_axis=seq)
    if settings.fsdp:
        shd.set_param_resharding(mesh)
    try:
        with implicit_replication():
            yield
    finally:
        shd.clear_activation_sharding()
        shd.clear_param_resharding()


def _plain(x):
    """A replicated DTensor's value as a plain tensor (no communication);
    anything else as is."""
    return x.full_tensor() if shd.is_dtensor(x) else x


# --------------------------------------------------------------- steps ----

def split_microbatches(batch: Dict[str, torch.Tensor], m: int):
    """Each leaf (B, ...) as (m, B // m, ...): microbatch i is ``[i]``."""
    return pytree.tree_map(
        lambda x: x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:])), batch)


def _value_and_grad(loss_fn: Callable, params, batch
                    ) -> Tuple[torch.Tensor, Any, List[torch.Tensor]]:
    """(loss, metrics, grads) of ``loss_fn(params, batch) -> (loss,
    metrics)``; ``grads`` in ``pytree.tree_leaves(params)`` order, zeros
    for a leaf the loss does not reach (as ``jax.grad`` gives)."""
    leaves, spec = pytree.tree_flatten(params)
    with torch.enable_grad():
        live = [l.detach().requires_grad_(True) for l in leaves]
        loss, metrics = loss_fn(pytree.tree_unflatten(live, spec), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(l) if g is None else g
             for l, g in zip(leaves, grads)]
    return loss.detach(), pytree.tree_map(torch.Tensor.detach, metrics), grads


def _step_parts(cfg: ArchConfig, settings: StepSettings, mesh):
    """``(hooks, grads_of)`` of a train step: ``hooks()`` the context the
    step runs in (``sharded_context`` over ``mesh``, else none), and
    ``grads_of(params, batch) -> (loss, metrics, grads)`` its gradient
    half, run inside it. Without a mesh every hook is an identity, so
    both paths run one body."""
    acc_dt = dtype_of(settings.acc_dtype)

    def loss_fn(p, mb):
        if cfg.is_encdec:
            return encdec.encdec_loss(p, cfg, mb["frames"], mb["tokens"],
                                      mb["targets"], remat=settings.remat)
        return lm_loss(p, cfg, mb["tokens"], mb["targets"],
                       frontend=mb.get("frontend"), remat=settings.remat)

    if mesh is None:
        hooks = contextlib.nullcontext
        layouts = lambda params: [None] * len(pytree.tree_leaves(params))
        place = lambda batch: batch
    else:
        hooks = lambda: sharded_context(mesh, settings)
        layouts = lambda params: pytree.tree_leaves(
            shd.grad_shardings(mesh, params, zero=settings.zero_opt),
            is_leaf=shd.is_layout)
        place = lambda batch: place_batch(mesh, batch)

    def placed(grads, pl):
        # ZeRO-2: each gradient reduce-scattered out of its partial sum at
        # once, never kept as a full-size replica
        return [g if p is None else g.redistribute(placements=p)
                for g, p in zip(grads, pl)]

    def zeros(leaf, p):
        if p is None:
            return torch.zeros(leaf.shape, dtype=acc_dt, device=leaf.device)
        from torch.distributed.tensor import zeros as dzeros
        return dzeros(leaf.shape, dtype=acc_dt, device_mesh=mesh,
                      placements=p)

    def grads_of(params, batch):
        pl = layouts(params)
        m = settings.microbatches
        if m == 1:
            loss, metrics, grads = _value_and_grad(loss_fn, params,
                                                   place(batch))
            return loss, metrics, placed(grads, pl)
        mbs = split_microbatches(pytree.tree_map(_plain, batch), m)
        grads = [zeros(l, p) for l, p in zip(pytree.tree_leaves(params), pl)]
        loss, mets = 0.0, []
        for i in range(m):
            l, met, g = _value_and_grad(
                loss_fn, params, place(pytree.tree_map(lambda x: x[i], mbs)))
            for acc, gi in zip(grads, placed(g, pl)):
                acc.add_(gi)
            del g
            loss = loss + l
            mets.append(met)
        grads = [g / m for g in grads]
        loss = loss / m
        metrics = pytree.tree_map(
            lambda *a: torch.mean(torch.stack(a), 0), *mets)
        return loss, metrics, grads

    return hooks, grads_of


def make_value_and_grad(cfg: ArchConfig, settings: StepSettings, mesh=None):
    """``value_and_grad(params, batch) -> (loss, metrics, grads)``: the
    gradient half of ``make_train_step``'s step, the same code. ``grads``
    in ``pytree.tree_leaves(params)`` order, averaged over the
    microbatches, before clipping; over ``mesh`` DTensors in
    ``grad_shardings``' placements (the loss and metrics plain tensors,
    the same on every rank)."""
    hooks, grads_of = _step_parts(cfg, settings, mesh)

    def value_and_grad(params, batch):
        with hooks():
            loss, metrics, grads = grads_of(params, batch)
        return _plain(loss), pytree.tree_map(_plain, metrics), grads

    return value_and_grad


def make_train_step(cfg: ArchConfig, settings: StepSettings, mesh=None):
    """Returns ``(train_step, opt)``. ``train_step(params, opt_state, step,
    batch) -> (params, opt_state, metrics)`` updates ``params`` and
    ``opt_state`` in place and returns them; ``batch``: ``tokens`` and
    ``targets`` (B, S) int, and ``frames`` (B, T, d) for an
    encoder-decoder config or an optional ``frontend`` (B, N, d);
    ``metrics``: the loss's (``ce``, MoE aux) with ``loss`` and
    ``grad_norm`` (before clipping), 0-d tensors on the params' device
    (reading one is the caller's host sync).

    Over ``mesh``: ``params`` and ``opt_state`` are ``shard_state``'s
    DTensors; ``batch`` is the global batch on every rank (plain tensors,
    or DTensors over the batch axes, which a microbatched step gathers
    back first: tokens are small); the metrics are plain tensors, the
    same on every rank."""
    opt = make_optimizer(settings)
    hooks, grads_of = _step_parts(cfg, settings, mesh)

    def train_step(params, opt_state, step, batch):
        with hooks():
            loss, metrics, grads = grads_of(params, batch)
            with torch.no_grad():
                gnorm = global_norm(grads)
                opt.update_in_place(grads, opt_state, params, step,
                                    clip_scale(gnorm, settings.grad_clip))
        metrics = pytree.tree_map(_plain, dict(metrics, loss=loss,
                                                grad_norm=gnorm))
        return params, opt_state, metrics

    return train_step, opt


def make_prefill_step(cfg: ArchConfig, settings: StepSettings, mesh=None):
    """``prefill(params, batch) -> logits``: the full-sequence forward of
    ``batch["tokens"]`` (float32 (B, S, V); with a ``frontend`` (B, N +
    S, V)), without gradient; for an encoder-decoder config the decoder's
    teacher-forced logits over ``encode(batch["frames"])``. Over ``mesh``
    the params are DTensors (``param_placements``), the batch is placed
    over the batch axes, and the logits are a DTensor."""

    def prefill(params, batch):
        with torch.no_grad():
            if cfg.is_encdec:
                enc = encdec.encode(params, cfg, batch["frames"],
                                    remat=settings.remat)
                return encdec.decode_train(params, cfg, enc, batch["tokens"],
                                           remat=settings.remat)
            logits, _ = lm_forward(params, cfg, batch["tokens"],
                                   frontend=batch.get("frontend"),
                                   remat=settings.remat)
        return logits

    if mesh is None:
        return prefill

    def sharded_prefill(params, batch):
        with sharded_context(mesh, settings, "prefill"):
            return prefill(params, place_batch(mesh, batch))

    return sharded_prefill


def make_serve_step(cfg: ArchConfig, mesh=None,
                    settings: Optional[StepSettings] = None):
    """``serve(params, token, caches, cur_index) -> (logits, caches)``: one
    cached decode step (``lm_decode_step``; ``encdec_decode_step`` over
    ``init_dec_cache``'s caches for an encoder-decoder config), the caches
    updated in place. Over ``mesh`` the params and caches are DTensors
    (``param_placements``, ``data_shardings``), the token is placed over
    the batch axes, and the logits are a DTensor."""
    settings = settings or StepSettings()
    step = encdec.encdec_decode_step if cfg.is_encdec else lm_decode_step

    def serve(params, token, caches, cur_index):
        with torch.no_grad():
            return step(params, cfg, token, caches, cur_index)

    if mesh is None:
        return serve

    def sharded_serve(params, token, caches, cur_index):
        with sharded_context(mesh, settings, "decode"):
            return serve(params, place_batch(mesh, token), caches,
                         int(cur_index))

    return sharded_serve
