"""Causal LM — the ``dense``, ``moe``, ``attn``, ``rec`` and ``rwkv`` block
kinds of ``repro/models/lm.py``.

The layer stack is a repeating block *pattern*; groups of the pattern are
parameter-stacked on a leading ``n_groups`` axis (the reference's layout,
so weights carry across leaf for leaf) and applied in a Python loop. A
remainder of ``n_layers mod len(pattern)`` becomes explicit tail layers.
Ported: ``dense`` blocks (attention + FFN), ``moe`` blocks (attention +
mixture of experts, ``nn/moe.py``, with llama4's shared expert beside
them), Griffin's ``rec`` (RG-LRU recurrence + FFN) and ``attn`` (local
attention + FFN) blocks, and RWKV-6's ``rwkv`` blocks (time mix +
channel mix); learned positions (``pos_embed``, 8,192 rows, added over
the whole sequence) and the ``patches`` frontend (``patch_proj`` of
precomputed patch embeddings, prepended to the text). ``whisper_base``
through ``init_lm`` is the reference's decoder-only LM with learned
positions; its encoder-decoder model is ``models/encdec.py``.
``lm_forward`` returns the MoE aux terms summed over groups (within a
group ``moe_dropped`` is a max) and ``lm_loss`` weighs them in. Both take
the reference's ``remat`` policy (``repro/models/lm.py:387–391``):
``"full"`` recomputes each group's forward in the backward, ``"dots"``
keeps the outputs of its matrix products and recomputes the rest; the
tail blocks are never rematerialised.

Decode keeps per-block caches with the reference's tree and dtypes: KV
buffers for attention (a rotating buffer under a window), the conv
carry and float32 RG-LRU state for ``rec``, the token-shift rows and
float32 WKV state for ``rwkv``; group caches stack on a leading
``n_groups`` axis. ``lm_decode_step`` updates them in place. A prefill
from position 0 is the full-sequence forward (``block_apply`` with a
cache), so it runs the port's kernels; its hidden states are those of
``lm_forward`` for every kind but ``moe``. Expert routing is not row
independent (a full expert drops slots), and the reference's prefill is
a scan of decode steps: so a ``moe`` block in the prefill dispatches
each position's B tokens alone with the decode step's rule
(``moe_apply``, capacity factor at least 2), while its attention and
caches stay full-sequence.

``PERF_OPT`` (``set_perf_options``) holds the reference's two run-time
performance options, off by default: ``int8_dispatch`` quantizes each
token of a full-sequence MoE dispatch to int8 with a per-token scale
before the expert GEMMs (``nn/moe.py``; the decode rule has no int8
path, as in the reference), and ``kv_int8`` makes every unwindowed KV
cache int8 with per-(token, head) scales (``nn/attention.py``). A
prefill from position 0 into an int8 cache runs the flash kernel over
the dequantized k and v, the values the reference's decode steps attend
over.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.nn.attention import (NEG_INF, attention_init,
                                     decode_attend, decode_qkv, init_cache,
                                     mha, mha_decode, read_kv, write_kv)
from repro_torch.nn.ffn import (ffn_apply, ffn_init, rwkv_channel_mix,
                                rwkv_channel_mix_init)
from repro_torch.nn.moe import moe_apply, moe_apply_sorted, moe_init
from repro_torch.nn.module import (dense, dense_init, embedding_init,
                                   embedding_rows, rmsnorm, rmsnorm_init,
                                   truncated_normal_init)
from repro_torch.nn.rglru import (causal_conv1d, griffin_recurrent_apply,
                                  griffin_recurrent_init, rglru_decode_step)
from repro_torch.nn.rwkv6 import (rwkv6_decode_step, rwkv6_init,
                                  rwkv6_time_mix)

Params = Any
POS_ROWS = 8192     # learned position table of a decoder-only LM


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# Run-time performance options (set by the caller, not by model code):
#   int8_dispatch -- int8 MoE dispatch payload with per-token scales
#   kv_int8       -- int8 KV cache with per-(token, head) scales
PERF_OPT = {"int8_dispatch": False, "kv_int8": False}


def set_perf_options(**kw) -> None:
    for k, v in kw.items():
        if k not in PERF_OPT:
            raise KeyError(f"unknown performance option {k!r}: one of "
                           f"{sorted(PERF_OPT)}")
        PERF_OPT[k] = v


# ----------------------------------------------------------- patterns ----

def block_pattern(cfg: ArchConfig) -> Tuple[str, ...]:
    if cfg.rwkv_heads:
        return ("rwkv",)
    if cfg.pattern_attn_every:
        return ("rec",) * (cfg.pattern_attn_every - 1) + ("attn",)
    if cfg.n_experts:
        if cfg.moe_every == 1:
            return ("moe",)
        return ("dense",) * (cfg.moe_every - 1) + ("moe",)
    return ("dense",)


def group_layout(cfg: ArchConfig) -> Tuple[Tuple[str, ...], int, int]:
    pattern = block_pattern(cfg)
    n_groups, tail = divmod(cfg.n_layers, len(pattern))
    return pattern, n_groups, tail


def discrete_nfe(cfg: ArchConfig) -> int:
    """Depth-ODE NFE equivalent of the discrete full-depth forward: one
    vector-field (= block-group) evaluation per group."""
    _, n_groups, _ = group_layout(cfg)
    return n_groups


# ------------------------------------------------------------- blocks ----

def block_init(gen, cfg: ArchConfig, kind: str, lead=(), device=None) -> Params:
    pd = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    kw = dict(lead=lead, device=device)
    if kind == "rwkv":
        return {
            "ln1": rmsnorm_init(d, pd, **kw),
            "tmix": rwkv6_init(gen, d, cfg.rwkv_heads, cfg.lora_rank, pd,
                               **kw),
            "ln2": rmsnorm_init(d, pd, **kw),
            "cmix": rwkv_channel_mix_init(gen, d, cfg.d_ff, pd, **kw),
        }
    if kind == "rec":
        mixer = {"griffin": griffin_recurrent_init(gen, d, cfg.lru_width,
                                                   pd, **kw)}
    elif kind in ("dense", "attn", "moe"):
        mixer = {"attn": attention_init(gen, d, cfg.n_heads, cfg.n_kv,
                                        cfg.d_head, qk_norm=cfg.qk_norm,
                                        param_dtype=pd, **kw)}
    else:
        raise ValueError(kind)
    p = {"ln1": rmsnorm_init(d, pd, **kw), **mixer,
         "ln2": rmsnorm_init(d, pd, **kw)}
    if kind != "moe":
        p["ffn"] = ffn_init(gen, d, cfg.d_ff, cfg.gated_ffn, pd, **kw)
        return p
    p["moe"] = moe_init(gen, d, cfg.d_ff_expert or cfg.d_ff, cfg.n_experts,
                        gated=cfg.gated_ffn, param_dtype=pd, **kw)
    if cfg.shared_expert:
        p["shared"] = ffn_init(gen, d, cfg.d_ff, cfg.gated_ffn, pd, **kw)
    return p


def _attn_kwargs(cfg: ArchConfig, kind: str) -> Dict:
    """An ``attn`` block of a patterned (Griffin) model attends over its
    local window; every other attention block over ``cfg.window``."""
    window = cfg.local_window if (kind == "attn" and cfg.pattern_attn_every) \
        else cfg.window
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_head=cfg.d_head,
                rope_theta=cfg.rope_theta, window=window,
                qk_norm=cfg.qk_norm, use_rope=(cfg.pos == "rope"))


def ZERO_AUX(device=None) -> Dict[str, torch.Tensor]:
    """The MoE aux terms of a stack with no expert block."""
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("moe_aux", "moe_z", "moe_dropped")}


def _moe_ffn(p: Params, cfg: ArchConfig, xn: torch.Tensor, *,
             decode_rule: bool, per_row: bool):
    """A ``moe`` block's feed-forward: (its experts plus the shared expert
    where the config has one, the dispatch's ``MoEOutput``). The
    full-sequence rule is the sorted dispatch at the config's capacity
    factor, in int8 under ``PERF_OPT["int8_dispatch"]``; the decode
    step's is the einsum dispatch at a factor of at least 2, each
    position alone."""
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k, act=cfg.act)
    if decode_rule:
        out = moe_apply(p["moe"], xn,
                        capacity_factor=max(cfg.capacity_factor, 2.0),
                        groups="position", **kw)
    else:
        out = moe_apply_sorted(p["moe"], xn,
                               capacity_factor=cfg.capacity_factor,
                               int8_dispatch=PERF_OPT["int8_dispatch"],
                               groups="row" if per_row else "all", **kw)
    y = out.y
    if "shared" in p:
        y = y + ffn_apply(p["shared"], xn, act=cfg.act)
    return y, out


def _residual(h: torch.Tensor) -> torch.Tensor:
    """The residual stream after a block's sub-layer, held to the
    ``"residual"`` placements over a device mesh (``constrain``; a no-op
    otherwise). The reference constrains only between groups and lets
    GSPMD carry the layout through each block; DTensor chooses each op's
    output placements locally (a tensor-parallel sum may come out
    sharded along the sequence), so the port pins every residual add."""
    return shd.constrain(h, "residual")


def _add_aux(aux, out):
    """``aux`` (a ``ZERO_AUX`` tree when None) with a dispatch's terms
    added, ``moe_dropped`` as a max."""
    if aux is None:
        aux = ZERO_AUX(out.y.device)
    return {"moe_aux": aux["moe_aux"] + out.aux_loss,
            "moe_z": aux["moe_z"] + out.router_z_loss,
            "moe_dropped": torch.maximum(aux["moe_dropped"],
                                         out.fraction_dropped)}


def block_apply(p: Params, cfg: ArchConfig, kind: str, h: torch.Tensor,
                aux=None, cache: Params = None, per_row: bool = False):
    """Full-sequence (train / prefill) block application; returns (h,
    aux). A ``moe`` block adds its aux terms to ``aux`` (a ``ZERO_AUX``
    tree made here when None); every other kind passes ``aux`` on as is.

    With ``cache`` (the block's decode cache, ``block_cache_init``'s
    layout) the sequence sits at positions 0..S-1: the recurrent blocks
    start from the cache's state (zeros in a fresh cache), and the block
    writes into ``cache``, in place, what decoding position S needs — the
    state that feeding the tokens one by one through ``block_decode``
    leaves; a ``moe`` block then routes as the decode steps would, and
    an int8 cache's attention runs over the dequantized k and v.
    ``per_row`` dispatches each batch row's tokens alone (a per-sample
    depth field)."""
    if kind == "rwkv":
        state = None if cache is None else (cache["x_tmix"].to(h.dtype),
                                            cache["S"])
        tm, (x_tmix, S) = rwkv6_time_mix(
            p["tmix"], rmsnorm(p["ln1"], h), cfg.rwkv_heads, state=state,
            want_state=cache is not None)
        h = _residual(h + tm)
        xn = rmsnorm(p["ln2"], h)
        first = torch.zeros_like(xn[:, :1]) if cache is None \
            else cache["x_cmix"][:, None].to(xn.dtype)
        x_prev = torch.cat([first, xn[:, :-1]], dim=1)
        if cache is not None:
            cache["x_tmix"].copy_(x_tmix)
            cache["S"].copy_(S)
            cache["x_cmix"].copy_(xn[:, -1])
        return _residual(h + rwkv_channel_mix(p["cmix"], xn, x_prev)), aux
    if kind == "rec":
        state = None if cache is None else (cache["conv"].to(h.dtype),
                                            cache["h"])
        y, (conv, h_T) = griffin_recurrent_apply(
            p["griffin"], rmsnorm(p["ln1"], h), state)
        if cache is not None:
            cache["conv"].copy_(conv)
            cache["h"].copy_(h_T)
        h = _residual(h + y)
    else:   # dense, attn, moe
        kwargs = _attn_kwargs(cfg, kind)
        a = mha(p["attn"], rmsnorm(p["ln1"], h),
                return_kv=cache is not None,
                kv_int8=cache is not None and cache["k"].dtype == torch.int8,
                **kwargs)
        if cache is not None:
            a, (k, v) = a
            _prefill_kv(cache, k, v, kwargs["window"])
        h = _residual(h + a)
    xn = rmsnorm(p["ln2"], h)
    if kind == "moe":
        y, out = _moe_ffn(p, cfg, xn, decode_rule=cache is not None,
                          per_row=per_row)
        return _residual(h + y), _add_aux(aux, out)
    return _residual(h + ffn_apply(p["ffn"], xn, act=cfg.act)), aux


def _prefill_kv(cache, k: torch.Tensor, v: torch.Tensor, window) -> None:
    """Positions 0..S-1 of k, v into the cache as the token-by-token
    writes leave it: position p at slot p % buf, so a rotating (windowed)
    buffer keeps the last buf positions."""
    S, buf = k.shape[1], cache["k"].shape[1]
    if window is None and S > buf:
        raise ValueError(f"prefill of {S} positions into a KV cache of "
                         f"{buf}")
    # positions lo..S-1 fill at most two runs of slots, each written
    # through a slice (DTensor caches take no index_put_)
    lo = max(S - buf, 0)
    first = min(S - lo, buf - lo % buf)
    write_kv(cache, slice(lo % buf, lo % buf + first), k[:, lo:lo + first],
             v[:, lo:lo + first])
    if lo + first < S:
        write_kv(cache, slice(0, S - lo - first), k[:, lo + first:],
                 v[:, lo + first:])


# ------------------------------------------------------------- caches ----

def block_cache_init(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                     dtype: torch.dtype, device=None) -> Params:
    d = cfg.d_model
    if kind in ("dense", "attn", "moe"):
        window = _attn_kwargs(cfg, kind)["window"]
        buf = min(max_len, window) if window else max_len
        return init_cache(batch, buf, cfg.n_kv, cfg.d_head, dtype,
                          device=device,
                          kv_int8=PERF_OPT["kv_int8"] and window is None)
    if kind == "rwkv":
        hd = d // cfg.rwkv_heads
        return {
            "x_tmix": torch.zeros((batch, d), dtype=dtype, device=device),
            "S": torch.zeros((batch, cfg.rwkv_heads, hd, hd),
                             dtype=torch.float32, device=device),
            "x_cmix": torch.zeros((batch, d), dtype=dtype, device=device),
        }
    return {    # rec
        "conv": torch.zeros((batch, 3, cfg.lru_width), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                         device=device),
    }


def _rotating_decode_attn(p, cfg: ArchConfig, kind: str, h, cache,
                          cur_index: int):
    """Decode attention with a rotating buffer when windowed (O(window));
    plain indexed cache otherwise. RoPE is applied at write time with
    absolute positions (rotation-safe: scores depend on position
    deltas)."""
    kwargs = _attn_kwargs(cfg, kind)
    window = kwargs.pop("window")
    if window is None:
        return mha_decode(p["attn"], h, cache, cur_index, **kwargs)
    buf = cache["k"].shape[1]
    q, k_new, v_new = decode_qkv(p["attn"], h, cur_index, **kwargs)
    slot = cur_index % buf
    write_kv(cache, slice(slot, slot + 1), k_new, v_new)
    k_all, v_all = read_kv(cache, h.dtype)
    # slot i holds absolute position cur - ((slot - i) mod buf)
    idx = torch.arange(buf, device=h.device)
    abs_pos = cur_index - torch.remainder(slot - idx, buf)
    valid = (abs_pos >= 0) & (cur_index - abs_pos < window)
    bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    return decode_attend(p["attn"], q, k_all, v_all, bias, h.dtype), cache


def block_decode(p: Params, cfg: ArchConfig, kind: str, h: torch.Tensor,
                 cache: Params, cur_index: int):
    """Single-token decode. h: (B, 1, d); ``cur_index``: the Python int
    position. Updates ``cache`` in place; returns (h, cache)."""
    if kind in ("dense", "attn", "moe"):
        a, cache = _rotating_decode_attn(p, cfg, kind, rmsnorm(p["ln1"], h),
                                         cache, cur_index)
        h = _residual(h + a)
        xn = rmsnorm(p["ln2"], h)
        if kind == "moe":
            y, _ = _moe_ffn(p, cfg, xn, decode_rule=True, per_row=False)
            return _residual(h + y), cache
        return _residual(h + ffn_apply(p["ffn"], xn, act=cfg.act)), cache
    if kind == "rwkv":
        xn = rmsnorm(p["ln1"], h)[:, 0]
        tm, (x_tmix, S) = rwkv6_decode_step(
            p["tmix"], xn, (cache["x_tmix"].to(xn.dtype), cache["S"]),
            cfg.rwkv_heads)
        h = _residual(h + tm[:, None])
        xn2 = rmsnorm(p["ln2"], h)[:, 0]
        cm = rwkv_channel_mix(p["cmix"], xn2[:, None],
                              cache["x_cmix"][:, None].to(xn2.dtype))
        cache["x_tmix"].copy_(x_tmix)
        cache["S"].copy_(S)
        cache["x_cmix"].copy_(xn2)
        return _residual(h + cm), cache
    # rec
    xn = rmsnorm(p["ln1"], h)
    gp = p["griffin"]
    u = dense(gp["in_rec"], xn)
    g = F.gelu(dense(gp["in_gate"], xn), approximate="tanh")
    u, conv = causal_conv1d(gp["conv"], u, cache["conv"].to(u.dtype))
    y_t, h_state = rglru_decode_step(gp["rglru"], u[:, 0], cache["h"])
    h = _residual(h + dense(gp["out"], y_t[:, None] * g))
    cache["conv"].copy_(conv)
    cache["h"].copy_(h_state)
    y = ffn_apply(p["ffn"], rmsnorm(p["ln2"], h), act=cfg.act)
    return _residual(h + y), cache


# -------------------------------------------------------------- model ----

def init_lm(gen: torch.Generator, cfg: ArchConfig, device=None) -> Params:
    """Random weights drawn from ``gen`` on ``device``, with the reference's
    tree: group leaves stacked on a leading ``n_groups`` axis; a learned
    position table for ``pos == "learned"`` and the patch projection for
    the ``patches`` frontend."""
    pd = dtype_of(cfg.param_dtype)
    pattern, n_groups, tail = group_layout(cfg)
    params = {
        "embed": embedding_init(gen, cfg.vocab, cfg.d_model, pd, device),
        "groups": {f"b{i}": block_init(gen, cfg, kind, lead=(n_groups,),
                                       device=device)
                   for i, kind in enumerate(pattern)},
        "ln_f": rmsnorm_init(cfg.d_model, pd, device=device),
        "tail": {f"t{i}": block_init(gen, cfg, pattern[i], device=device)
                 for i in range(tail)},
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, cfg.d_model, cfg.vocab, pd,
                                    device=device)
    if cfg.pos == "learned":
        params["pos_embed"] = truncated_normal_init(
            gen, (POS_ROWS, cfg.d_model), 0.02, pd, device)
    if cfg.frontend == "patches":
        params["patch_proj"] = dense_init(gen, cfg.d_model, cfg.d_model, pd,
                                          device=device)
    return params


def group_params(params, g: int) -> Params:
    """Group ``g``'s slice of the stacked group params (views, no copy)."""
    return pytree.tree_map(lambda p: p[g], params["groups"])


def _embed(params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    dt = dtype_of(cfg.dtype)
    h = embedding_rows(params["embed"]["table"], tokens.long()).to(dt)
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=h.device)
    return h


def embed_inputs(params, cfg: ArchConfig, tokens: torch.Tensor,
                 frontend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The token embeddings (B, S, d), with a ``frontend``'s precomputed
    modality embeddings (B, N, d) projected by ``patch_proj`` and
    prepended: (B, N + S, d). No positions (the depth path's state)."""
    h = _embed(params, cfg, tokens)
    if frontend is None:
        return h
    fe = dense(params["patch_proj"], frontend.to(h.dtype))
    return torch.cat([fe, h], dim=1)


def add_positions(params, cfg: ArchConfig, h: torch.Tensor,
                  start: int = 0) -> torch.Tensor:
    """h (B, S, d) at positions ``start``.. with the learned position
    rows added (``pos == "learned"``); h itself otherwise."""
    if cfg.pos != "learned":
        return h
    return h + params["pos_embed"][start:start + h.shape[1]].to(h.dtype)


def readout_weight(params, cfg: ArchConfig,
                   dtype: torch.dtype) -> torch.Tensor:
    """The float32 (d, V) readout matrix for activations of ``dtype``: the
    vocabulary table rounded to ``dtype``, then widened. For tied
    embeddings this is a full float32 copy of the table, so a decode loop
    builds it once and passes it to every step."""
    if cfg.tie_embeddings:
        return params["embed"]["table"].to(dtype).T.float()
    return params["head"]["kernel"].to(dtype).float()


def _readout(params, cfg: ArchConfig, h: torch.Tensor,
             w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Float32 logits: low-precision operands multiplied exactly and summed
    in float32 (never rounded to the activation type). ``w``: a prebuilt
    ``readout_weight`` (built here when None)."""
    h = rmsnorm(params["ln_f"], h)
    if w is None:
        w = readout_weight(params, cfg, h.dtype)
    return torch.matmul(shd.matmul_ready(h.float(), w), w)


REMAT_POLICIES = ("none", "dots", "full")

# The matrix products of a group (``dense``, the attention and MoE
# einsums and bmms): what ``"dots"`` keeps, the counterpart of
# ``jax.checkpoint_policies.checkpoint_dots``.
_DOT_OPS = frozenset({
    torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
    torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default,
})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _rematerialised(fn, remat: str):
    """``fn`` under the reference's remat policy: ``"full"`` saves only its
    inputs and replays it in the backward, ``"dots"`` also saves its
    matrix products' outputs (a selective checkpoint), ``"none"`` is
    ``fn``. Outside autograd (no grad, or nothing requiring it) the
    policy changes nothing, so ``fn`` runs as is."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat {remat!r}: one of {REMAT_POLICIES}")
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                    _save_dots)
                  if remat == "dots" else noop_context_fn)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                 context_fn=context_fn)


def _blocks(params, cfg: ArchConfig, h: torch.Tensor, caches=None,
            remat: str = "none"):
    """Every block over the full sequence h, groups then tail; with
    ``caches`` (``init_lm_cache``'s tree) each block also fills its own.
    Returns (h, aux): each group's aux terms (``moe_dropped`` a max
    within the group) summed over the groups, the tail's added on as
    its blocks add them (the reference's scan, then the tail). ``remat``
    wraps each group's body (``_rematerialised``), never the tail."""
    pattern, n_groups, tail = group_layout(cfg)
    total = ZERO_AUX(h.device)

    def group(h, g):
        gp = shd.constrain_group_params(group_params(params, g))
        gc = None if caches is None else _group_caches(caches, g)
        aux = None
        for i, kind in enumerate(pattern):
            h, aux = block_apply(gp[f"b{i}"], cfg, kind, h, aux,
                                 None if gc is None else gc[f"b{i}"])
        return h, aux

    group_fn = group if caches is not None else _rematerialised(group, remat)
    h = shd.constrain(h, "residual")
    for g in range(n_groups):
        h, aux = group_fn(h, g)
        h = shd.constrain(h, "residual")
        if aux is not None:
            total = {k: total[k] + aux[k] for k in total}
    for i in range(tail):
        h, total = block_apply(params["tail"][f"t{i}"], cfg, pattern[i], h,
                               total, None if caches is None
                               else caches["tail"][f"t{i}"])
    return h, total


def lm_forward(params, cfg: ArchConfig, tokens: torch.Tensor, frontend=None,
               remat: str = "none"):
    """tokens: (B, S) int; ``frontend``: precomputed modality embeddings
    (B, N, d) prepended to the text (PaliGemma's patches). Returns
    (logits float32 (B, N + S, V), aux dict of ``moe_aux``, ``moe_z`` and
    ``moe_dropped``, zero without experts). ``remat``: ``"none"``,
    ``"dots"`` or ``"full"`` (module docstring); the values and gradients
    are the same under each."""
    h = add_positions(params, cfg, embed_inputs(params, cfg, tokens,
                                                frontend))
    h, aux = _blocks(params, cfg, h, remat=remat)
    return shd.constrain(_readout(params, cfg, h), "logits"), aux


def gold_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``logits[..., targets]``: each position's target logit. Over a
    vocabulary sharded across a mesh axis (a DTensor), each device picks
    the targets its shard holds and the rest count zero, a partial sum
    over that axis: the full logits are never gathered."""
    if not shd.is_dtensor(logits):
        return torch.gather(logits, -1, targets[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    vdim = logits.ndim - 1
    lp = logits.placements
    vocab_axes = [i for i, p in enumerate(lp) if p == Shard(vdim)]
    if not vocab_axes:
        return torch.gather(logits, -1, targets[..., None])[..., 0]
    tp = tuple(Replicate() if p == Shard(vdim) else p for p in lp)
    out = tuple(Partial() if p == Shard(vdim) else p for p in lp)
    V = logits.shape[-1]

    def local(lg, t):
        lo = 0
        for i in vocab_axes:      # this device's first vocabulary row
            n = mesh.size(i)
            lo = lo * n + mesh.get_local_rank(i)
        lo *= lg.shape[-1]
        t = t - lo
        hit = (t >= 0) & (t < lg.shape[-1])
        g = torch.gather(lg, -1, torch.where(hit, t, 0)[..., None])[..., 0]
        return torch.where(hit, g, torch.zeros((), dtype=g.dtype))

    assert V % math.prod(mesh.size(i) for i in vocab_axes) == 0, V
    return local_map(local, out_placements=(out,), in_placements=(lp, tp),
                     device_mesh=mesh)(logits, targets)


def lm_loss(params, cfg: ArchConfig, tokens: torch.Tensor,
            targets: torch.Tensor, frontend=None, remat: str = "none",
            moe_aux_weight: float = 0.01, moe_z_weight: float = 1e-3):
    """Mean next-token cross-entropy of ``lm_forward``'s float32 logits,
    plus the weighted MoE aux and z terms for a config with experts.
    Returns (loss, metrics: ``ce`` and the aux tree). ``remat`` as in
    ``lm_forward``; with a ``frontend`` the loss reads the text
    positions' logits only (the last ``S``)."""
    logits, aux = lm_forward(params, cfg, tokens, frontend, remat=remat)
    if frontend is not None:
        logits = logits[:, -tokens.shape[1]:]
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ce = torch.mean(logz - gold_logits(logits, targets.long()))
    loss = ce
    if cfg.n_experts:
        loss = loss + moe_aux_weight * aux["moe_aux"] + \
            moe_z_weight * aux["moe_z"]
    return loss, {"ce": ce, **aux}


# ------------------------------------------------------------- decode ----

def init_lm_cache(cfg: ArchConfig, batch: int, max_len: int,
                  dtype: Optional[torch.dtype] = None, device=None) -> Params:
    """Zeroed decode caches, the reference's tree: group caches stacked on
    a leading ``n_groups`` axis (an int8 cache's scales too), tail caches
    beside them."""
    dtype = dtype or dtype_of(cfg.dtype)
    pattern, n_groups, tail = group_layout(cfg)
    one = {f"b{i}": block_cache_init(cfg, kind, batch, max_len, dtype,
                                     device)
           for i, kind in enumerate(pattern)}
    stacked = pytree.tree_map(
        lambda l: l[None].repeat(n_groups, *([1] * l.ndim)), one)
    tail_caches = {f"t{i}": block_cache_init(cfg, pattern[i], batch,
                                             max_len, dtype, device)
                   for i in range(tail)}
    return {"groups": stacked, "tail": tail_caches}


def _group_caches(caches, g: int) -> Params:
    """Group ``g``'s slice of the stacked caches (views: writes land in
    the stack)."""
    return pytree.tree_map(lambda l: l[g], caches["groups"])


def lm_decode_step(params, cfg: ArchConfig, token: torch.Tensor, caches,
                   cur_index: int, readout_w: Optional[torch.Tensor] = None):
    """One decode step. token: (B,) int; ``cur_index``: the Python int
    position; ``readout_w``: a prebuilt ``readout_weight``. Updates
    ``caches`` in place; returns (logits (B, V) float32, caches)."""
    pattern, n_groups, tail = group_layout(cfg)
    h = add_positions(params, cfg, _embed(params, cfg, token[:, None]),
                      cur_index)
    for g in range(n_groups):
        gp = shd.constrain_group_params(group_params(params, g))
        gc = _group_caches(caches, g)
        for i, kind in enumerate(pattern):
            h, _ = block_decode(gp[f"b{i}"], cfg, kind, h, gc[f"b{i}"],
                                cur_index)
    for i in range(tail):
        h, _ = block_decode(params["tail"][f"t{i}"], cfg, pattern[i], h,
                            caches["tail"][f"t{i}"], cur_index)
    return _readout(params, cfg, h, readout_w)[:, 0], caches


def lm_prefill(params, cfg: ArchConfig, prompt: torch.Tensor, caches,
               start_index: int = 0,
               readout_w: Optional[torch.Tensor] = None):
    """Populate the decode caches for a whole prompt (B, P) placed at
    positions ``start_index``.. and return (logits of the last position
    (B, V) float32, caches); the caches are updated in place.

    From position 0 this is the full-sequence forward with every block
    filling its cache (``block_apply``), the port's counterpart of the
    reference's one compiled forward: the kernels run, and the hidden
    states are ``lm_forward``'s (a ``moe`` block routing each position as
    a decode step). Only the last position is read out.
    From a later position it is the reference's own algorithm: one
    ``lm_decode_step`` per position."""
    if start_index:
        logits = None
        for i in range(prompt.shape[1]):
            logits, caches = lm_decode_step(params, cfg, prompt[:, i],
                                            caches, start_index + i,
                                            readout_w)
        return logits, caches
    h = add_positions(params, cfg, _embed(params, cfg, prompt))
    h, _ = _blocks(params, cfg, h, caches)
    return _readout(params, cfg, h[:, -1:], readout_w)[:, 0], caches


def count_params(params) -> int:
    return sum(l.numel() for l in pytree.tree_leaves(params))
