"""Causal LM — the ``dense``, ``attn``, ``rec`` and ``rwkv`` block kinds of
``repro/models/lm.py``.

The layer stack is a repeating block *pattern*; groups of the pattern are
parameter-stacked on a leading ``n_groups`` axis (the reference's layout,
so weights carry across leaf for leaf) and applied in a Python loop. A
remainder of ``n_layers mod len(pattern)`` becomes explicit tail layers.
Ported: ``dense`` blocks (attention + FFN, no experts), Griffin's
``rec`` (RG-LRU recurrence + FFN) and ``attn`` (local attention + FFN)
blocks, and RWKV-6's ``rwkv`` blocks (time mix + channel mix). MoE
blocks, learned positions and modality frontends raise
``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import ArchConfig
from repro_torch.nn.attention import attention_init, mha
from repro_torch.nn.ffn import (ffn_apply, ffn_init, rwkv_channel_mix,
                                rwkv_channel_mix_init)
from repro_torch.nn.module import (dense_init, embedding_init, rmsnorm,
                                   rmsnorm_init)
from repro_torch.nn.rglru import (griffin_recurrent_apply,
                                  griffin_recurrent_init)
from repro_torch.nn.rwkv6 import rwkv6_init, rwkv6_time_mix

Params = Any

_NOT_PORTED = {
    "moe": "ROADMAP.md queue 1 item 6 (other LM block kinds: MoE)",
}


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def _require_ported(kind: str) -> None:
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet: {_NOT_PORTED[kind]}")


def _require_plain_lm(cfg: ArchConfig) -> None:
    if cfg.pos == "learned" or cfg.frontend or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: learned positions, modality frontends and "
            "encoder-decoder models are not ported yet: ROADMAP.md queue 1 "
            "item 6 (other LM block kinds and models)")


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
    _require_ported(kind)
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
    else:   # dense, attn
        mixer = {"attn": attention_init(gen, d, cfg.n_heads, cfg.n_kv,
                                        cfg.d_head, qk_norm=cfg.qk_norm,
                                        param_dtype=pd, **kw)}
    return {
        "ln1": rmsnorm_init(d, pd, **kw),
        **mixer,
        "ln2": rmsnorm_init(d, pd, **kw),
        "ffn": ffn_init(gen, d, cfg.d_ff, cfg.gated_ffn, pd, **kw),
    }


def _attn_kwargs(cfg: ArchConfig, kind: str) -> Dict:
    """An ``attn`` block of a patterned (Griffin) model attends over its
    local window; every other attention block over ``cfg.window``."""
    window = cfg.local_window if (kind == "attn" and cfg.pattern_attn_every) \
        else cfg.window
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_head=cfg.d_head,
                rope_theta=cfg.rope_theta, window=window,
                qk_norm=cfg.qk_norm, use_rope=(cfg.pos == "rope"))


def block_apply(p: Params, cfg: ArchConfig, kind: str,
                h: torch.Tensor) -> torch.Tensor:
    """Full-sequence (train / prefill) block application. The reference
    threads an aux-loss dict through; these block kinds never touch it."""
    _require_ported(kind)
    if kind == "rwkv":
        tm, _ = rwkv6_time_mix(p["tmix"], rmsnorm(p["ln1"], h),
                               cfg.rwkv_heads, want_state=False)
        h = h + tm
        xn = rmsnorm(p["ln2"], h)
        x_prev = torch.cat([torch.zeros_like(xn[:, :1]), xn[:, :-1]], dim=1)
        return h + rwkv_channel_mix(p["cmix"], xn, x_prev)
    if kind == "rec":
        y, _ = griffin_recurrent_apply(p["griffin"], rmsnorm(p["ln1"], h))
        h = h + y
    else:   # dense, attn
        h = h + mha(p["attn"], rmsnorm(p["ln1"], h),
                    **_attn_kwargs(cfg, kind))
    return h + ffn_apply(p["ffn"], rmsnorm(p["ln2"], h), act=cfg.act)


# -------------------------------------------------------------- model ----

def init_lm(gen: torch.Generator, cfg: ArchConfig, device=None) -> Params:
    """Random weights drawn from ``gen`` on ``device``, with the reference's
    tree: group leaves stacked on a leading ``n_groups`` axis."""
    _require_plain_lm(cfg)
    pd = dtype_of(cfg.param_dtype)
    pattern, n_groups, tail = group_layout(cfg)
    for kind in pattern:
        _require_ported(kind)
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
    return params


def group_params(params, g: int) -> Params:
    """Group ``g``'s slice of the stacked group params (views, no copy)."""
    return pytree.tree_map(lambda p: p[g], params["groups"])


def _embed(params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    dt = dtype_of(cfg.dtype)
    h = params["embed"]["table"][tokens.long()].to(dt)
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=h.device)
    return h


def _readout(params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """Float32 logits: low-precision operands multiplied exactly and summed
    in float32 (never rounded to the activation type)."""
    h = rmsnorm(params["ln_f"], h)
    if cfg.tie_embeddings:
        w = params["embed"]["table"].to(h.dtype).T
    else:
        w = params["head"]["kernel"].to(h.dtype)
    return torch.matmul(h.float(), w.float())


def lm_forward(params, cfg: ArchConfig, tokens: torch.Tensor):
    """tokens: (B, S) int. Returns (logits float32 (B, S, V), aux dict);
    the aux losses are zero for the ported block kinds."""
    _require_plain_lm(cfg)
    pattern, n_groups, tail = group_layout(cfg)
    h = _embed(params, cfg, tokens)
    for g in range(n_groups):
        gp = group_params(params, g)
        for i, kind in enumerate(pattern):
            h = block_apply(gp[f"b{i}"], cfg, kind, h)
    for i in range(tail):
        h = block_apply(params["tail"][f"t{i}"], cfg, pattern[i], h)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    aux = {"moe_aux": zero, "moe_z": zero, "moe_dropped": zero}
    return _readout(params, cfg, h), aux
