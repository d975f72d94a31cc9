"""Whisper-style encoder-decoder backbone — the port of
``repro/models/encdec.py``.

The conv/mel frontend is a stub: inputs are precomputed frame embeddings
(B, T, d). Pre-LN LayerNorm blocks (as in Whisper), learned positional
embeddings, a bidirectional encoder, a causal decoder with
cross-attention, and the tied float32 readout. Both stacks keep the
reference's layout (every block leaf stacked on a leading layer axis,
``enc_blocks`` and ``dec_blocks``), so weights carry across leaf for
leaf, and are applied in a Python loop over views of the stack. Every
full-sequence attention (the encoder's, the decoder's causal
self-attention and its cross-attention over the encoder's frames) runs
through ``nn/attention.py::mha`` and so through the flash kernel on the
card; ``remat`` wraps each block as ``lm_forward``'s wraps a group.

Decode keeps the reference's caches: self-attention K/V stacked over
the decoder's layers, updated in place, and each layer's cross K/V
computed once from the encoder's states (``init_dec_cache``).
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import ArchConfig
from repro_torch.models.lm import (_rematerialised, _residual, dtype_of,
                                   gold_logits)
from repro_torch.nn.attention import (attention_init, mha, mha_decode,
                                     precompute_cross_kv)
from repro_torch.nn.ffn import ffn_apply, ffn_init
from repro_torch.nn.module import (embedding_init, embedding_logits,
                                   embedding_lookup, layernorm,
                                   layernorm_init, truncated_normal_init)

MAX_FRAMES = 1 << 16  # learned position table ceiling for stress shapes


def _enc_block_init(gen, cfg: ArchConfig, pd, lead, device):
    kw = dict(lead=lead, device=device)
    return {
        "ln1": layernorm_init(cfg.d_model, pd, **kw),
        "attn": attention_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv,
                               cfg.d_head, param_dtype=pd, **kw),
        "ln2": layernorm_init(cfg.d_model, pd, **kw),
        "ffn": ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.gated_ffn, pd, **kw),
    }


def _dec_block_init(gen, cfg: ArchConfig, pd, lead, device):
    kw = dict(lead=lead, device=device)
    return {
        "ln1": layernorm_init(cfg.d_model, pd, **kw),
        "self_attn": attention_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv,
                                    cfg.d_head, param_dtype=pd, **kw),
        "ln_x": layernorm_init(cfg.d_model, pd, **kw),
        "cross_attn": attention_init(gen, cfg.d_model, cfg.n_heads,
                                     cfg.n_kv, cfg.d_head, param_dtype=pd,
                                     **kw),
        "ln2": layernorm_init(cfg.d_model, pd, **kw),
        "ffn": ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.gated_ffn, pd, **kw),
    }


def init_encdec(gen: torch.Generator, cfg: ArchConfig, device=None):
    """Random weights drawn from ``gen`` on ``device``, with the
    reference's tree."""
    pd = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    return {
        "enc_blocks": _enc_block_init(gen, cfg, pd, (cfg.enc_layers,),
                                      device),
        "dec_blocks": _dec_block_init(gen, cfg, pd, (cfg.dec_layers,),
                                      device),
        "embed": embedding_init(gen, cfg.vocab, d, pd, device),
        "enc_pos": truncated_normal_init(gen, (MAX_FRAMES, d), 0.02, pd,
                                         device),
        "dec_pos": truncated_normal_init(gen, (cfg.max_target_len * 64, d),
                                         0.02, pd, device),
        "ln_enc": layernorm_init(d, pd, device=device),
        "ln_dec": layernorm_init(d, pd, device=device),
    }


def _attn_kw(cfg: ArchConfig):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_head=cfg.d_head,
                use_rope=False)


def _layer(blocks, i: int):
    """Layer ``i``'s slice of a stacked block tree (views, no copy)."""
    return pytree.tree_map(lambda p: p[i], blocks)


def encode(params, cfg: ArchConfig, frames: torch.Tensor,
           remat: str = "none") -> torch.Tensor:
    """frames: (B, T, d) stub embeddings -> encoder states (B, T, d)."""
    dt = dtype_of(cfg.dtype)
    h = _residual(frames.to(dt) + params["enc_pos"][:frames.shape[1]].to(dt))

    def body(h, i):
        bp = _layer(params["enc_blocks"], i)
        h = _residual(h + mha(bp["attn"], layernorm(bp["ln1"], h),
                              causal=False, **_attn_kw(cfg)))
        return _residual(h + ffn_apply(bp["ffn"], layernorm(bp["ln2"], h),
                                       act=cfg.act))

    body = _rematerialised(body, remat)
    for i in range(cfg.enc_layers):
        h = body(h, i)
    return layernorm(params["ln_enc"], h)


def decode_train(params, cfg: ArchConfig, enc: torch.Tensor,
                 tokens: torch.Tensor, remat: str = "none") -> torch.Tensor:
    """Teacher-forced decoder. tokens: (B, L). Returns float32 logits
    (B, L, V)."""
    dt = dtype_of(cfg.dtype)
    h = embedding_lookup(params["embed"], tokens, dt)
    h = _residual(h + params["dec_pos"][:tokens.shape[1]].to(dt))

    def body(h, i):
        bp = _layer(params["dec_blocks"], i)
        h = _residual(h + mha(bp["self_attn"], layernorm(bp["ln1"], h),
                              causal=True, **_attn_kw(cfg)))
        h = _residual(h + mha(bp["cross_attn"], layernorm(bp["ln_x"], h),
                              kv_x=enc, causal=False, **_attn_kw(cfg)))
        return _residual(h + ffn_apply(bp["ffn"], layernorm(bp["ln2"], h),
                                       act=cfg.act))

    body = _rematerialised(body, remat)
    for i in range(cfg.dec_layers):
        h = body(h, i)
    return embedding_logits(params["embed"], layernorm(params["ln_dec"], h))


def encdec_loss(params, cfg: ArchConfig, frames, tokens, targets,
                remat: str = "none"):
    """Mean next-token cross-entropy of the teacher-forced decoder over
    the encoded frames. Returns (loss, {"ce": loss})."""
    enc = encode(params, cfg, frames, remat)
    logits = decode_train(params, cfg, enc, tokens, remat).float()
    logz = torch.logsumexp(logits, dim=-1)
    ce = torch.mean(logz - gold_logits(logits, targets.long()))
    return ce, {"ce": ce}


def init_dec_cache(params, cfg: ArchConfig, enc: torch.Tensor, batch: int,
                   max_len: int):
    """Self-attention KV caches, zeroed and stacked over the decoder's
    layers ((L, B, max_len, KV, hd) each), and every layer's cross K/V
    from ``enc`` ((L, B, T, KV, hd) each)."""
    dt = dtype_of(cfg.dtype)
    shape = (cfg.dec_layers, batch, max_len, cfg.n_kv, cfg.d_head)
    self_kv = {"k": torch.zeros(shape, dtype=dt, device=enc.device),
               "v": torch.zeros(shape, dtype=dt, device=enc.device)}
    cross = [precompute_cross_kv(_layer(params["dec_blocks"], i)
                                 ["cross_attn"], enc, n_kv=cfg.n_kv,
                                 d_head=cfg.d_head)
             for i in range(cfg.dec_layers)]
    return {"self": self_kv,
            "cross": {k: torch.stack([c[k] for c in cross])
                      for k in ("k", "v")}}


def encdec_decode_step(params, cfg: ArchConfig, token: torch.Tensor, caches,
                       cur_index: int):
    """One decoder token. token: (B,); ``cur_index``: the Python int
    position. Writes the token's self K/V into ``caches`` in place and
    returns (logits (B, V) float32, caches)."""
    dt = dtype_of(cfg.dtype)
    h = embedding_lookup(params["embed"], token[:, None], dt)
    h = h + params["dec_pos"][cur_index:cur_index + 1].to(dt)[None]
    for i in range(cfg.dec_layers):
        bp = _layer(params["dec_blocks"], i)
        kv = {k: caches["self"][k][i] for k in ("k", "v")}
        cross = {k: caches["cross"][k][i] for k in ("k", "v")}
        a, _ = mha_decode(bp["self_attn"], layernorm(bp["ln1"], h), kv,
                          cur_index, **_attn_kw(cfg))
        h = h + a
        c, _ = mha_decode(bp["cross_attn"], layernorm(bp["ln_x"], h), {},
                          cur_index, cross_kv=cross, **_attn_kw(cfg))
        h = h + c
        h = h + ffn_apply(bp["ffn"], layernorm(bp["ln2"], h), act=cfg.act)
    logits = embedding_logits(params["embed"],
                              layernorm(params["ln_dec"], h))[:, 0]
    return logits, caches
