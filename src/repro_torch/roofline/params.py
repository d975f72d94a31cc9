"""Analytic parameter counts per architecture config (no allocation) — the
port's copy of ``repro/roofline/params.py``, held equal to it by
tests/test_torch_roofline.py.

Mirrors models/lm.py::block_init exactly; used to (a) sanity-check configs
against published sizes and (b) compute MODEL_FLOPS = 6 N D (dense) or
6 N_active D (MoE) for the roofline's useful-compute ratio.
"""
from __future__ import annotations

from repro_torch.configs import ArchConfig
from repro_torch.models.lm import block_pattern


def _attn_params(cfg: ArchConfig) -> int:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
    n = d * H * hd + 2 * d * KV * hd + H * hd * d
    if cfg.qk_norm:
        n += 2 * hd
    return n


def _ffn_params(cfg: ArchConfig, d_ff: int) -> int:
    mats = 3 if cfg.gated_ffn else 2
    return mats * cfg.d_model * d_ff


def _block_params(cfg: ArchConfig, kind: str) -> int:
    d = cfg.d_model
    norms = 2 * d
    if kind in ("dense", "attn"):
        return norms + _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff)
    if kind == "moe":
        d_ff_e = cfg.d_ff_expert or cfg.d_ff
        mats = 3 if cfg.gated_ffn else 2
        n = norms + _attn_params(cfg) + d * cfg.n_experts
        n += cfg.n_experts * mats * d * d_ff_e
        if cfg.shared_expert:
            n += _ffn_params(cfg, cfg.d_ff)
        return n
    if kind == "rwkv":
        r = cfg.lora_rank
        n = norms + 5 * d * d                     # wr wk wv wg wo
        n += d + 5 * d                            # mu_x, mu
        n += d * 5 * r + 5 * r * d                # shift lora
        n += d + d * r + r * d                    # w0 + decay lora
        n += d                                    # u
        n += 2 * d                                # group norm
        n += d * cfg.d_ff + cfg.d_ff * d + d * d + 2 * d  # channel mix
        return n
    if kind == "rec":
        W = cfg.lru_width
        n = norms + 2 * d * W + W * d             # in_rec, in_gate, out
        n += 4 * W + W                            # conv w+b
        n += 2 * W * W + 3 * W                    # rglru wa, wx, biases, lam
        n += _ffn_params(cfg, cfg.d_ff)
        return n
    raise ValueError(kind)


def _block_active_params(cfg: ArchConfig, kind: str) -> int:
    """Params touched per token (MoE: top_k experts instead of all)."""
    if kind != "moe":
        return _block_params(cfg, kind)
    d = cfg.d_model
    d_ff_e = cfg.d_ff_expert or cfg.d_ff
    mats = 3 if cfg.gated_ffn else 2
    n = 2 * d + _attn_params(cfg) + d * cfg.n_experts
    n += cfg.top_k * mats * d * d_ff_e
    if cfg.shared_expert:
        n += _ffn_params(cfg, cfg.d_ff)
    return n


def _layer_kinds(cfg: ArchConfig):
    pattern = block_pattern(cfg)
    for i in range(cfg.n_layers):
        yield pattern[i % len(pattern)]


def analytic_param_count(cfg: ArchConfig, include_stub_pos: bool = False) -> int:
    if cfg.is_encdec:
        # whisper: enc blocks (no cross), dec blocks (self + cross)
        d = cfg.d_model
        enc = cfg.enc_layers * (4 * d + _attn_params(cfg)
                                + _ffn_params(cfg, cfg.d_ff))
        dec = cfg.dec_layers * (6 * d + 2 * _attn_params(cfg)
                                + _ffn_params(cfg, cfg.d_ff))
        n = enc + dec + cfg.vocab * d + 4 * d
        # canonical whisper position tables (1500 enc + 448 dec)
        n += (1500 + 448) * d
        if include_stub_pos:
            from repro_torch.models.encdec import MAX_FRAMES
            n += (MAX_FRAMES - 1500) * d + (cfg.max_target_len * 64 - 448) * d
        return n
    d = cfg.d_model
    n = cfg.vocab * d                      # embedding
    if not cfg.tie_embeddings:
        n += d * cfg.vocab                 # head
    n += d                                 # final norm
    for kind in _layer_kinds(cfg):
        n += _block_params(cfg, kind)
    if cfg.frontend == "patches":
        n += d * d
    return n


def analytic_active_param_count(cfg: ArchConfig) -> int:
    if cfg.is_encdec:
        return analytic_param_count(cfg)
    d = cfg.d_model
    n = cfg.vocab * d + (0 if cfg.tie_embeddings else d * cfg.vocab) + d
    for kind in _layer_kinds(cfg):
        n += _block_active_params(cfg, kind)
    if cfg.frontend == "patches":
        n += d * d
    return n
