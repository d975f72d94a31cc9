"""Whisper-base [arXiv:2212.04356; unverified].

Encoder-decoder, 6L each, d_model 512, 8 heads (MHA), d_ff 2048 (GELU),
vocab 51865, learned positions. Conv/mel frontend is a STUB: input_specs()
provides precomputed frame embeddings (B, T, d_model).
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="whisper_base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv=8,
    d_head=64,
    d_ff=2048,
    vocab=51865,
    act="gelu",
    gated_ffn=False,
    pos="learned",
    enc_layers=6,
    dec_layers=6,
    max_target_len=512,
    frontend="frames",
    source="arXiv:2212.04356",
)
