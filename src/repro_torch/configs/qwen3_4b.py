"""Qwen3-4B [hf:Qwen/Qwen3-4B].

36L, d_model 2560, 32 heads (GQA kv=8, d_head 128), d_ff 9728, qk-norm,
tied embeddings, vocab 151936.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="qwen3_4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv=8,
    d_head=128,
    d_ff=9728,
    vocab=151936,
    act="silu",
    gated_ffn=True,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-4B",
)
