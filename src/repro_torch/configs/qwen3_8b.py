"""Qwen3-8B [hf:Qwen/Qwen3-8B].

36L, d_model 4096, 32 heads (GQA kv=8, d_head 128), d_ff 12288, qk-norm.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="qwen3_8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_head=128,
    d_ff=12288,
    vocab=151936,
    act="silu",
    gated_ffn=True,
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B",
)
