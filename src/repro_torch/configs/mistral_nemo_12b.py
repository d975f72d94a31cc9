"""Mistral-Nemo 12B [hf:mistralai/Mistral-Nemo-Base-2407].

40L, d_model 5120, 32 heads (GQA kv=8, d_head 128), d_ff 14336,
128k context (rope theta 1e6), vocab 131072 (Tekken).
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="mistral_nemo_12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv=8,
    d_head=128,
    d_ff=14336,
    vocab=131072,
    act="silu",
    gated_ffn=True,
    rope_theta=1e6,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)
