"""Nemotron-4 340B [arXiv:2402.16819; unverified].

96L, d_model 18432, 96 heads (GQA kv=8), d_ff 73728 with squared-ReLU
(non-gated), vocab 256000.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="nemotron_4_340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv=8,
    d_head=192,
    d_ff=73728,
    vocab=256000,
    act="relu2",
    gated_ffn=False,
    rope_theta=1e4,
    source="arXiv:2402.16819",
)
