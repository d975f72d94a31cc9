"""OLMoE-1B-7B [arXiv:2409.02060; hf:allenai/OLMoE-1B-7B].

16L, d_model 2048, 16 heads (kv=16, i.e. MHA), 64 experts top-8 with
per-expert d_ff 1024, qk-norm, every layer MoE.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="olmoe_1b_7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_head=128,
    d_ff=1024,
    vocab=50304,
    act="silu",
    gated_ffn=True,
    qk_norm=True,
    rope_theta=1e4,
    n_experts=64,
    top_k=8,
    moe_every=1,
    d_ff_expert=1024,
    capacity_factor=1.25,
    source="arXiv:2409.02060",
)
