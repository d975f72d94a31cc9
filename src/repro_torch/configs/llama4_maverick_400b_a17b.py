"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L, d_model 5120, 40 heads (GQA kv=8), dense d_ff 8192 (x2 interleave),
MoE 128 experts top-1 + shared expert on alternating layers (interleaved
dense/MoE gives ~400B total / ~17B active — see DESIGN.md provenance note).
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="llama4_maverick_400b_a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    d_head=128,
    d_ff=8192,
    vocab=202048,
    act="silu",
    gated_ffn=True,
    rope_theta=5e5,
    n_experts=128,
    top_k=1,
    moe_every=2,
    shared_expert=True,
    d_ff_expert=8192,
    capacity_factor=1.25,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (dims per assignment)",
)
