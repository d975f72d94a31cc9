"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427; hf:google/recurrentgemma-2b].

26L, d_model 2560, pattern (RG-LRU, RG-LRU, local-attn) — 1 attention per
2 recurrent blocks; MQA 10 heads kv=1 d_head 256, local window 2048,
GeGLU d_ff 7680, lru_width 2560, vocab 256000, embeddings scaled.
Sub-quadratic: runs the long_500k cell.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma_2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv=1,
    d_head=256,
    d_ff=7680,
    vocab=256000,
    act="gelu",
    gated_ffn=True,
    rope_theta=1e4,
    tie_embeddings=True,
    embed_scale=True,
    lru_width=2560,
    pattern_attn_every=3,
    local_window=2048,
    source="arXiv:2402.19427",
)
