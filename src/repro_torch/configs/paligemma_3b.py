"""PaliGemma-3B [arXiv:2407.07726; hf:google/paligemma-3b].

Gemma-2B LM decoder backbone: 18L, d_model 2048, 8 heads (MQA kv=1,
d_head 256), GeGLU d_ff 16384, vocab 257216, embeddings scaled by sqrt(d)
and tied. SigLIP vision frontend is a STUB: input_specs() provides
precomputed patch embeddings (B, 256, d_model).
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="paligemma_3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv=1,
    d_head=256,
    d_ff=16384,
    vocab=257216,
    act="gelu",
    gated_ffn=True,
    rope_theta=1e4,
    tie_embeddings=True,
    embed_scale=True,
    frontend="patches",
    n_frontend_tokens=256,
    source="arXiv:2407.07726",
)
