"""RWKV-6 'Finch' 1.6B [arXiv:2404.05892; unverified].

24L, d_model 2048, attention-free (32 WKV heads of dim 64), channel-mix
d_ff 7168, vocab 65536. Sub-quadratic: runs the long_500k cell.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6_1p6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,        # WKV heads (d_head 64)
    n_kv=32,
    d_head=64,
    d_ff=7168,
    vocab=65536,
    act="relu2",
    gated_ffn=False,
    pos="none",
    rwkv_heads=32,
    lora_rank=32,
    source="arXiv:2404.05892",
)
