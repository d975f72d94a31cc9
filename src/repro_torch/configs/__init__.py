"""Architecture + shape configuration registry (the port's copy).

Pure data, copied from the JAX package's ``repro/configs`` so the port
imports nothing of it; ``tests/test_torch_imports.py`` and the parity
tests hold the two copies to the same values. Every architecture has a
``src/repro_torch/configs/<id>.py`` exporting ``CONFIG`` with the exact
public dimensions; ``get(name)`` loads it. ``SHAPES`` carries the input-
shape set (same for all LM archs).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int
    # attention / ffn details
    act: str = "silu"
    gated_ffn: bool = True
    qk_norm: bool = False
    rope_theta: float = 1e4
    window: Optional[int] = None
    tie_embeddings: bool = False
    embed_scale: bool = False          # gemma: embed * sqrt(d)
    pos: str = "rope"                  # rope | learned | none
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1                 # MoE block every N layers (llama4: 2)
    shared_expert: bool = False
    d_ff_expert: Optional[int] = None
    capacity_factor: float = 1.25
    # RWKV
    rwkv_heads: int = 0
    lora_rank: int = 32
    # Griffin / recurrentgemma
    lru_width: int = 0
    pattern_attn_every: int = 0        # 3 => [rec, rec, attn] repeating
    local_window: int = 2048
    # encoder-decoder (whisper)
    enc_layers: int = 0
    dec_layers: int = 0
    max_target_len: int = 512
    # modality frontend stub
    frontend: Optional[str] = None     # patches | frames
    n_frontend_tokens: int = 0
    # dtypes
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # notes for DESIGN.md provenance
    source: str = ""

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports O(S) or O(window) decode at 500k ctx."""
        return self.family in ("ssm", "hybrid")

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def reduced(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        pat = self.pattern_attn_every
        n_layers = (2 * pat if pat else (4 if self.moe_every > 1 else 2))
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv=min(self.n_kv, 2) if self.n_kv < self.n_heads else 4,
            d_head=16,
            d_ff=128,
            d_ff_expert=32 if self.n_experts else None,
            vocab=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            rwkv_heads=4 if self.rwkv_heads else 0,
            lora_rank=4,
            lru_width=64 if self.lru_width else 0,
            local_window=8 if self.pattern_attn_every else 2048,
            window=self.window and 8,
            enc_layers=2 if self.enc_layers else 0,
            dec_layers=2 if self.dec_layers else 0,
            max_target_len=16,
            n_frontend_tokens=8 if self.frontend else 0,
            dtype="float32",
            param_dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

ARCH_IDS = (
    "llama4_maverick_400b_a17b",
    "olmoe_1b_7b",
    "nemotron_4_340b",
    "qwen3_4b",
    "qwen3_8b",
    "mistral_nemo_12b",
    "paligemma_3b",
    "rwkv6_1p6b",
    "recurrentgemma_2b",
    "whisper_base",
)

_ALIASES = {
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "nemotron-4-340b": "nemotron_4_340b",
    "qwen3-4b": "qwen3_4b",
    "qwen3-8b": "qwen3_8b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "paligemma-3b": "paligemma_3b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "whisper-base": "whisper_base",
}


def get(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name.replace("-", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def cell_is_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether an (arch x shape) dry-run cell runs, with skip reason."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full softmax attention is O(S^2); 512k-token KV "
                       "exceeds HBM — documented skip (DESIGN.md §5)")
    if shape.kind == "decode" and cfg.family == "audio" \
            and shape.name == "long_500k":
        return False, "whisper encoder is full-attention"
    return True, ""
