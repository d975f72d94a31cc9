"""Analytic roofline cost model per (arch x shape x mesh), priced on a chip
record — the port's copy of ``repro/roofline/costmodel.py``.

The counts are the reference's, matmul by matmul, with the flash
attention path (the port's CUDA kernel, as the reference's Pallas one:
scores never touch HBM). One change: the three chip constants are a
frozen ``Chip`` record, and ``cell_cost(..., chip=)`` takes it. The
default is the H100 (``H100``); ``TPU_V5E`` carries the reference's
constants so that tests can hold this arithmetic equal to the
reference's, and prices nothing of the port.

Conventions:
  * FLOPs are total across devices per step (1 MAC = 2 FLOPs);
  * HBM bytes and collective bytes are PER DEVICE per step;
  * collective bytes follow ring costs: all-reduce ~ 2x payload,
    all-gather / reduce-scatter / all-to-all ~ 1x payload;
  * one link rate prices every collective, as in the reference: on the
    H100 record that is NVLink 4 inside one 8-GPU node, so a mesh of
    more than 8 devices (``SINGLE_POD``, ``MULTI_POD``) is a what-if at
    that rate, not a model of an inter-node network.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.configs import ArchConfig, ShapeSpec
from repro_torch.models.lm import block_pattern
from repro_torch.roofline.params import (
    analytic_active_param_count, analytic_param_count,
)

BF16 = 2
F32 = 4


@dataclasses.dataclass(frozen=True)
class Chip:
    """One accelerator's published rates: ``peak_flops`` dense bf16
    FLOP/s, ``hbm_bw`` device-memory bytes/s, ``link_bw`` interconnect
    bytes/s per direction per device (``link`` names it). ``name`` is
    the device's name as nvidia-smi reports it."""
    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float
    link: str

    def describe(self) -> str:
        return (f"{self.name}: {self.peak_flops / 1e12:g} TFLOP/s bf16, "
                f"{self.hbm_bw / 1e12:g} TB/s HBM, {self.link_bw / 1e9:g} "
                f"GB/s {self.link} a direction")


# NVIDIA H100 SXM5 80 GB, as nvidia-smi and torch.cuda.get_device_name
# name it. Published figures for the part at its 700 W power limit
# (NVIDIA H100 Tensor Core GPU datasheet):
# 989 TFLOP/s dense BF16 tensor-core peak (1,979 with sparsity), 3.35 TB/s
# HBM3, NVLink 4 at 900 GB/s per GPU bidirectional = 450 GB/s a direction.
H100 = Chip(name="NVIDIA H100 80GB HBM3", peak_flops=989e12,
            hbm_bw=3.35e12, link_bw=450e9, link="NVLink 4")

# The reference's TPU v5e constants (src/repro/roofline/costmodel.py):
# kept only so tests can hold this arithmetic equal to the reference's.
TPU_V5E = Chip(name="TPU v5e", peak_flops=197e12, hbm_bw=819e9,
               link_bw=50e9, link="ICI")


@dataclasses.dataclass
class Mesh2D:
    pod: int
    data: int
    model: int

    @property
    def devices(self) -> int:
        return self.pod * self.data * self.model

    @property
    def batch_shards(self) -> int:
        return self.pod * self.data


SINGLE_POD = Mesh2D(1, 16, 16)
MULTI_POD = Mesh2D(2, 16, 16)


def _causal_pairs(S: int, window: Optional[int]) -> float:
    """Number of (q, k) attended pairs per sequence."""
    if window is None or window >= S:
        return S * (S + 1) / 2
    w = window
    return w * (w + 1) / 2 + (S - w) * w


def _attn_flops(cfg: ArchConfig, B: int, S: int, causal: bool,
                window: Optional[int], kv_len: Optional[int] = None) -> float:
    H, KV, hd, d = cfg.n_heads, cfg.n_kv, cfg.d_head, cfg.d_model
    proj = 2 * B * S * d * (H * hd + 2 * KV * hd) + 2 * B * S * H * hd * d
    if kv_len is not None:        # decode: attend S=1 query over kv_len
        pairs = B * kv_len if window is None else B * min(window, kv_len)
        core = 2 * 2 * H * hd * pairs
        return proj + core
    pairs = B * (_causal_pairs(S, window) if causal else S * S)
    core = 2 * 2 * H * hd * pairs          # scores + AV
    return proj + core


def _ffn_flops(cfg: ArchConfig, tokens: float, d_ff: int) -> float:
    mats = 3 if cfg.gated_ffn else 2
    return 2 * tokens * cfg.d_model * d_ff * mats


def _moe_flops(cfg: ArchConfig, tokens: float) -> float:
    d_ff = cfg.d_ff_expert or cfg.d_ff
    mats = 3 if cfg.gated_ffn else 2
    E, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    capacity = max(1, int(-(-k * tokens * cf // E)))
    expert = 2 * E * capacity * cfg.d_model * d_ff * mats
    router = 2 * tokens * cfg.d_model * E
    out = expert + router
    if cfg.shared_expert:
        out += _ffn_flops(cfg, tokens, cfg.d_ff)
    return out


def _rwkv_flops(cfg: ArchConfig, tokens: float) -> float:
    d, r = cfg.d_model, cfg.lora_rank
    D = d // cfg.rwkv_heads
    proj = 5 * 2 * tokens * d * d                     # wr wk wv wg wo
    loras = 2 * tokens * d * 5 * r + 5 * 2 * tokens * r * d \
        + 2 * tokens * d * r + 2 * tokens * r * d
    wkv = 8 * tokens * d * D                          # state update + readout
    cmix = 2 * 2 * tokens * d * cfg.d_ff + 2 * tokens * d * d
    return proj + loras + wkv + cmix


def _rec_flops(cfg: ArchConfig, tokens: float) -> float:
    d, W = cfg.d_model, cfg.lru_width
    branch = 3 * 2 * tokens * d * W + 2 * 4 * tokens * W
    gates = 2 * 2 * tokens * W * W + 8 * tokens * W
    return branch + gates + _ffn_flops(cfg, tokens, cfg.d_ff)


def _layer_flops(cfg: ArchConfig, kind: str, B: int, S: int,
                 decode_kv: Optional[int]) -> float:
    tokens = B * S
    if kind in ("dense", "attn"):
        window = cfg.local_window if (kind == "attn"
                                      and cfg.pattern_attn_every) else cfg.window
        return _attn_flops(cfg, B, S, True, window, decode_kv) \
            + _ffn_flops(cfg, tokens, cfg.d_ff)
    if kind == "moe":
        return _attn_flops(cfg, B, S, True, cfg.window, decode_kv) \
            + _moe_flops(cfg, tokens)
    if kind == "rwkv":
        return _rwkv_flops(cfg, tokens)
    if kind == "rec":
        return _rec_flops(cfg, tokens)
    raise ValueError(kind)


def forward_flops(cfg: ArchConfig, B: int, S: int,
                  decode_kv: Optional[int] = None) -> float:
    """Forward FLOPs for B sequences of S tokens (decode: S=1, ctx len
    decode_kv)."""
    tokens = B * S
    if cfg.is_encdec:
        # stub frontend supplies embeddings; encoder S_enc = S
        enc = cfg.enc_layers * (
            _attn_flops(cfg, B, S, False, None)
            + _ffn_flops(cfg, tokens, cfg.d_ff))
        L = 1 if decode_kv is not None else cfg.max_target_len
        dec_self = _attn_flops(cfg, B, L, True, None,
                               cfg.max_target_len if decode_kv else None)
        H, hd, d = cfg.n_heads, cfg.d_head, cfg.d_model
        cross_proj = 2 * B * L * d * 2 * H * hd + \
            2 * B * L * d * 2 * H * hd  # q,o + (k,v over enc: amortized)
        cross_core = 2 * 2 * B * L * H * hd * S
        dec = cfg.dec_layers * (dec_self + cross_proj + cross_core
                                + _ffn_flops(cfg, B * L, cfg.d_ff))
        readout = 2 * B * L * d * cfg.vocab
        return enc + dec + readout
    pattern = block_pattern(cfg)
    # VLM: patch tokens are prepended to the text sequence
    S_eff = S + (cfg.n_frontend_tokens
                 if cfg.frontend == "patches" and decode_kv is None else 0)
    tokens_eff = B * S_eff
    total = 0.0
    for i in range(cfg.n_layers):
        total += _layer_flops(cfg, pattern[i % len(pattern)], B, S_eff,
                              decode_kv)
    if cfg.frontend == "patches" and decode_kv is None:
        total += 2 * B * cfg.n_frontend_tokens * cfg.d_model * cfg.d_model
    total += 2 * tokens_eff * cfg.d_model * cfg.vocab  # readout
    return total


def train_step_flops(cfg: ArchConfig, B: int, S: int, remat: str) -> float:
    fwd = forward_flops(cfg, B, S)
    passes = 3.0 + (1.0 if remat == "full" else 0.0)
    n = analytic_param_count(cfg)
    opt = 16.0 * n                       # adam moments + clip + wd
    return fwd * passes + opt


def decode_step_flops(cfg: ArchConfig, B: int, ctx: int) -> float:
    return forward_flops(cfg, B, 1, decode_kv=ctx)


# ------------------------------------------------------------ HBM bytes ----

def _weight_bytes(cfg: ArchConfig) -> float:
    return analytic_param_count(cfg) * BF16


def _active_weight_bytes(cfg: ArchConfig) -> float:
    return analytic_active_param_count(cfg) * BF16


def _flash_kv_traffic(cfg: ArchConfig, B: int, S: int, bq: int = 128) -> float:
    """Flash kernel: K/V panels re-read once per q block (see kernel doc)."""
    if cfg.rwkv_heads:
        return 0.0
    reads = B * (S / bq) * S * cfg.n_kv * cfg.d_head * 2 * BF16
    n_attn_layers = sum(
        1 for i in range(cfg.n_layers)
        if block_pattern(cfg)[i % len(block_pattern(cfg))] in
        ("dense", "attn", "moe"))
    return reads * n_attn_layers


def train_hbm_bytes(cfg: ArchConfig, B: int, S: int, mesh: Mesh2D,
                    remat: str, microbatches: int,
                    moment_bytes: int = F32) -> float:
    """Per-device HBM traffic per optimizer step."""
    tokens_dev = B * S / mesh.batch_shards
    d = cfg.d_model
    w_shard = _weight_bytes(cfg) / mesh.model
    passes = 4.0 if remat == "full" else 3.0
    weights = passes * w_shard * microbatches  # re-streamed per microbatch
    # activations: ~12 residual-stream-sized tensors per layer per pass
    act = 12 * cfg.n_layers * tokens_dev * d * BF16 * passes
    attn = _flash_kv_traffic(cfg, B / mesh.batch_shards, S) * passes
    n = analytic_param_count(cfg) / mesh.devices
    opt = n * (2 * moment_bytes * 2 + 3 * BF16 + 2 * F32)
    logits = 3 * tokens_dev * cfg.vocab / mesh.model * F32
    return weights + act + attn + opt + logits


def prefill_hbm_bytes(cfg: ArchConfig, B: int, S: int, mesh: Mesh2D) -> float:
    tokens_dev = B * S / mesh.batch_shards
    w_shard = _weight_bytes(cfg) / mesh.model
    act = 12 * cfg.n_layers * tokens_dev * cfg.d_model * BF16
    attn = _flash_kv_traffic(cfg, B / mesh.batch_shards, S)
    logits = tokens_dev * cfg.vocab / mesh.model * F32
    return w_shard + act + attn + logits


def decode_hbm_bytes(cfg: ArchConfig, B: int, ctx: int, mesh: Mesh2D,
                     kv_int8: bool = False, weights_int8: bool = False,
                     depth_fraction: float = 1.0) -> float:
    """The decode roofline: active weights + KV cache read per token.

    kv_int8/weights_int8: quantized serving; depth_fraction: hypersolved
    continuous-depth decode at K = depth_fraction * n_groups steps (the
    paper's technique — weights AND caches of skipped groups never load).
    """
    B_dev = max(B / mesh.batch_shards, 1)
    w = _active_weight_bytes(cfg) / mesh.model * depth_fraction
    if weights_int8:
        w *= 0.5
    pattern = block_pattern(cfg)
    kv_b = BF16 * (0.5 if kv_int8 else 1.0)  # int8 + 1/hd scale overhead
    kv = 0.0
    for i in range(cfg.n_layers):
        kind = pattern[i % len(pattern)]
        if kind in ("dense", "moe"):
            span = min(ctx, cfg.window) if cfg.window else ctx
            # KV is always model-sharded (head or head-dim axis —
            # launch/steps.py::cache_pspec), batch over data when divisible
            kv += B_dev * span * cfg.n_kv * cfg.d_head * 2 * kv_b \
                / mesh.model
        elif kind == "attn":
            kv += B_dev * min(ctx, cfg.local_window) * cfg.n_kv \
                * cfg.d_head * 2 * kv_b / mesh.model
        elif kind == "rwkv":
            D = cfg.d_model // cfg.rwkv_heads
            kv += B_dev * cfg.d_model * D * F32 * 2 / mesh.model
        elif kind == "rec":
            kv += B_dev * cfg.lru_width * F32 * 2 / mesh.model
    kv *= depth_fraction
    act = 40 * cfg.n_layers * depth_fraction * B_dev * cfg.d_model * BF16
    if cfg.is_encdec:
        kv += B_dev * ctx * cfg.n_kv * cfg.d_head * 2 * kv_b \
            * cfg.dec_layers / mesh.model
    return w + kv + act


# ----------------------------------------------------- collective bytes ----

def _expert_weight_bytes(cfg: ArchConfig) -> float:
    if not cfg.n_experts:
        return 0.0
    d_ff = cfg.d_ff_expert or cfg.d_ff
    mats = 3 if cfg.gated_ffn else 2
    moe_layers = sum(1 for i in range(cfg.n_layers)
                     if block_pattern(cfg)[i % len(block_pattern(cfg))]
                     == "moe")
    return moe_layers * cfg.n_experts * mats * cfg.d_model * d_ff * BF16


def train_collective_bytes(cfg: ArchConfig, B: int, S: int, mesh: Mesh2D,
                           microbatches: int, seq_shard: bool,
                           fsdp: bool, int8_dispatch: bool = False,
                           ep_over_data: bool = False) -> float:
    """Per-device interconnect bytes per optimizer step."""
    tokens_dev = B * S / mesh.batch_shards
    d = cfg.d_model
    act = tokens_dev * d * BF16
    n_layers = cfg.n_layers
    # TP activation collectives: 2 fwd + 2 bwd per layer; all-reduce costs
    # 2x payload, SP's AG+RS pairs cost ~1x (the SP win).
    tp = n_layers * 4 * act * (1.0 if seq_shard else 2.0)
    # MoE all-to-all: dispatch + combine, fwd + bwd
    moe_layers = sum(1 for i in range(n_layers)
                     if block_pattern(cfg)[i % len(block_pattern(cfg))]
                     == "moe")
    a2a = moe_layers * 4 * act * (cfg.top_k if cfg.top_k else 1)
    if int8_dispatch:
        a2a *= 0.5  # int8 payload + f32 scales (1/d overhead, negligible)
    # gradients: reduce-scatter per microbatch over data + update all-gather
    w_total = _weight_bytes(cfg)
    w_ep = _expert_weight_bytes(cfg) if ep_over_data else 0.0
    g_shard = (w_total - w_ep) / mesh.model + w_ep / mesh.data
    grads = microbatches * g_shard + g_shard
    # FSDP: params all-gathered per microbatch (fwd + bwd); EP-over-data
    # expert weights are DP-local — no gather for them (hillclimb B)
    if fsdp:
        grads += microbatches * 2 * (w_total - w_ep) / mesh.model
    # pod axis: gradient all-reduce over DCN
    if mesh.pod > 1:
        grads += 2 * w_total / (mesh.model * mesh.data)
    # embedding gather + logits reductions (small)
    emb = 2 * tokens_dev * d * BF16
    return tp + a2a + grads + emb


def prefill_collective_bytes(cfg: ArchConfig, B: int, S: int, mesh: Mesh2D,
                             seq_shard: bool = False) -> float:
    tokens_dev = B * S / mesh.batch_shards
    act = tokens_dev * cfg.d_model * BF16
    tp = cfg.n_layers * 2 * act * (1.0 if seq_shard else 2.0)
    moe_layers = sum(1 for i in range(cfg.n_layers)
                     if block_pattern(cfg)[i % len(block_pattern(cfg))]
                     == "moe")
    a2a = moe_layers * 2 * act * (cfg.top_k if cfg.top_k else 1)
    return tp + a2a + 2 * tokens_dev * cfg.d_model * BF16


def decode_collective_bytes(cfg: ArchConfig, B: int, mesh: Mesh2D) -> float:
    B_dev = max(B / mesh.batch_shards, 1)
    act = B_dev * cfg.d_model * BF16
    tp = cfg.n_layers * 4 * act          # 2 AR x 2 payload
    moe_layers = sum(1 for i in range(cfg.n_layers)
                     if block_pattern(cfg)[i % len(block_pattern(cfg))]
                     == "moe")
    a2a = moe_layers * 2 * act * (cfg.top_k if cfg.top_k else 1)
    logits = B_dev * cfg.vocab / mesh.model * F32
    return tp + a2a + logits


# -------------------------------------------------------------- report ----

@dataclasses.dataclass
class RooflineTerms:
    flops_total: float
    hbm_bytes_dev: float
    coll_bytes_dev: float
    model_flops: float
    t_compute: float
    t_memory: float
    t_collective: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / max(self.flops_total, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the dominant
        non-compute term were fully overlapped: t_compute / max(all)."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        return self.t_compute / t if t > 0 else 0.0


def predicted(t: RooflineTerms, mesh: Mesh2D) -> Tuple[float, str]:
    """The seconds a cell is predicted to take on ``mesh``, and the term
    that sets them. At (1, 1, 1) ``cell_cost`` still prices the
    tensor-parallel all-reduces, the MoE all-to-all and the gradient
    reduce-scatter, as the reference does; one device sends none of
    them, so there the prediction is the larger of compute and memory
    and ``t_collective`` is only reported beside it."""
    terms = {"compute": t.t_compute, "memory": t.t_memory}
    if mesh.devices > 1:
        terms["collective"] = t.t_collective
    dominant = max(terms, key=terms.get)
    return terms[dominant], dominant


def cell_cost(cfg: ArchConfig, shape: ShapeSpec, mesh: Mesh2D,
              remat: str = "full", microbatches: int = 4,
              seq_shard: bool = False, fsdp: bool = False,
              moment_bytes: int = F32, int8_dispatch: bool = False,
              ep_over_data: bool = False, kv_int8: bool = False,
              weights_int8: bool = False,
              depth_fraction: float = 1.0,
              chip: Chip = H100) -> RooflineTerms:
    B, S = shape.global_batch, shape.seq_len
    D_tokens = B * S
    n_active = analytic_active_param_count(cfg)
    if shape.kind == "train":
        flops = train_step_flops(cfg, B, S, remat)
        hbm = train_hbm_bytes(cfg, B, S, mesh, remat, microbatches,
                              moment_bytes)
        coll = train_collective_bytes(cfg, B, S, mesh, microbatches,
                                      seq_shard, fsdp,
                                      int8_dispatch=int8_dispatch,
                                      ep_over_data=ep_over_data)
        model_flops = 6.0 * n_active * D_tokens
    elif shape.kind == "prefill":
        flops = forward_flops(cfg, B, S)
        hbm = prefill_hbm_bytes(cfg, B, S, mesh)
        coll = prefill_collective_bytes(cfg, B, S, mesh, seq_shard)
        model_flops = 2.0 * n_active * D_tokens
    else:
        flops = decode_step_flops(cfg, B, S) * depth_fraction
        hbm = decode_hbm_bytes(cfg, B, S, mesh, kv_int8=kv_int8,
                               weights_int8=weights_int8,
                               depth_fraction=depth_fraction)
        coll = decode_collective_bytes(cfg, B, mesh) * depth_fraction
        model_flops = 2.0 * n_active * B
    t_c = flops / (mesh.devices * chip.peak_flops)
    t_m = hbm / chip.hbm_bw
    t_l = coll / chip.link_bw
    return RooflineTerms(flops_total=flops, hbm_bytes_dev=hbm,
                         coll_bytes_dev=coll, model_flops=model_flops,
                         t_compute=t_c, t_memory=t_m, t_collective=t_l)
