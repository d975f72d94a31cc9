"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Builds the four CUDA kernels of the serving paths (``hyper_step``,
``flash_attention``, ``rglru_scan``, ``rwkv6_scan``) from the sources in
the checkout, one nvcc process each, all started together; holds each
kernel against its plain PyTorch version at the serving shapes and at
the edges of its design (``hs_cases``, ``FLASH_CASES``, ``RGLRU_CASES``,
``RWKV6_CASES``) and times both cold-L2 (``time_ms``; flash attention
also beside ``scaled_dot_product_attention`` as a yardstick the port
never calls); serves full-width ``qwen3_4b`` (36
layers, d 2560), full-width ``recurrentgemma_2b`` (26 layers, d 2560)
and full-width ``rwkv6_1p6b`` (24 layers, d 2048), bf16, random weights
from a seeded generator, through the port's serving CLI (and, for
qwen3_4b, the engine with hyper_euler), every batch mixing K; counts
each kernel's launches against the block applications and solver steps
of those runs; and checks fused against unfused serving in float32.
Then the cached decode path of each model (``phase_decode``; qwen3_4b
through the CLI's default, the others through ``greedy_generate`` on the
params their serve phase returned): 8 prompts of 128 tokens, 32 greedy
tokens, the launches exactly one flash_attention per attention block and
one rglru_scan per recurrent block (the prefill) and one rwkv6_scan per
rwkv block and token, the prefill's logits ``torch.equal`` to the
readout of ``lm_forward``'s hidden states at the last position, the
bf16 decode logits within a limit of a teacher-forced forward and a
planted fault (lost cache writes) outside it, and prefill, decode and
readout times beside the weight-bytes bound per token; and the same
teacher-forced check in float32 at 4 layers (Griffin 6). And the
in-flight scheduler (``phase_inflight``) on each model's serve-phase
params and tolerance: 16 prompts of 128 tokens on a Poisson trace, slots
4, seg 2, once with the synchronous loop and once with the overlap loop
(qwen3_4b through the CLI's ``--inflight --arrival-trace poisson
--overlap``), the two equal uid for uid and bit for bit, K and nfe equal
to the drain engine's, logits near the drain's, hyper_step once per
segment step and each block kernel once per block application; it prints
wall times, segments, the host syncs per segment and the virtual p50/p99
latency.
Then, per model on the same params, the online refinery
(``phase_refinery``: the in-flight trace replayed with a 64-row
``ResidualLedger``, completions bit for bit the ledger-free run's, every
kernel launch accounted for capture cells included; a ``Refinery``
trains, shadow-scores and gates; its candidate hot-swapped after the
4th segment moves only later completions, in both loops, and a swap of the current
params moves none) and the K=0 flow tier (``phase_flow``: a rank-64 flow
head fitted by ``train_flowhead`` on that ledger, saved and loaded back
bit for bit; the drain and both in-flight loops with part of the traffic
at K=0, a threshold of 0 serving the serve phase's outputs bit for bit,
a planted flow fault escalating its uids); for qwen3_4b both through
the CLI too (``--refine`` with its candidate served back through
``--g-ckpt``, and ``--flow-ckpt``/``--flow-threshold``); and the fit's
convergence in float32 at 4 layers (Griffin 6).
Before the serving phases, the paper's image-classification pipeline
(``phase_image``: the reference's ``benchmarks/common.py`` protocol) for
the MNIST-family and CIFAR-family conv Neural ODEs in float32 at the
paper's widths: train through RK4, fit HyperEuler at K 10 by residual
fitting on dopri5 trajectories, take a dopri5 reference, and sweep the
solvers over K unfused and fused, with the losses falling, fused equal to
unfused, hyper_step launched exactly K times a fused solve and
HyperEuler beating Euler at K 10 on MNIST checked.
Every phase prints one JSON line and raises on failure. The line before
the last is the kernels' record; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when no CUDA device is available or the port's sources are missing.
"""
import collections
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
from torch.utils import _pytree as pytree

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core.tableaus import get as get_tableau  # noqa: E402
from repro_torch.kernels import LAUNCHES, _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.hyper_step import ops as hs_ops  # noqa: E402
from repro_torch.kernels.hyper_step.ref import fused_rk_update_ref  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as rg_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as rw_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import wkv6_scan_ref  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import (  # noqa: E402
    FixedGrid, FlowTrainConfig, HypersolverTrainConfig, make_fit_step,
    train_flowhead, train_hypersolver)
from repro_torch.data import synthetic_images  # noqa: E402
from repro_torch.distributed.fault import FaultInjector, _hash01  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.engine import (  # noqa: E402
    EngineConfig, MultiRateEngine, greedy_generate, lm_depth_model,
    load_flow_params, snap_to_buckets)
from repro_torch.launch.refinery import (  # noqa: E402
    Refinery, RefineryConfig, ResidualLedger)
from repro_torch.launch.scheduler import InflightScheduler  # noqa: E402
from repro_torch.launch.workload import (  # noqa: E402
    latency_stats, poisson_trace, replay_scheduler)
from repro_torch.models import cdepth, lm  # noqa: E402
from repro_torch.models.cdepth import (  # noqa: E402
    lm_flow_apply, lm_flow_init, lm_g_init)
from repro_torch.models import conv_node  # noqa: E402
from repro_torch.models.lm import init_lm  # noqa: E402
from repro_torch.nn.module import truncated_normal_init  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

B, S, D = 8, 128, 2560          # the serving phases' batch of prompts
GEN = 32                        # tokens each decode phase generates
# Teacher-forced decode limits, a share of the largest |logit|, each
# between the sound runs' largest reading and the planted fault's
# (``lost_cache_writes``) smallest, read by tools/decode_limits.py on the
# H100 (PERF.md section 6). bf16 readings differ by model, so each has
# its own: sound 7.8e-3 / 4.0e-4 / 4.3e-2, fault 0.18 / 7.9e-3 / 1.09.
BF16_DECODE_TOL = {"qwen3_4b": 3e-2, "recurrentgemma_2b": 2e-3,
                   "rwkv6_1p6b": 0.2}
# float32 at these depths (Griffin: two groups of rec, rec, attn): sound
# <= 4.0e-6, fault >= 3.6e-3
FP32_DECODE_TOL = 1e-4
FP32_DECODE_LAYERS = {"qwen3_4b": 4, "recurrentgemma_2b": 6,
                      "rwkv6_1p6b": 4}
BUCKETS = "2,4,8"
# The in-flight phases: 16 prompts of 128 tokens (the serve phase's 8 and
# 8 more from the same generator), slots 4, seg 2, a Poisson trace at the
# CLI's default 0.25 requests per cost unit, seed 0. A request's logits
# are held to the drain engine's for the same prompt within this share of
# the drain's largest |logit| (the decode limits above: bf16 rounding
# through the whole stack, here from GEMMs of another row count), or must
# agree with them by argmax at every position.
INFLIGHT_REQUESTS, SLOTS, SEG, ARRIVAL_RATE = 16, 4, 2, 0.25
INFLIGHT_TOL = BF16_DECODE_TOL
# The refinery and flow-tier phases (after each model's in-flight phase,
# on its serve-phase params): a 64-row ledger captured from the in-flight
# trace, 4 held-out shadow prompts, 50 flow-head iterations of batch 16
# at rank 64 (the CLI's --flow-rank default), the hot swap after the 4th
# segment, a
# flow fault on the uids whose hash falls below 0.5.
LEDGER_CAP, SHADOW_PROMPTS, SWAP_SEGMENTS = 64, 4, 4
FLOW_ITERS, FLOW_BATCH, FLOW_RANK, FLOW_NAN_FRAC = 50, 16, 64, 0.5
BUILD = os.path.join(ROOT, "build")
FP32_PEAK = 67e12               # H100 SXM float32 outside the tensor cores
BF16_PEAK = 989e12              # H100 SXM dense bf16/fp16 tensor cores


def emit(**row):
    print(json.dumps(row), flush=True)


def hmma_counts(libs):
    """Tensor-core (HMMA) instructions in each library's SASS, by
    cuobjdump beside nvcc; None where the toolkit has no cuobjdump.
    Raises unless flash attention's library has some (its 16-bit path
    runs on the tensor cores) and every other library has none."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    counts = {k: subprocess.run([tool, "-sass", str(v)], capture_output=True,
                                text=True, check=True).stdout.count("HMMA")
              for k, v in libs.items()}
    if counts["flash_attention"] == 0 or any(
            n for k, n in counts.items() if k != "flash_attention"):
        raise AssertionError(f"HMMA instructions per library {counts}: "
                             "expected some in flash_attention only")
    return counts


def memory_bandwidth(name: str) -> float:
    """Published device-memory rate of the card (bytes/s): H100 SXM only."""
    if name == "NVIDIA H100 80GB HBM3":
        return 3.35e12
    raise RuntimeError(f"no memory rate on record for {name!r}")


def ordered_bits(t: torch.Tensor) -> torch.Tensor:
    """16-bit float patterns as integers ordered like the values."""
    b = t.view(torch.int16).to(torch.int32)
    return torch.where(b < 0, -(b & 0x7FFF), b)


def time_ms(fn, flush: torch.Tensor, reps: int = 30,
            clean: bool = False) -> float:
    """Median device time of ``fn`` in ms, cold L2: the flush buffer is
    rewritten before each run, and a sleep kernel keeps the stream busy
    while the host enqueues, so the events bracket device work only.
    ``clean=True`` reads the buffer after the sleep instead, which leaves
    the L2 holding clean lines (no write-back for the timed run's misses)
    and device memory busy until the timed run starts."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if not clean:
            flush.zero_()
        torch.cuda._sleep(5_000_000)
        if clean:
            flush.view(torch.int64).sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


@dataclasses.dataclass(frozen=True)
class HsCase:
    """One hyper_step case: operand dtypes (state, then each live stage),
    g's dtype (None: no g), the tableau's live b and order, eps ("rows":
    the serving batch's per-sample 1/K, or a Python float) and the active
    row ("mixed": rows 6 of 8, "frozen": none, None: no mask)."""
    name: str
    shape: tuple
    dtypes: tuple
    g: object
    b: tuple
    order: int
    eps: object = "rows"
    active: object = "mixed"


def hs_cases():
    """The serving shape in bf16 and fp32 for euler + g, heun and the live
    stages of dopri5, then the kernel's edges: a bf16 state with a float32
    later stage (heun under per-sample eps, the reference's promotion),
    rows of N % 8 != 0, every row frozen, and one row under a scalar eps;
    and the image path's float32 euler + g step under a scalar eps (one
    row of 64 or 1,024 x 9,408 elements)."""
    bf, f32 = torch.bfloat16, torch.float32
    dopri = tuple(bj for bj in get_tableau("dopri5").b if bj != 0.0)
    cases = [HsCase(name, (B, S, D), (dt,) * (1 + len(b)), dt if g else None,
                    b, order)
             for dt in (bf, f32)
             for name, b, g, order in (("euler+g", (1.0,), True, 1),
                                       ("heun", (0.5, 0.5), False, 2),
                                       ("dopri5-live", dopri, False, 5))]
    return cases + [
        HsCase("heun-promoted", (B, S, D), (bf, bf, f32), None, (0.5, 0.5), 2),
        HsCase("ragged-n", (B, 129, 333), (bf, bf), bf, (1.0,), 1),
        HsCase("all-frozen", (B, S, D), (bf, bf), bf, (1.0,), 1,
               active="frozen"),
        HsCase("b1-scalar-eps", (B, S, D), (bf, bf), bf, (1.0,), 1, eps=0.25,
               active=None),
        # phase_image's fused hyper_euler step on MNIST states: its sweep's
        # 64 test images and its timed batch of 1,024
        HsCase("image-euler+g-64", (64, 12, 28, 28), (f32, f32), f32, (1.0,),
               1, eps=0.1, active=None),
        HsCase("image-euler+g", (1024, 12, 28, 28), (f32, f32), f32, (1.0,),
               1, eps=0.1, active=None),
    ]


def hs_inputs(case, gen, dev):
    """(z, stages, g, eps, active) of ``case``, drawn from ``gen``."""
    def draw(dt):
        return torch.randn(case.shape, generator=gen, device=dev).to(dt)
    z, stages = draw(case.dtypes[0]), [draw(d) for d in case.dtypes[1:]]
    g = draw(case.g) if case.g is not None else None
    Ks = torch.tensor([2, 4, 8, 8, 4, 2, 8, 4], dtype=torch.int32, device=dev)
    eps = (torch.tensor(1.0, device=dev) / Ks if case.eps == "rows"
           else case.eps)
    act = {"mixed": [1, 1, 1, 1, 1, 1, 0, 0], "frozen": [0] * B,
           None: None}[case.active]
    if act is not None:
        act = torch.tensor(act, dtype=torch.int32, device=dev)
    return z, stages, g, eps, act


def hs_check(case, out, ref, z, act) -> float:
    """Raises unless ``out`` is within 1e-6 abs + 1e-6 rel of the plain
    version in fp32, one ulp in 16 bits, with frozen rows equal to z bit
    for bit; returns the max abs error."""
    err = float((out.float() - ref.float()).abs().max())
    if z.dtype == torch.float32:
        ok = bool(((out - ref).abs() <= 1e-6 + 1e-6 * ref.abs()).all())
    else:
        ok = int((ordered_bits(out) - ordered_bits(ref)).abs().max()) <= 1
    if not ok:
        raise AssertionError(f"hyper_step {case.name} {z.dtype}: kernel "
                             f"disagrees with plain (max {err})")
    if act is not None and not torch.equal(out[act == 0], z[act == 0]):
        raise AssertionError(f"hyper_step {case.name}: frozen rows moved")
    return err


def phase_kernels(dev, bandwidth):
    """hyper_step at every case of ``hs_cases``: kernel against plain
    version, both timed cold-L2, and the bound of this run's data (an
    active row reads every operand and writes z, a frozen row reads and
    writes z only)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for case in hs_cases():
        z, stages, g, eps, act = hs_inputs(case, gen, dev)
        b, order = case.b, case.order
        out = hs_ops.fused_rk_update(z, stages, g, eps, b, order, active=act)
        ref = fused_rk_update_ref(z, stages, g, eps, b, order, active=act)
        torch.cuda.synchronize()
        err = hs_check(case, out, ref, z, act)
        eps_row, epsp_row, act_row = hs_ops.row_operands(z, eps, order, act)
        buf = torch.empty_like(z)
        ms = time_ms(lambda: hs_ops.launch(
            buf, z, stages, g, eps_row, epsp_row, act_row, b), flush)
        plain_ms = time_ms(lambda: fused_rk_update_ref(
            z, stages, g, eps, b, order, active=act), flush)
        n_rows = act_row.numel()
        n = z.numel() // n_rows
        n_act = int(act_row.sum())
        active_bytes = 2 * z.element_size() + sum(
            t.element_size() for t in stages + ([g] if g is not None else []))
        nbytes = n * (n_act * active_bytes
                      + (n_rows - n_act) * 2 * z.element_size()) + n_rows * 12
        flops = n_act * n * 2 * (len(b) + int(g is not None))
        bound_ms = max(nbytes / bandwidth, flops / FP32_PEAK) * 1e3
        rows.append(dict(case=case.name, shape=list(case.shape),
                         dtype=str(z.dtype).replace("torch.", ""),
                         dtypes=[str(t).replace("torch.", "")
                                 for t in case.dtypes],
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bytes=nbytes,
                         bound_by="bytes" if nbytes / bandwidth
                         >= flops / FP32_PEAK else "operations"))
        del z, stages, g, out, ref, buf
    emit(phase="kernels", kernel="hyper_step", cases=rows,
         max_abs_err=max(r["max_abs_err"] for r in rows))
    return rows, max(r["max_abs_err"] for r in rows)


def attention_pairs(S_len, causal, window):
    """(query, key) pairs a row set of length S_len attends over: the
    work this run's masks leave, not the dense S^2."""
    q = np.arange(S_len)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros_like(q)
    hi = q + 1 if causal else np.full_like(q, S_len)
    return int(np.sum(hi - lo))


# name, (B, S, H, KV, hd), dtype, window: the serving shapes of both
# models (Griffin's local window does not bind at S 128), float16 and
# float32 at the Qwen3 shape (the fused-vs-unfused phase runs float32),
# a window that binds, and ragged S with windows whose first visited tile
# is fully masked
FLASH_CASES = [
    ("griffin", (8, 128, 10, 1, 256), torch.bfloat16, 2048),
    ("qwen3", (8, 128, 32, 8, 128), torch.bfloat16, None),
    ("qwen3-fp16", (8, 128, 32, 8, 128), torch.float16, None),
    ("qwen3-fp32", (8, 128, 32, 8, 128), torch.float32, None),
    ("window-binds", (1, 4096, 10, 1, 256), torch.bfloat16, 2048),
    ("ragged", (2, 200, 10, 1, 256), torch.bfloat16, 130),
    ("ragged-fp32", (2, 200, 32, 8, 128), torch.float32, 40),
]
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-2, torch.float32: 2e-5}


def phase_flash(dev, bandwidth):
    """flash_attention against its plain version (rtol = atol 2e-5 in
    fp32 with TF32 off, 2e-2 in bf16 and fp16: the bounds
    tests/test_kernels.py holds the Pallas kernel to, since the sums run in
    other orders), the kernel, plain and SDPA times cold-L2, and each
    case's bound (bf16 and fp16 at the tensor cores' peak)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    gen = torch.Generator(device=dev).manual_seed(4)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for name, (b, s, h, kv, hd), dtype, window in FLASH_CASES:
        def draw(n):
            return torch.randn((b, s, n, hd), generator=gen,
                               device=dev).to(dtype)
        q, k, v = draw(h), draw(kv), draw(kv)
        out = fa_ops.flash_attention(q, k, v, causal=True, window=window)
        ref = attention_ref(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = FLASH_TOL[dtype]
        if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol):
            raise AssertionError(f"flash_attention {name}: kernel disagrees "
                                 f"with plain (max abs err {err})")
        buf = torch.empty_like(q)
        ms = time_ms(lambda: fa_ops.launch(buf, q, k, v, True, window),
                     flush)
        plain_ms = time_ms(lambda: attention_ref(q, k, v, causal=True,
                                                 window=window), flush)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window is None or window >= s:
            lib = dict(is_causal=True)
        else:
            pos = torch.arange(s, device=dev)
            lib = dict(attn_mask=(pos[None, :] <= pos[:, None])
                       & (pos[:, None] - pos[None, :] < window))
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True, **lib), flush)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = 4 * hd * b * h * attention_pairs(s, True, window)
        peak = FP32_PEAK if dtype == torch.float32 else BF16_PEAK
        bound = max(nbytes / bandwidth, flops / peak) * 1e3
        rows.append(dict(case=name, shape=[b, s, h, kv, hd],
                         dtype=str(dtype).replace("torch.", ""),
                         window=window, max_abs_err=err, tol=tol, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound, bytes=nbytes, flops=flops,
                         bound_by="bytes" if nbytes / bandwidth
                         >= flops / peak else "operations"))
        del q, k, v, out, ref, buf
    emit(phase="kernels", kernel="flash_attention", causal=True, cases=rows,
         max_abs_err=max(r["max_abs_err"] for r in rows),
         library="torch.nn.functional.scaled_dot_product_attention")
    return rows


# name, (B, T, W), input dtype: the serving shape (fp32 gates, as
# nn/rglru.py::_gates gives them), a long prompt at batch 1 (the deep
# ring), ragged shapes in fp32, bf16 and fp16 (W 1000 and 2000: 16-byte
# rows, a part-filled last 32-channel tile; W 333: rows not 16-byte
# aligned, the scalar path), and T 5, below one stage of the ring
RGLRU_CASES = [
    ("serve", (8, 128, 2560), torch.float32),
    ("long-prompt", (1, 2048, 2560), torch.float32),
    ("ragged", (3, 77, 1000), torch.float32),
    ("ragged-bf16", (2, 45, 333), torch.bfloat16),
    ("ragged-fp16", (4, 50, 2000), torch.float16),
    ("short-unaligned", (2, 5, 333), torch.float32),
]


def rglru_inputs(shape, dtype, gen, dev):
    """Gates a in (0, 1) and inputs b of ``shape`` in ``dtype``."""
    a = torch.sigmoid(torch.randn(shape, generator=gen, device=dev)).to(dtype)
    return a, torch.randn(shape, generator=gen, device=dev).to(dtype)


def phase_rglru(dev, bandwidth):
    """rglru_scan against its plain version bit for bit, both timed
    cold-L2, and the bound (2 reads and 1 fp32 write per element)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for name, shape, dtype in RGLRU_CASES:
        a, b = rglru_inputs(shape, dtype, gen, dev)
        out = rg_ops.rglru_scan(a, b)
        ref = rglru_scan_ref(a, b)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if out.dtype != torch.float32 or not torch.equal(out, ref):
            raise AssertionError(f"rglru_scan {name}: kernel disagrees with "
                                 f"plain (max abs err {err})")
        buf = torch.empty_like(out)
        ms = time_ms(lambda: rg_ops.launch(buf, a, b), flush)
        plain_ms = time_ms(lambda: rglru_scan_ref(a, b), flush)
        nbytes = 2 * a.numel() * a.element_size() + out.numel() * 4
        flops = 2 * a.numel()
        bound = max(nbytes / bandwidth, flops / FP32_PEAK) * 1e3
        rows.append(dict(case=name, shape=list(shape),
                         dtype=str(dtype).replace("torch.", ""),
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bytes=nbytes,
                         bound_by="bytes" if nbytes / bandwidth
                         >= flops / FP32_PEAK else "operations"))
    emit(phase="kernels", kernel="rglru_scan", cases=rows,
         max_abs_err=max(r["max_abs_err"] for r in rows),
         library=None, library_note="no single PyTorch call computes a "
         "linear recurrence h_t = a_t h_(t-1) + b_t (torch has no scan op)")
    return rows


# name, (B, T, H, D), dtypes of (r, k, v), w, u, with a state: the
# serving shape (bf16 dense outputs, the fp32 decay, a bf16 parameter),
# ragged fp32, D 16 over 200 tokens (past the reference kernel's
# 128-token chunk), a given S0 with the final state asked for, and the
# smallest and largest instantiated head sizes (D 8, whose block is 4
# threads, and D 128 with a state), and one decode step of the serving
# model (T 1 from a given S0, every rwkv block of every generated token)
RWKV6_CASES = [
    ("serve", (8, 128, 32, 64), torch.bfloat16, torch.float32,
     torch.bfloat16, False),
    ("ragged-fp32", (3, 77, 5, 64), torch.float32, torch.float32,
     torch.float32, False),
    ("d16-t200", (2, 200, 4, 16), torch.float32, torch.float32,
     torch.float32, False),
    ("state", (2, 50, 4, 64), torch.bfloat16, torch.float32,
     torch.bfloat16, True),
    ("d8-t77", (3, 77, 6, 8), torch.float32, torch.float32,
     torch.float32, False),
    ("d128-state", (2, 100, 8, 128), torch.bfloat16, torch.float32,
     torch.bfloat16, True),
    ("decode", (8, 1, 32, 64), torch.bfloat16, torch.float32,
     torch.bfloat16, True),
]
RWKV6_TOL = 2e-6    # max abs error over max |plain|


def phase_rwkv6(dev, bandwidth):
    """rwkv6_scan against its plain version (max abs error at most 2e-6
    of the largest plain output; the final state equal bit for bit, since
    the kernel rounds the state update as the plain version does and only
    regroups and reorders the output's sums), both timed cold-L2, and the
    bound (each operand read once, o and S_T written once; 5 flops per
    state element per token: k v, w S, + kv, and r S as an fma of 2)."""
    gen = torch.Generator(device=dev).manual_seed(6)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for name, (b, t, h, d), xdt, wdt, udt, state in RWKV6_CASES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        r, k, v = (randn(b, t, h, d).to(xdt) for _ in range(3))
        # the model's decay range: exp(-exp(w0)), w0 in [-6, -1]
        w0 = torch.linspace(-6.0, -1.0, h * d, device=dev).reshape(h, d)
        w = torch.exp(-torch.exp(w0 + 0.1 * randn(b, t, h, d))).to(wdt)
        u = (0.3 * randn(h, d)).to(udt)
        S0 = randn(b, h, d, d) if state else None
        out = rw_ops.wkv6(r, k, v, w, u, S0, want_state=state)
        ref = wkv6_scan_ref(r, k, v, w, u, S0)
        torch.cuda.synchronize()
        pairs = list(zip(out, ref)) if state else [(out, ref[0])]
        errs = [float((o - p).abs().max()) for o, p in pairs]
        scale = [float(p.abs().max()) for _, p in pairs]
        if any(e > RWKV6_TOL * s for e, s in zip(errs, scale)):
            raise AssertionError(f"rwkv6_scan {name}: kernel disagrees with "
                                 f"plain (max abs err {errs}, max |plain| "
                                 f"{scale})")
        if state and not torch.equal(out[1], ref[1]):
            raise AssertionError(f"rwkv6_scan {name}: final state differs "
                                 f"from plain (max abs err {errs[1]})")
        o_buf = torch.empty((b, t, h, d), dtype=torch.float32, device=dev)
        s_buf = torch.empty_like(S0) if state else None
        ms = time_ms(lambda: rw_ops.launch(o_buf, r, k, v, w, u, S0, s_buf),
                     flush)
        plain_ms = time_ms(lambda: wkv6_scan_ref(r, k, v, w, u, S0), flush)
        nbytes = sum(x.numel() * x.element_size() for x in (r, k, v, w, u)) \
            + o_buf.numel() * 4 + (2 * S0.numel() * 4 if state else 0)
        flops = 5 * d * d * b * t * h
        bound = max(nbytes / bandwidth, flops / FP32_PEAK) * 1e3
        rows.append(dict(case=name, shape=[b, t, h, d],
                         dtypes=[str(x).replace("torch.", "")
                                 for x in (xdt, wdt, udt)],
                         state=state, max_abs_err=max(errs),
                         max_abs_plain=max(scale), tol=RWKV6_TOL, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound, bytes=nbytes,
                         flops=flops,
                         bound_by="bytes" if nbytes / bandwidth
                         >= flops / FP32_PEAK else "operations"))
        del r, k, v, w, u, S0, out, ref, o_buf, s_buf
    emit(phase="kernels", kernel="rwkv6_scan", cases=rows,
         max_abs_err=max(r["max_abs_err"] for r in rows),
         library=None, library_note="no single PyTorch call computes the "
         "WKV6 recurrence (a data-dependent diagonal decay of a (D, D) "
         "state per head)")
    return rows


@contextlib.contextmanager
def count_blocks():
    """Counts block applications by kind while open, by wrapping
    ``block_apply`` where the model code calls it (models/lm.py and
    models/cdepth.py); the package itself keeps no such counter."""
    counts = collections.Counter()
    orig = lm.block_apply

    def counted(p, cfg, kind, h, cache=None):
        counts[kind] += 1
        return orig(p, cfg, kind, h, cache)

    for mod in (lm, cdepth):
        mod.block_apply = counted
    try:
        yield counts
    finally:
        for mod in (lm, cdepth):
            mod.block_apply = orig


def packed_k_max_sum(results, max_batch):
    """Sum of k_max over the engine's packed batches: stable sort by K,
    chunks of max_batch (one drain, no retries)."""
    Ks = np.sort(np.asarray([r.K for r in results]), kind="stable")
    return int(sum(Ks[lo:lo + max_batch].max()
                   for lo in range(0, len(Ks), max_batch)))


def straddling_tol(errs, q: int = 1) -> float:
    """A tolerance that splits this run's probe errors across the bucket
    edge at 4: a request takes K = ceil((err / tol)^(1/q)), i.e. at most 4
    below the median error and 5, snapped to 8, above it. Random weights
    probe alike (the errors sit within a few percent), so no fixed
    tolerance would mix K."""
    return float(np.median(errs)) / 4.0 ** q


def check_served(results, tag):
    buckets = {int(b) for b in BUCKETS.split(",")}
    if len({r.K for r in results}) < 2:
        raise AssertionError(f"{tag}: every request took K={results[0].K}; "
                             "the batch must mix K")
    for r in results:
        if r.status != "ok":
            raise AssertionError(f"{tag}: request {r.uid} status {r.status}")
        if not np.isfinite(r.outputs).all():
            raise AssertionError(f"{tag}: request {r.uid} non-finite")
        if r.K not in buckets:
            raise AssertionError(f"{tag}: request {r.uid} K={r.K}")
        if not r.fused_kernel:
            raise AssertionError(f"{tag}: request {r.uid} not fused")


def serve_breakdown(engine, prompt):
    """Where one drain's time goes (host clock around synchronised work,
    median of 3): the probe (embed + probe step), the fused solve, the
    float32 readout, the host copy of the logits into Completed, and the
    engine's host finite screen of them."""
    m, ctrl = engine.model, engine.controller

    def timed(fn):
        out, times = None, []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return out, float(np.median(times)) * 1e3

    with torch.no_grad():
        (z0, probe), probe_ms = timed(lambda: (
            lambda z: (z, ctrl.select(m.integ, m.field_of(prompt), z,
                                      m.span)))(m.embed(prompt)))
        Ks = torch.as_tensor(snap_to_buckets(
            probe.K.cpu().numpy(), engine.ecfg.buckets), device=z0.device)
        k_max = int(Ks.max())
        zT, solve_ms = timed(lambda: m.integ.solve_multirate(
            m.field_of(prompt), z0, m.span, Ks, k_max,
            first_stage=probe.dz0))
        logits, readout_ms = timed(lambda: m.readout(prompt, zT))
        host, copy_ms = timed(lambda: logits.cpu().numpy())
        _, screen_ms = timed(lambda: np.isfinite(
            host.reshape(len(host), -1)).all(axis=1))
    return dict(probe=probe_ms, solve=solve_ms, k_max=k_max,
                readout=readout_ms, host_copy=copy_ms,
                host_finite_screen=screen_ms)


def serve_cli(arch, *extra):
    return serve.main(["--arch", arch, "--batch", str(B),
                       "--prompt-len", str(S), "--solver", "euler",
                       "--multirate", "--fused", "--buckets", BUCKETS,
                       *extra])


def check_block_launches(launches, blocks, tag):
    """Every attention block application launched flash_attention once,
    every Griffin recurrent block application rglru_scan once, every
    RWKV6 block application rwkv6_scan once."""
    for kernel, kinds in (("flash_attention", ("dense", "attn")),
                          ("rglru_scan", ("rec",)),
                          ("rwkv6_scan", ("rwkv",))):
        applied = sum(blocks.get(k, 0) for k in kinds)
        if launches.get(kernel, 0) != applied:
            raise AssertionError(f"{tag}: {kernel} launched "
                                 f"{launches.get(kernel, 0)} times, the "
                                 f"{'/'.join(kinds)} block applications "
                                 f"were {applied}")


def hyper_engine(params, cfg, gp, tol):
    model = lm_depth_model(params, cfg, solver="hyper_euler", g_params=gp,
                           fused=True)
    ecfg = EngineConfig(buckets=tuple(int(b) for b in BUCKETS.split(",")),
                        tol=tol, max_batch=8, solver="hyper_euler",
                        fused=True)
    return MultiRateEngine(model, ecfg)


def phase_serve(dev):
    """A main path: full-width qwen3_4b served through the CLI (euler)
    and the engine (hyper_euler with a seeded nonzero g), every solver
    step's update through hyper_step and every attention block through
    flash_attention, each batch mixing K. A calibration run before it
    reads this run's probe errors and picks each solver's tolerance from
    them."""
    torch.cuda.reset_peak_memory_stats(dev)
    calib = serve_cli("qwen3_4b")
    cfg, prompt = calib["cfg"], calib["prompt"]
    gen = torch.Generator(device=dev).manual_seed(1)
    gp = lm_g_init(gen, cfg, rank=32, device=dev)
    gp["w_out"] = truncated_normal_init(gen, gp["w_out"].shape, 0.02,
                                        gp["w_out"].dtype, dev)
    tol_euler = straddling_tol([r.err_probe for r in calib["results"]])
    with torch.no_grad():
        tol_hyper = straddling_tol(hyper_engine(
            calib["params"], cfg, gp, 1e-2).probe(prompt)[1])
    del calib
    torch.cuda.empty_cache()

    LAUNCHES.clear()
    with count_blocks() as blocks:
        t0 = time.perf_counter()
        cli = serve_cli("qwen3_4b", "--tol", repr(tol_euler))
        cli_wall = time.perf_counter() - t0
        params = cli["params"]
        engine = hyper_engine(params, cfg, gp, tol_hyper)
        ecfg, model = engine.ecfg, engine.model
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hyper = engine.run(prompt)
            torch.cuda.synchronize()
            hyper_s = time.perf_counter() - t0
    launches, blocks = dict(LAUNCHES), dict(blocks)
    check_served(cli["results"], "serve euler")
    check_served(hyper, "engine hyper_euler")
    expected = packed_k_max_sum(cli["results"], 8) \
        + packed_k_max_sum(hyper, ecfg.max_batch)
    if launches.get("hyper_step", 0) != expected:
        raise AssertionError(f"hyper_step launched "
                             f"{launches.get('hyper_step', 0)} times, the "
                             f"solver steps were {expected}")
    check_block_launches(launches, blocks, cfg.name)
    hyper_agree = [float(np.mean(np.argmax(r.outputs, -1)
                                 == cli["full_top"][i]))
                   for i, r in enumerate(hyper)]

    breakdown = serve_breakdown(cli["engine"], prompt)
    emit(phase="serve", arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, batch=B, prompt_len=S,
         euler=dict(seconds=cli["seconds"], cli_wall_s=cli_wall,
                    tol=tol_euler, K=[r.K for r in cli["results"]],
                    mean_nfe=float(np.mean([r.nfe for r in cli["results"]])),
                    agree=float(np.mean(cli["agree"]))),
         hyper_euler=dict(seconds=hyper_s, tol=tol_hyper,
                          K=[r.K for r in hyper],
                          mean_nfe=float(np.mean([r.nfe for r in hyper])),
                          agree=float(np.mean(hyper_agree))),
         launches=launches, expected_hyper_step_launches=expected,
         block_applications=blocks,
         euler_breakdown_ms=breakdown,
         logits_bytes=B * S * cfg.vocab * 4,
         peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    del cli, model, engine, gp
    torch.cuda.empty_cache()
    return launches, params, prompt, tol_euler


def serve_counted(dev, arch):
    """Serve full-width ``arch`` through the CLI as euler, multi-rate and
    fused, K mixed by a calibration drain first (as the qwen3_4b phase),
    with every kernel launch and block application counted; checks what
    every serving path holds (each request served, hyper_step once per
    solver step, the block kernels once per block application) and
    returns the phase's report, launches and block applications, and the
    served params and prompt."""
    torch.cuda.reset_peak_memory_stats(dev)
    calib = serve_cli(arch)
    cfg, prompt = calib["cfg"], calib["prompt"]
    tol = straddling_tol([r.err_probe for r in calib["results"]])
    del calib
    torch.cuda.empty_cache()

    LAUNCHES.clear()
    with count_blocks() as blocks:
        t0 = time.perf_counter()
        cli = serve_cli(arch, "--tol", repr(tol))
        cli_wall = time.perf_counter() - t0
    launches, blocks = dict(LAUNCHES), dict(blocks)
    check_served(cli["results"], f"{arch} serve euler")
    expected = packed_k_max_sum(cli["results"], 8)
    if launches.get("hyper_step", 0) != expected:
        raise AssertionError(f"{arch}: hyper_step launched "
                             f"{launches.get('hyper_step', 0)} times, the "
                             f"solver steps were {expected}")
    check_block_launches(launches, blocks, cfg.name)
    report = dict(
        phase="serve", arch=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, dtype=cfg.dtype, batch=B, prompt_len=S,
        euler=dict(seconds=cli["seconds"], cli_wall_s=cli_wall, tol=tol,
                   K=[r.K for r in cli["results"]],
                   mean_nfe=float(np.mean([r.nfe for r in cli["results"]])),
                   agree=float(np.mean(cli["agree"])),
                   agree_by_row=cli["agree"]),
        launches=launches, expected_hyper_step_launches=expected,
        block_applications=blocks,
        euler_breakdown_ms=serve_breakdown(cli["engine"], prompt),
        logits_bytes=B * S * cfg.vocab * 4,
        peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    params = cli["params"]
    del cli
    torch.cuda.empty_cache()
    return report, launches, blocks, params, prompt


def phase_serve_griffin(dev):
    """A main path: full-width recurrentgemma_2b (26 layers: 8 groups of
    rec, rec, attn and 2 tail rec layers). Every recurrent block runs
    rglru_scan, every local attention block flash_attention, every solver
    step hyper_step."""
    report, launches, blocks, params, prompt = serve_counted(
        dev, "recurrentgemma_2b")
    idle = [k for k in ("hyper_step", "flash_attention", "rglru_scan")
            if not launches.get(k)]
    if idle:
        raise AssertionError(f"griffin: {idle} never launched")
    # each group is (rec, rec, attn); each pass over the tail is 2 rec
    tail_passes, rem = divmod(blocks["rec"] - 2 * blocks["attn"], 2)
    if rem or tail_passes < 1:
        raise AssertionError(f"griffin: {blocks} is not 2 rec per attn "
                             "plus 2 per tail pass")
    emit(**report, tail_passes=tail_passes)
    return launches, params, prompt, report["euler"]["tol"]


def phase_serve_rwkv6(dev):
    """A main path: full-width rwkv6_1p6b (24 rwkv layers, d 2048, 32 WKV
    heads of 64). Every rwkv block runs rwkv6_scan, every solver step
    hyper_step; nothing attends."""
    report, launches, blocks, params, prompt = serve_counted(dev,
                                                             "rwkv6_1p6b")
    idle = [k for k in ("hyper_step", "rwkv6_scan") if not launches.get(k)]
    if idle:
        raise AssertionError(f"rwkv6: {idle} never launched")
    if set(blocks) != {"rwkv"} or launches.get("flash_attention", 0) \
            or launches.get("rglru_scan", 0):
        raise AssertionError(f"rwkv6: blocks {blocks}, launches {launches}: "
                             "only rwkv blocks and their kernels should run")
    emit(**report)
    return launches, params, prompt, report["euler"]["tol"]


def phase_fused_vs_unfused(dev):
    """Full width in float32 at 4 layers, TF32 off: fused and unfused
    serving pick the same K and agree to rtol 1e-4 (atol 1e-5 of the
    largest logit)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get("qwen3_4b"), n_layers=4, dtype="float32",
                              param_dtype="float32")
    params = init_lm(torch.Generator(device=dev).manual_seed(2), cfg,
                     device=dev)
    prompt = np.random.RandomState(3).randint(0, cfg.vocab, (B, S))
    report = {}
    for solver in ("euler", "heun"):
        def engine(fused, tol):
            return MultiRateEngine(
                lm_depth_model(params, cfg, solver=solver, fused=fused),
                EngineConfig(buckets=(2, 4, 8), tol=tol, solver=solver,
                             fused=fused))
        with torch.no_grad():
            tol = straddling_tol(engine(False, 1e-2).probe(prompt)[1],
                                 get_tableau(solver).order)
            runs = [engine(fused, tol).run(prompt) for fused in (False, True)]
        ks = [[r.K for r in run] for run in runs]
        if ks[0] != ks[1]:
            raise AssertionError(f"{solver}: K unfused {ks[0]} fused {ks[1]}")
        if len(set(ks[1])) < 2:
            raise AssertionError(f"{solver}: every request took K={ks[1][0]}")
        diff = scale = 0.0
        for a, b in zip(*runs):
            # rtol 1e-4; atol 1e-5 of the largest logit, because a logit is
            # a 2560-term dot product whose rounding scales with its terms
            np.testing.assert_allclose(b.outputs, a.outputs, rtol=1e-4,
                                       atol=1e-5 * np.abs(a.outputs).max())
            diff = max(diff, float(np.abs(b.outputs - a.outputs).max()))
            scale = max(scale, float(np.abs(a.outputs).max()))
        report[solver] = dict(tol=tol, K=ks[1], max_abs_diff=diff,
                              max_abs_logit=scale)
    emit(phase="fused_vs_unfused", layers=4, dtype="float32", **report)


def inflight_prompts(cfg, prompt):
    """The in-flight phases' requests: ``INFLIGHT_REQUESTS`` prompts from
    the serving CLI's generator, whose first ``B`` are the serve phase's."""
    prompts = np.random.RandomState(1).randint(
        0, cfg.vocab, size=(INFLIGHT_REQUESTS, S)).astype(np.int32)
    if not np.array_equal(prompts[:B], prompt):
        raise AssertionError(f"{cfg.name}: the in-flight prompts do not "
                             "start with the serve phase's")
    return prompts


@contextlib.contextmanager
def count_syncs():
    """Counts, by the source line that made them, the host syncs the CUDA
    runtime reports while open (``torch.cuda.set_sync_debug_mode``: a
    blocking copy between host and card, a stream or device sync). Waits
    on a CUDA event (the scheduler's readbacks) are not reported."""
    where = collections.Counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield where
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if "synchroniz" in str(w.message):
            where[f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"] += 1


def run_inflight(model, ecfg, prompts, overlap):
    """One in-flight replay of the prompts on the Poisson trace: the
    scheduler, its trace report, and the wall seconds (host clock around
    synchronised work)."""
    sched = InflightScheduler(model, ecfg, slots=SLOTS, seg=SEG,
                              overlap=overlap)
    trace = poisson_trace(prompts, rate=ARRIVAL_RATE, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = replay_scheduler(sched, trace)
    torch.cuda.synchronize()
    return sched, report, time.perf_counter() - t0


def own_outputs(report):
    """The report with each record's outputs copied out of the scheduler's
    pinned readback buffers (the records hold views of them), so those
    buffers go back to the pinned allocator's cache."""
    return dataclasses.replace(report, records=tuple(
        dataclasses.replace(r, outputs=None if r.outputs is None
                            else np.array(r.outputs))
        for r in report.records))


def check_inflight(tag, sync_rep, over_rep, drain, limit):
    """Raises unless every request is ``ok``, the overlap loop's records
    equal the sync loop's uid for uid (outputs bit for bit, K, nfe,
    completion order, virtual stamps), and each request's K and nfe equal
    the drain engine's for its prompt and its logits lie within ``limit``
    of the drain's largest |logit| or agree with them by argmax at every
    position. Returns the largest relative difference and the worst
    argmax agreement."""
    for rec in sync_rep.records + over_rep.records:
        if rec.status != "ok":
            raise AssertionError(f"{tag}: request {rec.uid} {rec.status}")
    key = lambda r: (r.uid, r.K, r.nfe, r.t_submit, r.t_admit, r.t_done)
    if [key(r) for r in sync_rep.records] != \
            [key(r) for r in over_rep.records]:
        raise AssertionError(f"{tag}: sync and overlap records differ")
    for a, b in zip(sync_rep.records, over_rep.records):
        if not np.array_equal(a.outputs, b.outputs):
            raise AssertionError(f"{tag}: request {a.uid}'s outputs differ "
                                 "between the sync and overlap loops")
    worst_rel, worst_agree = 0.0, 1.0
    for rec in sync_rep.records:
        ref = drain[rec.uid - 1]
        if (rec.K, rec.nfe) != (ref.K, ref.nfe):
            raise AssertionError(f"{tag}: request {rec.uid} K/nfe "
                                 f"{rec.K}/{rec.nfe}, drain "
                                 f"{ref.K}/{ref.nfe}")
        rel = float(np.abs(rec.outputs - ref.outputs).max()
                    / np.abs(ref.outputs).max())
        agree = float(np.mean(rec.outputs.argmax(-1)
                              == ref.outputs.argmax(-1)))
        if rel > limit and agree < 1.0:
            raise AssertionError(f"{tag}: request {rec.uid} logits {rel} "
                                 f"of the largest |logit| from the drain's "
                                 f"(limit {limit}), argmax agreement "
                                 f"{agree}")
        worst_rel, worst_agree = max(worst_rel, rel), min(worst_agree, agree)
    return dict(max_rel_diff_vs_drain=worst_rel,
                min_argmax_agreement_vs_drain=worst_agree,
                rel_limit=limit)


def phase_inflight(dev, cfg, params, prompt, tol, via_cli=False):
    """A main path: the in-flight scheduler serving ``INFLIGHT_REQUESTS``
    full-width prompts of a model on its serve phase's params and
    calibrated tolerance (euler, multi-rate over buckets 2,4,8, fused),
    slots 4, seg 2, a Poisson trace at 0.25 per cost unit, seed 0; once
    with the synchronous loop and once with the overlap loop (for qwen3_4b
    through the serving CLI, whose weights from the same seed must equal
    the serve phase's). Every segment runs hyper_step once per step, every
    block application its kernel. Before the counted runs, the drain
    engine serves the same prompts (the reference for K, nfe and logits)
    and both loops run once more with their host syncs counted."""
    prompts = inflight_prompts(cfg, prompt)
    ecfg = EngineConfig(buckets=tuple(int(b) for b in BUCKETS.split(",")),
                        tol=tol, max_batch=B, solver="euler", fused=True)
    model = lm_depth_model(params, cfg, solver="euler", fused=True)
    with torch.no_grad():
        drain = MultiRateEngine(model, ecfg).run(prompts)
    syncs = {}
    for overlap in (False, True):
        with count_syncs() as where:
            counted = run_inflight(model, ecfg, prompts, overlap)[0]
        total = sum(where.values())
        syncs["overlap" if overlap else "sync"] = dict(
            total=total, segments=counted.dispatches,
            per_segment=total / counted.dispatches,
            by_line=dict(where.most_common()))
        del counted

    LAUNCHES.clear()
    with count_blocks() as blocks:
        sync_sched, sync_rep, sync_s = run_inflight(model, ecfg, prompts,
                                                    False)
        # not timed: the overlap run then finds the pinned cache the sync
        # run found, not one held by the sync run's outputs
        sync_rep = own_outputs(sync_rep)
        if via_cli:
            cli = serve_cli(cfg.name, "--batch", str(INFLIGHT_REQUESTS),
                            "--tol", repr(tol), "--inflight",
                            "--arrival-trace", "poisson", "--overlap")
            over_sched, over_rep, over_s = (cli["sched"], cli["report"],
                                            cli["seconds"])
        else:
            over_sched, over_rep, over_s = run_inflight(model, ecfg,
                                                        prompts, True)
    launches, blocks = dict(LAUNCHES), dict(blocks)
    if via_cli:
        same = np.array_equal(cli["prompt"], prompts) and all(
            torch.equal(a, b) for a, b in zip(
                pytree.tree_leaves(cli["params"]), pytree.tree_leaves(params)))
        del cli
        if not same:
            raise AssertionError(f"{cfg.name}: the CLI's prompts or weights "
                                 "differ from the serve phase's")
    tag = f"{cfg.name} inflight"
    checked = check_inflight(tag, sync_rep, over_rep, drain,
                             INFLIGHT_TOL[cfg.name])
    dispatches = sync_sched.dispatches + over_sched.dispatches
    if launches.get("hyper_step", 0) != dispatches * SEG:
        raise AssertionError(f"{tag}: hyper_step launched "
                             f"{launches.get('hyper_step', 0)} times, the "
                             f"segments dispatched x seg were "
                             f"{dispatches * SEG}")
    check_block_launches(launches, blocks, tag)
    stats = latency_stats(sync_rep)
    emit(phase="inflight", arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, requests=INFLIGHT_REQUESTS,
         prompt_len=S, slots=SLOTS, seg=SEG, arrival_rate=ARRIVAL_RATE,
         tol=tol, overlap_via_cli=via_cli,
         wall_s=dict(sync=sync_s, overlap=over_s),
         segments=dict(sync=sync_sched.dispatches,
                       overlap=over_sched.dispatches),
         host_syncs=syncs,
         virtual=dict(p50_latency=stats["p50_latency"],
                      p99_latency=stats["p99_latency"],
                      makespan=sync_rep.makespan,
                      waste_frac=stats["waste_frac"],
                      occupancy=stats["occupancy"],
                      cost_unit=stats["cost_unit"]),
         K=[r.K for r in sorted(sync_rep.records, key=lambda r: r.uid)],
         drain_K=[r.K for r in drain],
         drain_err_over_tol=[r.err_probe / tol for r in drain],
         launches=launches, expected_hyper_step_launches=dispatches * SEG,
         block_applications=blocks, **checked)
    del drain, sync_rep, over_rep
    torch.cuda.empty_cache()
    return launches


def refinable_model(params, cfg):
    """The served model with a parametric zero-readout g (rank 32, the
    CLI's --g-rank default): the refinery's model."""
    return lm_depth_model(params, cfg, solver="euler", fused=True,
                          refinable=True, rank=32)


def embedded_ecfg(tol, **kw):
    """The in-flight phase's policy, with the embedded controller named:
    a parametric g would make ``auto`` pick the residual controller."""
    return EngineConfig(buckets=tuple(int(b) for b in BUCKETS.split(",")),
                        tol=tol, max_batch=B, solver="euler",
                        controller="embedded", fused=True, **kw)


def replay(model, ecfg, prompts, *, overlap=False, ledger=None,
           on_tick=None, fault_injector=None):
    """One in-flight replay of the phase's Poisson trace (slots 4, seg 2,
    seed 0): the scheduler, its report with outputs owned, wall seconds."""
    sched = InflightScheduler(model, ecfg, slots=SLOTS, seg=SEG,
                              overlap=overlap, ledger=ledger,
                              fault_injector=fault_injector)
    trace = poisson_trace(prompts, rate=ARRIVAL_RATE, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        report = replay_scheduler(sched, trace, on_tick=on_tick)
    torch.cuda.synchronize()
    return sched, own_outputs(report), time.perf_counter() - t0


def records_equal(a, b) -> bool:
    """Two replays' records equal uid for uid (K, nfe, status, virtual
    stamps; outputs bit for bit). Completion order is not compared: the
    overlap loop materialises a tick's flow rows before the previous
    segment's retirements, as the reference's does."""
    key = lambda r: (r.uid, r.K, r.nfe, r.status, r.t_submit, r.t_admit,
                     r.t_done)
    ra, rb = (sorted(x.records, key=lambda r: r.uid) for x in (a, b))
    return [key(r) for r in ra] == [key(r) for r in rb] \
        and all(np.array_equal(x.outputs, y.outputs, equal_nan=True)
                for x, y in zip(ra, rb))


def synced_ms(fn):
    """(result, ms) of ``fn`` between two device synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def swapper(params, at=SWAP_SEGMENTS):
    """An on_tick that hot-swaps ``params`` into the scheduler once ``at``
    segments have been launched (segment ``at + 1`` is the first on the
    new params, in the sync and the overlap loop alike) and notes the
    virtual time of the swap."""
    state = {"now": None}

    def on_tick(s):
        if s.dispatches >= at and state["now"] is None:
            state["now"] = s.now
            s.hot_swap_g(params)
    return on_tick, state


def phase_refinery(dev, cfg, params, prompt, tol):
    """A main path: the online refinery on a full-width model's serve-phase
    params (bf16). (1) The in-flight phase's trace replayed (sync loop)
    with a ``ResidualLedger`` (64 rows, rate 1, seed 0): completions bit
    for bit the ledger-free run's, every captured R finite, hyper_step =
    segments x seg, each block kernel once per block application (the
    capture cells' included). (2) A ``Refinery`` (shadow every 2 steps,
    4 held-out prompts, ref_K = max(n_groups, 8)) trains, scores and
    gates; swapping its candidate after the 4th segment moves only
    completions after the swap (sync and overlap alike), swapping the
    current params moves none. Returns (launches, the ledger)."""
    prompts = inflight_prompts(cfg, prompt)
    model = refinable_model(params, cfg)
    ecfg = embedded_ecfg(tol)
    syncs = {}
    with count_syncs() as where:
        base_sched, base, base_s = replay(model, ecfg, prompts)
    syncs["without_ledger"] = sum(where.values()) / base_sched.dispatches
    with count_syncs() as where:
        counted = replay(model, ecfg, prompts, ledger=ResidualLedger(
            model, capacity=LEDGER_CAP, capture_rate=1.0, seed=0))[0]
    syncs["with_ledger"] = sum(where.values()) / counted.dispatches
    syncs["with_ledger_by_line"] = dict(where.most_common(8))
    del counted

    ledger = ResidualLedger(model, capacity=LEDGER_CAP, capture_rate=1.0,
                            seed=0)
    offered, capture_ms = [0, 0], []
    capture_pool = ledger.capture_pool

    def timed_capture(pool, rows):
        n, ms = synced_ms(lambda: capture_pool(pool, rows))
        if len(rows):
            capture_ms.append(ms)
            offered[0] += len(rows)
            offered[1] += n
        return n

    ledger.capture_pool = timed_capture
    LAUNCHES.clear()
    with count_blocks() as blocks:
        sched, rep, wall_s = replay(model, ecfg, prompts, ledger=ledger)
    launches, blocks = dict(LAUNCHES), dict(blocks)
    ledger.capture_pool = capture_pool
    tag = f"{cfg.name} refinery"
    if not records_equal(rep, base):
        raise AssertionError(f"{tag}: capture moved a completion")
    if not all(r.status == "ok" for r in rep.records):
        raise AssertionError(f"{tag}: a request did not finish ok")
    if ledger.fill == 0 or offered[0] != offered[1]:
        raise AssertionError(f"{tag}: ledger fill {ledger.fill}, "
                             f"{offered[0] - offered[1]} rows with a "
                             "non-finite R")
    if launches.get("hyper_step", 0) != sched.dispatches * SEG:
        raise AssertionError(f"{tag}: hyper_step launched "
                             f"{launches.get('hyper_step', 0)} times, "
                             f"segments x seg {sched.dispatches * SEG}")
    check_block_launches(launches, blocks, tag)
    row = ledger._samples[0]
    # the bf16 residual against the same rows' float32 residual: the same
    # capture cell on z widened to float32 (the reference's arithmetic
    # keeps the state's dtype through the first stage)
    rows = ledger._samples[:SLOTS]
    z16 = torch.stack([r[2] for r in rows]).to(dev)
    s_r = torch.tensor([r[0] for r in rows], device=dev)
    e_r = torch.tensor([r[1] for r in rows], device=dev)
    R16 = ledger._cell(None, z16, s_r, e_r)[1].float()
    R32 = ledger._cell(None, z16.float(), s_r, e_r)[1]
    r_norm = lambda t: t.reshape(len(rows), -1).norm(dim=1)
    bf16_resid = dict(
        rel_diff_vs_fp32=(r_norm(R16 - R32) / r_norm(R32)).tolist(),
        R_norm=r_norm(R32).tolist(),
        dz_norm_over_eps=(r_norm(torch.stack([r[3] for r in rows])
                                 .to(dev).float()) / e_r).tolist())
    del z16, R16, R32

    # (2) train, score, gate, swap
    _, n_groups, _ = lm.group_layout(cfg)
    shadow = np.random.RandomState(1000).randint(
        0, cfg.vocab, (SHADOW_PROMPTS, S)).astype(np.int32)
    refin, build_ms = synced_ms(lambda: Refinery(
        model, ledger, RefineryConfig(
            steps_per_tick=2, shadow_every=2,
            min_fill=min(32, ledger.fill), ref_K=max(n_groups, 8)),
        ecfg=ecfg, shadow_xs=shadow))
    losses = []
    _, fit_ms = synced_ms(refin.train_tick)
    losses.append(refin.last_loss)
    verdict, gate_ms = synced_ms(refin.maybe_promote)
    refin.tick()
    losses.append(refin.last_loss)
    if not np.isfinite(losses).all():
        raise AssertionError(f"{tag}: fit losses {losses}")
    cand = refin.candidate
    on_tick, swap = swapper(cand)
    swapped = replay(model, ecfg, prompts, on_tick=on_tick)[1]
    on_tick, _ = swapper(cand)
    swapped_over = replay(model, ecfg, prompts, overlap=True,
                          on_tick=on_tick)[1]
    on_tick, _ = swapper(model.g_params)
    same = replay(model, ecfg, prompts, on_tick=on_tick)[1]
    if not records_equal(same, base):
        raise AssertionError(f"{tag}: hot_swap_g(current) moved outputs")
    if not records_equal(swapped, swapped_over):
        raise AssertionError(f"{tag}: the swap reached the sync and "
                             "overlap loops differently")
    before = {r.uid: r for r in base.records}
    moved = early_moved = 0
    for r in swapped.records:
        differs = not np.array_equal(r.outputs, before[r.uid].outputs)
        if r.t_done <= swap["now"]:
            early_moved += differs
        else:
            moved += differs
    if early_moved or not moved:
        raise AssertionError(f"{tag}: the swap moved {early_moved} "
                             "completions before it and "
                             f"{moved} after it")
    emit(phase="refinery", arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, requests=len(prompts),
         slots=SLOTS, seg=SEG, ledger=dict(
             capacity=LEDGER_CAP, fill=ledger.fill,
             holdout=ledger.holdout_fill, seen=ledger.seen,
             captures=ledger.captures,
             row_dtypes=[str(t.dtype).replace("torch.", "")
                         for t in row[2:]],
             row_mb=sum(t.numel() * t.element_size() for t in row[2:])
             / 1e6),
         capture_ms=dict(mean=float(np.mean(capture_ms)),
                         max=float(np.max(capture_ms)),
                         n=len(capture_ms)),
         wall_s=dict(without_ledger=base_s, with_ledger=wall_s),
         host_syncs_per_segment=syncs, segments=sched.dispatches,
         launches=launches, block_applications=blocks,
         refinery=dict(build_ms=build_ms, fit_step_ms=fit_ms / 2,
                       shadow_score_ms=gate_ms / 2, losses=losses,
                       verdict=verdict, ref_K=refin.cfg.ref_K),
         swap=dict(after_segments=SWAP_SEGMENTS, now=swap["now"],
                   moved_after=moved,
                   moved_before=early_moved),
         bf16_residual=bf16_resid)
    del refin, swapped, swapped_over, same, base, rep
    torch.cuda.empty_cache()
    return launches, ledger


def phase_refinery_cli(dev):
    """A main path through the CLI: full-width qwen3_4b served in flight
    with ``--refine`` (20 Poisson arrivals, K 4 at seg 1 so each request
    is captured three times, 2 fit steps a tick, a gate every tick, 2
    shadow prompts), then its candidate checkpoint served through
    ``--g-ckpt`` as hyper_euler. Raises unless the progress lines carry
    the refinery's fields, a candidate checkpoint exists, it serves, and
    the flushed ledger loads."""
    import io
    import shutil
    ckpt = os.path.join(BUILD, "refine_ckpt")
    out_npz = os.path.join(BUILD, "refine_ledger.npz")
    shutil.rmtree(ckpt, ignore_errors=True)
    buf = io.StringIO()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = serve.main(["--arch", "qwen3_4b", "--batch", "20",
                          "--prompt-len", str(S), "--solver", "euler",
                          "--multirate", "--fused", "--buckets", "4,8",
                          "--seg", "1", "--max-batch", "2", "--inflight",
                          "--arrival-trace", "poisson", "--refine",
                          "--refine-dir", ckpt, "--refine-steps", "2",
                          "--shadow-every", "2", "--ledger-cap",
                          str(LEDGER_CAP), "--ledger-out", out_npz,
                          "--progress-every", "4"])
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    lines = buf.getvalue().splitlines()
    prog = [l for l in lines if l.startswith("[progress] ")]
    if not prog or not all(f" {k}=" in l for l in prog
                           for k in ("ledger", "cand_step", "promotions")):
        raise AssertionError(f"refine CLI: progress lines {prog[-2:]}")
    status = out["refinery"].status()
    step = CheckpointManager(ckpt).latest_step()
    if step is None:
        raise AssertionError(f"refine CLI: no checkpoint, {status}")
    if not all(r.status == "ok" for r in out["results"]):
        raise AssertionError("refine CLI: a request did not finish ok")
    rows = np.load(out_npz)["s"].shape[0]
    seconds = out["seconds"]
    del out
    torch.cuda.empty_cache()
    with contextlib.redirect_stdout(io.StringIO()):
        again = serve.main(["--arch", "qwen3_4b", "--batch", str(B),
                            "--prompt-len", str(S), "--solver",
                            "hyper_euler", "--g-ckpt", ckpt, "--multirate",
                            "--fused", "--buckets", BUCKETS])
    if not all(r.status == "ok" and np.isfinite(r.outputs).all()
               for r in again["results"]):
        raise AssertionError("--g-ckpt of the refinery's candidate failed")
    emit(phase="refinery_cli", arch="qwen3_4b", wall_s=wall,
         cli_seconds=seconds, status=status,
         checkpoint_step=step, ledger_rows_flushed=rows,
         last_progress=prog[-1], launches=launches,
         g_ckpt_serve=dict(K=[r.K for r in again["results"]],
                           seconds=again["seconds"]))
    del again
    torch.cuda.empty_cache()
    return launches


def phase_refinery_fp32(dev):
    """Convergence on the card, in float32 at 4 layers (Griffin 6), full
    width: a ledger captured in flight (16 prompts, K 4 at seg 1), then
    50 fit steps; the loss on a fixed batch after them is below the
    loss before the first (the on-card counterpart of
    tests/test_torch_refinery.py::test_trainer_converges_on_captured_residuals)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    report = {}
    for arch, n_layers in FP32_DECODE_LAYERS.items():
        cfg = dataclasses.replace(get(arch), n_layers=n_layers,
                                  dtype="float32", param_dtype="float32")
        params = init_lm(torch.Generator(device=dev).manual_seed(11), cfg,
                         device=dev)
        model = refinable_model(params, cfg)
        prompts = np.random.RandomState(12).randint(
            0, cfg.vocab, (INFLIGHT_REQUESTS, S)).astype(np.int32)
        ledger = ResidualLedger(model, capacity=LEDGER_CAP, seed=0)
        sched = InflightScheduler(model, EngineConfig(
            buckets=(4,), controller="fixed", fixed_K=4, fused=True),
            slots=SLOTS, seg=1, ledger=ledger)
        with torch.no_grad():
            replay_scheduler(sched, poisson_trace(prompts, rate=1.0,
                                                  seed=0))
        refin = Refinery(model, ledger, RefineryConfig(
            steps_per_tick=50, batch_size=32, min_fill=1, total_steps=50))
        b = ledger.sample_batch(32, np.random.RandomState(0))
        args = (b["s"], b["eps"], b["z"], b["dz"], b["R"])
        before = float(refin._eval_loss(refin.current, *args))
        _, ms = synced_ms(refin.train_tick)
        after = float(refin._eval_loss(refin.candidate, *args))
        if not after < before:
            raise AssertionError(f"{arch} fp32 fit: loss {before} -> "
                                 f"{after} after 50 steps")
        report[arch] = dict(layers=n_layers, fill=ledger.fill,
                            loss_before=before, loss_after_50=after,
                            fit_step_ms=ms / 50)
        del params, model, ledger, refin, sched
        torch.cuda.empty_cache()
    emit(phase="refinery_fp32", **report)


def split_threshold(errs):
    """(tol, flow_threshold) that route about half of ``errs`` to the K=0
    tier: tol just above the largest error (every ladder row at the
    smallest bucket), the threshold at the midpoint of the widest gap
    between the middle two quartiles, so no error sits near it."""
    e = np.sort(np.asarray(errs, np.float64))
    tol = float(e[-1]) * 1.05
    lo, hi = len(e) // 4, max(3 * len(e) // 4, len(e) // 4 + 1)
    gaps = e[lo + 1:hi + 1] - e[lo:hi]
    j = lo + int(np.argmax(gaps))
    return tol, float((e[j] + e[j + 1]) / 2.0) / tol


def phase_flow(dev, cfg, params, prompt, tol, ledger, via_cli=False):
    """A main path: the K=0 flow tier on a full-width model's serve-phase
    params (bf16). (1) ``train_flowhead`` fits a rank-64 head on the
    refinery phase's ledger (50 iterations, batch 16), saved and loaded
    back bit for bit. (2) The drain of the in-flight prompts with a
    threshold from this run's probe errors: some rows, not all, at K=0
    (nfe probe + 1, status ok), launches = block applications and packed
    ladder steps; flow_threshold 0 serves the serve phase's 8 prompts at
    its tol bit for bit as the flow-free model. (3) In flight, sync and
    overlap bit for bit. (4) A flow fault on a fixed uid set: those
    requests come back ``escalated`` (finite, K >= 2). (5) For qwen3_4b,
    the CLI's --flow-ckpt/--flow-threshold. Returns the launches."""
    tag = f"{cfg.name} flow"
    flow_apply = lambda fp, eps, s, z, dz: lm_flow_apply(fp, eps, s, z, dz)
    fp0 = lm_flow_init(torch.Generator(device=dev).manual_seed(21), cfg,
                       rank=FLOW_RANK, param_dtype=torch.float32,
                       device=dev)
    (fp, losses), fit_ms = synced_ms(lambda: train_flowhead(
        flow_apply, fp0, ledger, FlowTrainConfig(iters=FLOW_ITERS,
                                                 batch_size=FLOW_BATCH)))
    if not np.isfinite(losses).all():
        raise AssertionError(f"{tag}: fit losses {losses}")
    ckpt = os.path.join(BUILD, "flow_ckpt", cfg.name)
    CheckpointManager(ckpt).save(FLOW_ITERS, fp, wait=True)
    loaded = load_flow_params(ckpt, cfg, rank=FLOW_RANK, device=dev)
    if not all(torch.equal(loaded[k], fp[k]) for k in fp):
        raise AssertionError(f"{tag}: the saved head does not load back")

    prompts = inflight_prompts(cfg, prompt)
    plain = lm_depth_model(params, cfg, solver="euler", fused=True)
    with torch.no_grad():
        errs = MultiRateEngine(plain, embedded_ecfg(tol)).probe(prompts)[1]
    tol_f, thr = split_threshold(errs[:B])
    model = lm_depth_model(params, cfg, solver="euler", fused=True,
                           flow_params=loaded)
    ecfg = embedded_ecfg(tol_f, flow_threshold=thr)
    LAUNCHES.clear()
    with count_blocks() as blocks, torch.no_grad():
        eng = MultiRateEngine(model, ecfg)
        drain, drain_ms = synced_ms(lambda: eng.run(prompts))
    launches, blocks = dict(LAUNCHES), dict(blocks)
    flow = [r for r in drain if r.K == 0]
    n_flow = eng.last_report.flow_served
    if not (0 < n_flow < len(prompts)) or n_flow != len(flow):
        raise AssertionError(f"{tag}: {n_flow} of {len(prompts)} at K=0")
    if not all(r.status == "ok" and r.nfe == eng.nfe_flow
               and np.isfinite(r.outputs).all() for r in flow) \
            or not all(r.status == "ok" for r in drain):
        raise AssertionError(f"{tag}: a flow row is not ok at nfe "
                             f"{eng.nfe_flow}")
    ladder = [r for r in drain if r.K > 0]
    if launches.get("hyper_step", 0) != packed_k_max_sum(ladder, B):
        raise AssertionError(f"{tag}: hyper_step launched "
                             f"{launches.get('hyper_step', 0)}, ladder "
                             f"steps {packed_k_max_sum(ladder, B)}")
    check_block_launches(launches, blocks, tag)
    with torch.no_grad():
        off = MultiRateEngine(model, embedded_ecfg(tol)).run(prompt)
        ref = MultiRateEngine(plain, embedded_ecfg(tol)).run(prompt)
    if [(r.K, r.nfe) for r in off] != [(r.K, r.nfe) for r in ref] or \
            not all(np.array_equal(a.outputs, b.outputs)
                    for a, b in zip(off, ref)):
        raise AssertionError(f"{tag}: flow_threshold=0 moved the serve "
                             "phase's outputs")
    del off, ref

    # where the time goes: one flow eval against a ladder solve
    with torch.no_grad():
        x8 = prompt
        z0 = model.embed(x8)
        dz0 = model.field_of(x8)(0.0, z0)
        _, flow_ms = synced_ms(lambda: model.flow_apply(
            loaded, 1.0, 0.0, z0, dz0))
        _, flow_readout_ms = synced_ms(lambda: eng._flow(x8, z0, dz0))
        Ks = torch.full((len(x8),), 2, dtype=torch.int32, device=dev)
        _, solve2_ms = synced_ms(lambda: model.integ.solve_multirate(
            model.field_of(x8), z0, model.span, Ks, 2, first_stage=dz0))
        Ks = torch.full((len(x8),), 8, dtype=torch.int32, device=dev)
        _, solve8_ms = synced_ms(lambda: model.integ.solve_multirate(
            model.field_of(x8), z0, model.span, Ks, 8, first_stage=dz0))
        del z0, dz0

    LAUNCHES.clear()
    with count_blocks() as blocks2:
        sync_s, sync_rep, sync_wall = replay(model, ecfg, prompts)
        over_s, over_rep, over_wall = replay(model, ecfg, prompts,
                                             overlap=True)
    for k, v in LAUNCHES.items():
        launches[k] = launches.get(k, 0) + v
    check_block_launches(dict(LAUNCHES), dict(blocks2), f"{tag} inflight")
    if not records_equal(sync_rep, over_rep):
        raise AssertionError(f"{tag}: sync and overlap differ")
    inflight_flow = sync_s.total_flow_served
    if not 0 < inflight_flow < len(prompts):
        raise AssertionError(f"{tag}: in flight {inflight_flow} at K=0")

    # the fault's uid set: the in-flight flow uids whose hash under the
    # first seed that selects any falls below FLOW_NAN_FRAC
    flow_uids = {r.uid for r in sync_rep.records if r.K == 0}
    seed = next(sd for sd in range(64) if any(
        _hash01(sd, "flow", u) < FLOW_NAN_FRAC for u in flow_uids))
    poisoned = {u for u in flow_uids
                if _hash01(seed, "flow", u) < FLOW_NAN_FRAC}
    inj = FaultInjector(seed=seed, flow_nan_frac=FLOW_NAN_FRAC)
    esc_s, esc_rep, _ = replay(model, ecfg, prompts, fault_injector=inj)
    got = {r.uid: r for r in esc_rep.records}
    bad = [u for u in poisoned if got[u].status != "escalated"
           or got[u].K < 2 or not np.isfinite(got[u].outputs).all()]
    if not poisoned or bad or esc_s.total_escalated != len(poisoned):
        raise AssertionError(f"{tag}: poisoned {sorted(poisoned)}, not "
                             f"escalated cleanly {bad}")

    cli = None
    if via_cli:
        import io
        with contextlib.redirect_stdout(io.StringIO()):
            out = serve.main(["--arch", cfg.name, "--batch", str(B),
                              "--prompt-len", str(S), "--solver", "euler",
                              "--multirate", "--fused", "--buckets",
                              BUCKETS, "--tol", repr(tol_f),
                              "--flow-ckpt", ckpt, "--flow-rank",
                              str(FLOW_RANK), "--flow-threshold",
                              repr(thr)])
        res = out["results"]
        n_cli = sum(r.K == 0 for r in res)
        if not 0 < n_cli < len(res) or not all(r.status == "ok"
                                               for r in res):
            raise AssertionError(f"flow CLI: {n_cli} of {len(res)} at K=0")
        cli = dict(flow_served=n_cli, seconds=out["seconds"],
                   K=[r.K for r in res])
        del out, res
    emit(phase="flow", arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, rank=FLOW_RANK,
         fit=dict(iters=FLOW_ITERS, batch=FLOW_BATCH, ms=fit_ms,
                  ms_per_iter=fit_ms / FLOW_ITERS, first_loss=losses[0],
                  last_loss=losses[-1]),
         tol=tol_f, flow_threshold=thr,
         drain=dict(requests=len(prompts), flow_served=n_flow,
                    flow_share=n_flow / len(prompts), ms=drain_ms,
                    K=[r.K for r in drain], nfe_flow=eng.nfe_flow),
         flow_eval_ms=flow_ms, flow_eval_and_readout_ms=flow_readout_ms,
         solve_ms=dict(k2=solve2_ms, k8=solve8_ms),
         inflight=dict(flow_served=inflight_flow, wall_s=dict(
             sync=sync_wall, overlap=over_wall),
             segments=sync_s.dispatches),
         escalation=dict(seed=seed, poisoned=sorted(poisoned),
                         escalated=esc_s.total_escalated),
         launches=launches, block_applications=dict(blocks),
         cli=cli)
    del eng, drain, sync_rep, over_rep, esc_rep, model
    torch.cuda.empty_cache()
    return launches


def expected_decode_launches(cfg, gen):
    """Kernel launches of one generate: the prefill runs flash_attention
    once per attention block and rglru_scan once per recurrent block
    (decode attention and the RG-LRU decode step are plain, as in the
    reference); rwkv6_scan runs once per rwkv block in the prefill and in
    each of the gen - 1 decode steps; no solver step."""
    pattern, n_groups, tail = lm.group_layout(cfg)
    kinds = collections.Counter(pattern * n_groups + pattern[:tail])
    return {"flash_attention": kinds["dense"] + kinds["attn"],
            "rglru_scan": kinds["rec"], "rwkv6_scan": kinds["rwkv"] * gen,
            "hyper_step": 0}


@contextlib.contextmanager
def lost_cache_writes():
    """A planted fault for the teacher-forced decode check: every
    ``block_decode`` leaves its block's cache as it found it, so later
    tokens see neither a generated token's k, v and conv rows nor the
    recurrent state it reached (the prefill's writes stay). The check
    must read this fault above its limit."""
    orig = lm.block_decode

    def faulty(p, cfg, kind, h, cache, cur_index):
        saved = {k: v.clone() for k, v in cache.items()}
        out = orig(p, cfg, kind, h, cache, cur_index)
        for k, v in saved.items():
            cache[k].copy_(v)
        return out

    lm.block_decode = faulty
    try:
        yield
    finally:
        lm.block_decode = orig


def generate_logits(params, cfg, prompt, gen, w):
    """``greedy_generate``'s steps with their logits kept: the prefill,
    then gen - 1 greedy decode steps. Returns (logits (B, gen, V) float32,
    tokens (B, gen), prefill ms, decode ms per token), each time on the
    host clock around synchronised work."""
    caches = lm.init_lm_cache(cfg, prompt.shape[0], prompt.shape[1] + gen,
                              device=prompt.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = lm.lm_prefill(params, cfg, prompt, caches, readout_w=w)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    out, toks = [logits], [logits.argmax(-1)]
    t0 = time.perf_counter()
    for t in range(prompt.shape[1], prompt.shape[1] + gen - 1):
        logits, caches = lm.lm_decode_step(params, cfg, toks[-1], caches, t,
                                           readout_w=w)
        out.append(logits)
        toks.append(logits.argmax(-1))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (gen - 1)
    return (torch.stack(out, dim=1), torch.stack(toks, dim=1), prefill_ms,
            step_ms)


def forward_logits(params, cfg, tokens, start, w):
    """The readout of ``lm_forward``'s hidden states from position
    ``start`` on (the same function as ``lm_forward(tokens)[0][:,
    start:]``, with the readout at the shape the decode path uses)."""
    h = lm._blocks(params, cfg, lm._embed(params, cfg, tokens))
    return lm._readout(params, cfg, h[:, start:], w)


def teacher_forced_err(params, cfg, prompt, logits, toks, w):
    """Largest |decode logit - teacher-forced logit| over the largest
    |teacher-forced logit|: the forward runs the prompt and every
    generated token but the last, and its positions P-1.. are the
    logits the generate produced at each step."""
    seq = torch.cat([prompt, toks[:, :-1].to(prompt.dtype)], dim=1)
    full = forward_logits(params, cfg, seq, prompt.shape[1] - 1, w)
    return float((logits - full).abs().max() / full.abs().max())


def check_decode(params, cfg, prompt, logits, toks, w, tol):
    """Holds a generate's logits to the teacher-forced forward within
    ``tol`` of the largest |logit|, and the same generate under
    ``lost_cache_writes`` above it; raises unless both hold."""
    err = teacher_forced_err(params, cfg, prompt, logits, toks, w)
    with lost_cache_writes():
        f_logits, f_toks, _, _ = generate_logits(params, cfg, prompt,
                                                 toks.shape[1], w)
    fault = teacher_forced_err(params, cfg, prompt, f_logits, f_toks, w)
    if not err <= tol < fault:
        raise AssertionError(
            f"{cfg.name} {cfg.dtype}: teacher-forced decode error {err}, "
            f"planted fault {fault}, limit {tol} of the largest |logit|")
    return dict(teacher_forced_rel_err=err, planted_fault_rel_err=fault,
                limit=tol)


def decode_breakdown(params, cfg, prompt, gen, dev):
    """The generate's pieces, run again outside the counted window
    (``generate_logits``): prefill ms, raising unless its logits equal the
    readout of ``lm_forward``'s hidden states at the last position bit for
    bit; decode ms per token, raising unless every logit is finite; the
    bf16 decode logits held to a teacher-forced forward (``check_decode``,
    the model's ``BF16_DECODE_TOL``); and one step's float32 readout
    (median of CUDA-event timings)."""
    dt = lm.dtype_of(cfg.dtype)
    toks = torch.as_tensor(prompt, device=dev)
    with torch.no_grad():
        w = lm.readout_weight(params, cfg, dt)
        logits, gen_toks, prefill_ms, step_ms = generate_logits(
            params, cfg, toks, gen, w)
        last = forward_logits(params, cfg, toks, -1, w)[:, 0]
        if not torch.equal(logits[:, 0], last):
            diff = float((logits[:, 0] - last).abs().max())
            raise AssertionError(
                f"{cfg.name}: prefill logits differ from lm_forward's last "
                f"position (max abs {diff})")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{cfg.name}: non-finite decode logits")
        checked = check_decode(params, cfg, toks, logits, gen_toks, w,
                               BF16_DECODE_TOL[cfg.name])
        del logits
        h = torch.randn((toks.shape[0], 1, cfg.d_model), device=dev).to(dt)
        times = []
        for _ in range(20):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            lm._readout(params, cfg, h, w)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    del w
    return dict(prefill_ms=prefill_ms, decode_ms_per_token=step_ms,
                readout_ms_per_step=float(np.median(times[5:])), **checked)


def phase_decode(dev, bandwidth, cfg, run):
    """A main path: the cached greedy decode of a full-width model, bf16,
    8 prompts of 128 tokens, 32 generated tokens. ``run()`` drives the
    generate through an entry point a user calls and returns (tokens,
    seconds, params, prompt); its kernel launches are counted and must be
    exactly ``expected_decode_launches``. Then ``decode_breakdown`` times
    the pieces and holds the prefill and the decode logits to the
    forward. The bound per token is the weights' bytes (2 B a parameter,
    each read once a step) over the card's memory rate."""
    torch.cuda.reset_peak_memory_stats(dev)
    LAUNCHES.clear()
    toks, seconds, params, prompt = run()
    launches = dict(LAUNCHES)
    expected = expected_decode_launches(cfg, GEN)
    got = {k: launches.get(k, 0) for k in expected}
    if got != expected:
        raise AssertionError(f"{cfg.name} decode: launches {got}, "
                             f"expected {expected}")
    toks = np.asarray(toks)
    if toks.shape != (B, GEN) or toks.min() < 0 or toks.max() >= cfg.vocab:
        raise AssertionError(f"{cfg.name} decode: tokens {toks.shape} out "
                             f"of range [0, {cfg.vocab})")
    pieces = decode_breakdown(params, cfg, prompt, GEN, dev)
    n_params = lm.count_params(params)
    emit(phase="decode", arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, batch=B, prompt_len=S,
         gen=GEN, seconds=seconds, tok_per_s=B * GEN / seconds,
         launches=launches, expected_launches=expected, **pieces,
         params=n_params,
         weight_bytes_bound_ms_per_token=2 * n_params / bandwidth * 1e3,
         peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         sample=toks[0, :8].tolist())
    return launches


def phase_decode_qwen(dev, bandwidth):
    """Full-width qwen3_4b through the serving CLI with no --solver: the
    default, the cached decode path."""
    def run():
        out = serve.main(["--arch", "qwen3_4b", "--batch", str(B),
                          "--prompt-len", str(S), "--gen", str(GEN)])
        return out["tokens"], out["seconds"], out["params"], out["prompt"]
    launches = phase_decode(dev, bandwidth, get("qwen3_4b"), run)
    torch.cuda.empty_cache()
    return launches


def phase_decode_served(dev, bandwidth, arch, params, prompt):
    """Full-width ``arch`` through ``engine.greedy_generate`` on the params
    and prompt its serve phase returned (no second weight init)."""
    def run():
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = greedy_generate(params, get(arch), prompt, GEN)
            torch.cuda.synchronize()
        return toks.cpu(), time.perf_counter() - t0, params, prompt
    launches = phase_decode(dev, bandwidth, get(arch), run)
    torch.cuda.empty_cache()
    return launches


def phase_decode_fp32(dev):
    """Full width in float32 (TF32 off) at ``FP32_DECODE_LAYERS``, 8
    prompts of 128 tokens, 32 generated: the port's prefill-plus-decode
    logits against a teacher-forced forward of the prompt and the
    generated tokens, within ``FP32_DECODE_TOL`` of the largest |logit|,
    and ``lost_cache_writes`` above it
    (``check_decode``; the on-card counterpart of
    tests/test_torch_decode.py::test_decode_matches_forward)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    report = {}
    for arch, n_layers in FP32_DECODE_LAYERS.items():
        cfg = dataclasses.replace(get(arch), n_layers=n_layers,
                                  dtype="float32", param_dtype="float32")
        params = init_lm(torch.Generator(device=dev).manual_seed(7), cfg,
                         device=dev)
        prompt = torch.as_tensor(np.random.RandomState(8).randint(
            0, cfg.vocab, (B, S)), device=dev)
        with torch.no_grad():
            w = lm.readout_weight(params, cfg, torch.float32)
            logits, toks, _, _ = generate_logits(params, cfg, prompt, GEN, w)
            report[arch] = dict(layers=n_layers, **check_decode(
                params, cfg, prompt, logits, toks, w, FP32_DECODE_TOL))
        del params, w, logits
        torch.cuda.empty_cache()
    emit(phase="decode_fp32", batch=B, prompt_len=S, gen=GEN, **report)


# ------------------------------------------------------ image classifiers ----
# The paper's Sec. 4.1 experiment (benchmarks/common.py and
# bench_pareto.py in the reference) on the port, float32 at the paper's
# widths on synthetic images: train the Neural ODE (AdamW 2e-3, batch 8,
# RK4 at K 8, clip 1.0, 256 images of seed 1), fit HyperEuler at K 10 by
# residual fitting on dopri5 trajectories (atol = rtol = 1e-4, batches of
# 16 from 256 images of seed 4), take the dopri5 reference at 1e-5 on 64
# test images (seed 9), and sweep the solvers over K, each solve unfused
# and fused. MNIST at the bench's "small" budget; CIFAR at a smaller one.
IMAGE_BUDGETS = {
    "mnist": dict(train_steps=60, fit_iters=120, Ks=(2, 4, 8, 10, 20),
                  solvers=("euler", "hyper_euler", "midpoint", "rk4")),
    "cifar": dict(train_steps=20, fit_iters=60, Ks=(2, 10),
                  solvers=("euler", "hyper_euler")),
}
IMAGE_FIT_K, IMAGE_TEST, IMAGE_TIMED = 10, 64, (64, 1024)
# fused against unfused, a share of max |zT|: the kernel combines the
# stages as z + (eps*b_j)*r_j in turn and rounds eps^{p+1} in float32,
# the unfused step as z + eps*(sum_j b_j*r_j); a step differs by a few
# float32 ulps of |z| (~2^-22 relative), so 20 steps through a field of
# Lipschitz constant ~1 on s in [0, 1] stay well inside 1e-5
FUSED_TOL = 1e-5


def image_family(name: str) -> dict:
    """The port's model functions of one family, with the MACs of f and g
    per field evaluation (CIFAR's from the App. C.2 layer list, which the
    reference gives no formula for)."""
    cm = conv_node.conv_macs
    if name == "mnist":
        return dict(kind="mnist28", node=conv_node.mnist_node,
                    g_init=conv_node.init_mnist_hyper,
                    g_apply=conv_node.mnist_g_apply,
                    integrator=conv_node.mnist_integrator,
                    f_macs=conv_node.mnist_f_macs(),
                    g_macs=conv_node.mnist_g_macs())
    return dict(kind="cifar32", node=conv_node.cifar_node,
                g_init=conv_node.init_cifar_hyper,
                g_apply=conv_node.cifar_g_apply,
                integrator=conv_node.cifar_integrator,
                f_macs=cm(32, 32, 9, 64, 3) + cm(32, 32, 65, 64, 3)
                + cm(32, 32, 64, 8, 3),
                g_macs=cm(32, 32, 17, 64, 5) + cm(32, 32, 64, 32, 5)
                + cm(32, 32, 32, 8, 3))


def train_image_node(node, params, xs, ys, steps, batch=8, seed=2):
    """The bench's ``train_image_node``: AdamW(2e-3) steps on random
    batches through RK4 at K 8, gradients clipped to global norm 1.0.
    Returns (params, losses, ms a step)."""
    rk4 = get_tableau("rk4")

    def loss_fn(p, xb, yb):
        return torch.nn.functional.cross_entropy(
            node.forward_fixed(p, xb, rk4, 8), yb)

    opt = adamw(2e-3)
    step, st = make_fit_step(loss_fn, opt, 1.0), opt.init(params)
    rng = np.random.RandomState(seed)

    def run(params, st):
        losses = []
        for i in range(steps):
            idx = torch.from_numpy(rng.randint(0, xs.shape[0], batch)).to(
                xs.device)
            params, st, loss = step(params, st, i, xs[idx], ys[idx])
            losses.append(loss)
        return params, losses

    (params, losses), ms = synced_ms(lambda: run(params, st))
    return params, [float(l) for l in losses], ms / steps


def fit_image_hypersolver(fam, node, params, xs, iters, seed=5):
    """The bench's ``fit_image_hypersolver``: ``train_hypersolver`` at K
    10 from a zero-readout g, batches of 16 drawn from ``xs``. Returns (g
    params, losses, ms an iteration, the first batch)."""
    gp = fam["g_init"](torch.Generator(device=xs.device).manual_seed(3),
                       xs.device)
    rng = np.random.RandomState(seed)
    drawn = []

    def batches():
        while True:
            drawn.append(xs[torch.from_numpy(
                rng.randint(0, xs.shape[0], 16)).to(xs.device)])
            yield drawn[-1]

    cfg = HypersolverTrainConfig(
        base_solver="euler", K=IMAGE_FIT_K, iters=iters, pretrain_iters=10,
        swap_every=20, lr=1e-2, lr_min=5e-4, weight_decay=1e-6, atol=1e-4,
        rtol=1e-4)
    (gp, losses), ms = synced_ms(lambda: train_hypersolver(
        node, params, fam["g_apply"], gp, batches(), cfg))
    return gp, losses, ms / iters, drawn[0]


def reference_state(node, params, x, tol=1e-5):
    """The bench's ``reference_state``: dopri5's terminal state over the
    whole span (K 1) at atol = rtol = ``tol``, and its NFE."""
    traj, _, nfe = node.reference_trajectory(params, x, K=1, atol=tol,
                                             rtol=tol)
    return traj[-1], nfe


def image_integrator(fam, name, gp, x, fused):
    if name.startswith("hyper_"):
        return fam["integrator"](gp, x, base=name.split("_", 1)[1],
                                 fused=fused)
    return fam["integrator"](base=get_tableau(name), fused=fused)


def eval_solver(fam, node, params, name, K, x, z_ref, gp=None, fused=False):
    """The bench's ``eval_solver`` (with the fused path as an option):
    (terminal state, MAPE % against ``z_ref``, NFE)."""
    integ = image_integrator(fam, name, gp, x, fused)
    zT = integ.solve(node.field(params, x), node.hx_apply(params, x),
                     FixedGrid.over(0.0, 1.0, K), return_traj=False)
    mape = float(torch.mean(torch.abs(zT - z_ref)
                            / (torch.abs(z_ref) + 1e-3))) * 100
    return zT, mape, integ.nfe(K)


def accuracy_drop(node, params, zT, z_ref):
    """The bench's task metric: disagreement (%) with the prediction of
    the dopri5 state."""
    agree = float(torch.mean((torch.argmax(node.hy_apply(params, zT), -1)
                              == torch.argmax(node.hy_apply(params, z_ref),
                                              -1)).float()))
    return (1.0 - agree) * 100


def pareto_rows(fam, node, params, gp, x, z_ref, Ks, solvers):
    """The pareto sweep: every (K, solver) solved unfused and fused, with
    MAPE, accuracy drop, NFE, GMAC by the bench's formula, the fused
    solve's largest difference from the unfused one and the hyper_step
    launches it made."""
    rows = []
    for K in Ks:
        for name in solvers:
            row = dict(solver=name, K=K)
            for fused in (False, True):
                before = LAUNCHES["hyper_step"]
                zT, mape, nfe = eval_solver(fam, node, params, name, K, x,
                                            z_ref, gp, fused)
                tag = "fused" if fused else "unfused"
                row[f"mape_{tag}"] = mape
                row[f"acc_drop_{tag}"] = accuracy_drop(node, params, zT,
                                                       z_ref)
                if fused:
                    row["launches"] = LAUNCHES["hyper_step"] - before
                    row["fused_diff"] = float((zT - z_plain).abs().max())
                    row["max_abs_z"] = float(z_plain.abs().max())
                z_plain = zT
            row["nfe"] = nfe
            row["gmac"] = (nfe * fam["f_macs"] + (
                K * fam["g_macs"] if name.startswith("hyper_") else 0)) / 1e9
            rows.append(row)
    return rows


def check_image(name, train_losses, fit_losses, rows):
    """Raises unless training's loss fell (the mean of the last 10 steps
    below the first 10's) and the fit's last loss is below its first,
    and every solve had finite MAPEs, a fused state within FUSED_TOL of
    max |zT| of the unfused one and exactly K hyper_step launches; on
    MNIST also unless HyperEuler's MAPE at K 10, the mesh it was fitted
    on, is below Euler's there (paper Fig. 3)."""
    if not np.mean(train_losses[-10:]) < np.mean(train_losses[:10]):
        raise AssertionError(f"{name}: training loss did not fall "
                             f"{train_losses[:10]} .. {train_losses[-10:]}")
    if not fit_losses[-1] < fit_losses[0]:
        raise AssertionError(f"{name}: fit loss {fit_losses[0]} -> "
                             f"{fit_losses[-1]}")
    for r in rows:
        if not np.isfinite([r["mape_fused"], r["mape_unfused"]]).all():
            raise AssertionError(f"{name}: non-finite MAPE {r}")
        if r["fused_diff"] > FUSED_TOL * r["max_abs_z"]:
            raise AssertionError(f"{name}: fused differs from unfused {r}")
        if r["launches"] != r["K"]:
            raise AssertionError(f"{name}: {r['launches']} hyper_step "
                                 f"launches for K {r['K']} ({r['solver']})")
    if name == "mnist":
        at = {r["solver"]: r for r in rows if r["K"] == IMAGE_FIT_K}
        for tag in ("unfused", "fused"):
            if not (at["hyper_euler"][f"mape_{tag}"]
                    < at["euler"][f"mape_{tag}"]):
                raise AssertionError(f"mnist: HyperEuler does not beat "
                                     f"Euler at K {IMAGE_FIT_K} ({tag})")


def image_pipeline(dev, name, budget):
    """One family through train, fit, reference and sweep (the main
    path, launches counted from 0), then the timings. Returns (report,
    launches)."""
    fam = image_family(name)
    LAUNCHES.clear()
    node, params = fam["node"](torch.Generator(device=dev).manual_seed(0),
                               dev)
    xs, ys = synthetic_images(fam["kind"], 256, seed=1, device=dev)
    params, train_losses, train_ms = train_image_node(
        node, params, xs, ys, budget["train_steps"])
    x_fit, _ = synthetic_images(fam["kind"], 256, seed=4, device=dev)
    gp, fit_losses, fit_ms, first = fit_image_hypersolver(
        fam, node, params, x_fit, budget["fit_iters"])
    xt, _ = synthetic_images(fam["kind"], IMAGE_TEST, seed=9, device=dev)
    with torch.no_grad():
        with count_syncs() as where:
            z_ref, ref_nfe = reference_state(node, params, xt)
        ref = dict(tol=1e-5, K=1, nfe=ref_nfe, host_syncs=sum(where.values()),
                   by_line=dict(where.most_common(4)))
        with count_syncs() as where:
            _, _, fit_nfe = node.reference_trajectory(
                params, first, IMAGE_FIT_K, atol=1e-4, rtol=1e-4)
        fit_ref = dict(tol=1e-4, K=IMAGE_FIT_K, batch=16, nfe=fit_nfe,
                       host_syncs=sum(where.values()),
                       by_line=dict(where.most_common(4)))
        rows = pareto_rows(fam, node, params, gp, xt, z_ref, budget["Ks"],
                           budget["solvers"])
        launches = dict(LAUNCHES)
        check_image(name, train_losses, fit_losses, rows)
        timed, solve_syncs = {}, {}
        for n in IMAGE_TIMED:
            x = xt.repeat((n // IMAGE_TEST, 1, 1, 1))
            f, z0 = node.field(params, x), node.hx_apply(params, x)
            grid = FixedGrid.over(0.0, 1.0, IMAGE_FIT_K)
            for fused in (False, True):
                integ = image_integrator(fam, "hyper_euler", gp, x, fused)
                tag = f"{'fused' if fused else 'unfused'}_{n}"
                with count_syncs() as where:       # also the warm-up
                    integ.solve(f, z0, grid, return_traj=False)
                solve_syncs[tag] = sum(where.values())
                timed[tag] = float(np.median([synced_ms(
                    lambda: integ.solve(f, z0, grid, return_traj=False))[1]
                    for _ in range(5)]))
    report = dict(train=dict(steps=budget["train_steps"], ms_per_step=train_ms,
                             loss_first10=float(np.mean(train_losses[:10])),
                             loss_last10=float(np.mean(train_losses[-10:]))),
                  fit=dict(iters=budget["fit_iters"], K=IMAGE_FIT_K,
                           ms_per_iter=fit_ms, loss_first=fit_losses[0],
                           loss_last=fit_losses[-1]),
                  dopri5_test=ref, dopri5_fit=fit_ref, pareto=rows,
                  hyper_euler_K10_solve_ms=timed,
                  hyper_euler_K10_solve_host_syncs=solve_syncs,
                  launches=launches)
    return report, launches


def phase_image(dev):
    """A main path: the paper's image-classification pipeline for both
    families (``image_pipeline``), every fused solve step through
    hyper_step. Returns the launches of the two sweeps."""
    torch.cuda.reset_peak_memory_stats(dev)
    launches = collections.Counter()
    report = {}
    for name, budget in IMAGE_BUDGETS.items():
        report[name], counted = image_pipeline(dev, name, budget)
        launches.update(counted)
    emit(phase="image", dtype="float32", test_images=IMAGE_TEST,
         fused_tol=FUSED_TOL, **report,
         peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit(phase="device", torch=torch.__version__, cuda=torch.version.cuda,
         name=name, count=torch.cuda.device_count(), nvidia_smi=smi)
    print(smi, flush=True)

    t0 = time.perf_counter()
    libs = _build.build_all()
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries={k: os.path.relpath(v, ROOT) for k, v in libs.items()},
         ptxas={k: [l.strip() for l in v.splitlines() if "Used" in l
                    or "spill" in l or "Compiling entry" in l]
                for k, v in _build.BUILD_LOG.items()},
         hmma=hmma_counts(libs))

    bandwidth = memory_bandwidth(name)
    rows, max_err = phase_kernels(dev, bandwidth)
    flash_rows = phase_flash(dev, bandwidth)
    rglru_rows = phase_rglru(dev, bandwidth)
    rwkv6_rows = phase_rwkv6(dev, bandwidth)
    launches = phase_image(dev)
    served, params, prompt, tol = phase_serve(dev)
    launches.update(served)
    launches.update(phase_inflight(dev, get("qwen3_4b"), params, prompt, tol,
                                   via_cli=True))
    refined, ledger = phase_refinery(dev, get("qwen3_4b"), params, prompt,
                                     tol)
    launches.update(refined)
    launches.update(phase_flow(dev, get("qwen3_4b"), params, prompt, tol,
                               ledger, via_cli=True))
    del params, ledger
    torch.cuda.empty_cache()
    launches.update(phase_refinery_cli(dev))
    torch.cuda.empty_cache()
    launches.update(phase_decode_qwen(dev, bandwidth))
    for arch, phase in (("recurrentgemma_2b", phase_serve_griffin),
                        ("rwkv6_1p6b", phase_serve_rwkv6)):
        served, params, prompt, tol = phase(dev)
        launches.update(served)
        launches.update(phase_inflight(dev, get(arch), params, prompt, tol))
        refined, ledger = phase_refinery(dev, get(arch), params, prompt, tol)
        launches.update(refined)
        launches.update(phase_flow(dev, get(arch), params, prompt, tol,
                                   ledger))
        del ledger
        launches.update(phase_decode_served(dev, bandwidth, arch, params,
                                            prompt))
        del params
    phase_fused_vs_unfused(dev)
    phase_decode_fp32(dev)
    phase_refinery_fp32(dev)

    head = next(r for r in rows if r["case"] == "euler+g"
                and r["dtype"] == "bfloat16")
    flash = next(r for r in flash_rows if r["case"] == "griffin")
    rglru = next(r for r in rglru_rows if r["case"] == "serve")
    rwkv6 = next(r for r in rwkv6_rows if r["case"] == "serve")
    src = "src/repro_torch/kernels/{0}/csrc/{0}.cu"
    emit(kernels=[
        dict(name="hyper_step", route="cuda", source=src.format("hyper_step"),
             replaces="src/repro/kernels/hyper_step/hyper_step.py:89",
             launches=launches["hyper_step"], max_abs_err=max_err,
             ms=head["ms"], plain_ms=head["plain_ms"],
             bound_ms=head["bound_ms"], bound_by=head["bound_by"],
             library_ms=None),
        dict(name="flash_attention", route="cuda",
             source=src.format("flash_attention"),
             replaces="src/repro/kernels/flash_attention/flash_attention.py:96",
             launches=launches["flash_attention"],
             max_abs_err=max(r["max_abs_err"] for r in flash_rows),
             ms=flash["ms"], plain_ms=flash["plain_ms"],
             bound_ms=flash["bound_ms"], bound_by=flash["bound_by"],
             library_ms=flash["library_ms"]),
        dict(name="rglru_scan", route="cuda", source=src.format("rglru_scan"),
             replaces="src/repro/kernels/rglru_scan/rglru_scan.py:58",
             launches=launches["rglru_scan"],
             max_abs_err=max(r["max_abs_err"] for r in rglru_rows),
             ms=rglru["ms"], plain_ms=rglru["plain_ms"],
             bound_ms=rglru["bound_ms"], bound_by=rglru["bound_by"],
             library_ms=None),
        dict(name="rwkv6_scan", route="cuda", source=src.format("rwkv6_scan"),
             replaces="src/repro/kernels/rwkv6_scan/rwkv6_scan.py:71",
             launches=launches["rwkv6_scan"],
             max_abs_err=max(r["max_abs_err"] for r in rwkv6_rows),
             ms=rwkv6["ms"], plain_ms=rwkv6["plain_ms"],
             bound_ms=rwkv6["bound_ms"], bound_by=rwkv6["bound_by"],
             library_ms=None)])
    emit(ok=True, device=dict(platform="gpu", kind=name,
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
