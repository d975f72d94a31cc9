"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Builds the six CUDA kernels (``hyper_step``, ``flash_attention``,
``rglru_scan``, ``rwkv6_scan`` of the serving paths, and the scans'
gradients ``rglru_scan_backward`` and ``rwkv6_scan_backward`` of the
training path) from the sources in the checkout, one nvcc process each,
all started together; holds each kernel against its plain PyTorch
version at the serving (or training) shapes and at the edges of its
design (``hs_cases``, ``FLASH_CASES``, ``RGLRU_CASES``, ``RWKV6_CASES``,
``RGLRU_BACKWARD_CASES``, ``RWKV6_BACKWARD_CASES``) and times both
cold-L2 (``time_ms``; flash attention also beside
``scaled_dot_product_attention`` as a yardstick the port never calls);
serves full-width ``qwen3_4b`` (36
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
After qwen3_4b's in-flight phase, the roofline clock (``phase_roofline``:
``RooflineOracle`` at ctx 128 on the cost model's H100 record, raising
unless the card is the one the record names): the drain engine on both
clocks bit for bit, the in-flight sync and overlap loops on a Poisson
trace at 0.25 per field evaluation of the pool with K and useful steps
equal to ``phase_inflight``'s and every segment timed by CUDA events, and
the serving CLI with ``--cost-oracle roofline`` in its own process (exit
0, device_us). At the very end, ``report_roofline`` prints the
``roofline_vs_measured`` line: that segment, each decode phase's ms a
token and each train phase's ms a step beside the cost model's
prediction for its cell and the dominant term, raising if any measured
time is below 0.9 of its prediction.
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
HyperEuler beating Euler at K 10 on MNIST checked. Then the paper's CNF
density sampling (``phase_cnf``: ``benchmarks/bench_cnf.py``'s protocol)
on pinwheel and rings, float32 at the paper's widths: train the CNF by
NLL through RK4, fit HyperHeun at K 1 on dopri5 trajectories, and sample
1,024 base draws with dopri5 (lock-step and per-sample batched) and with
HyperHeun, Heun and Euler at 2 NFE, unfused and fused, with the losses
falling, fused equal to unfused, hyper_step launched exactly 2 x K times
a fused sample, HyperHeun's displacement below Heun's and Euler's, and
the batched dopri5 agreeing with the lock-step one checked; and the
trajectory-fitting tracker (``phase_tracking``:
``benchmarks/bench_trajectory.py``'s protocol), with HyperEuler beating
Euler at K 16 and fused equal to unfused with K launches checked.
After the three dense families, full-width ``olmoe_1b_7b`` (16 moe
layers, 64 experts top-8, ~13.8 GB in bf16; ``phase_serve_olmoe``):
served through the CLI and the engine with hyper_euler, in flight, and
decoded through the CLI's default, its decode held to a chain of decode
steps (expert routing is not row independent, so a forward is another
function), each dispatch's dropped fraction printed; then
``phase_cdepth_lm`` (``benchmarks/bench_cdepth_lm.py``'s protocol):
a reduced LM trained by ``lm_loss``, a HyperEuler g fitted per K by
``cdepth_residual_loss``, hyper_euler's KL below euler's checked, and
the K 4 g saved, restored and served by the engine.
Then the repo's two largest architectures at full width with their depth
cut (``phase_nemotron``: ``nemotron_4_340b`` at 4 of 96 layers, every
attention through the flash kernel at head width 192; ``phase_llama4``:
``llama4_maverick_400b_a17b`` at 2 of 48, one dense and one MoE block of
128 experts at top-1 and a shared expert), each served through the
engine as the CLI serves and with hyper_euler, every window's launches
counted, then decoded and held to its teacher-forced limit.
The reference's performance options on one card: after qwen3_4b's flow
phase, ``phase_kv_int8`` (8 prompts of 4,096 tokens and 32 generated,
the bf16 cache greedy and ``set_perf_options(kv_int8=True)``
teacher-forced on its tokens: int8 k, v and float32 scales in at most
0.52 of the bf16 cache's bytes, one flash launch per layer in the int8
prefill, every step's logits within ``KV_INT8_TOL`` of the bf16 cache's
and a planted fault (the new token's scales lost) above it) and
``phase_chunking`` (the same prefill under
``set_attention_chunking(512)``, logits ``torch.equal`` and the same
flash launches); after olmoe_1b_7b's in-flight phase, on its params,
``phase_moe_int8`` (``int8_dispatch`` on one block within the
reference's 0.05 bound with routing unchanged, the forward and a
fixed-K drain within ``MOE_INT8_TOL`` and a planted fault (the payload
dequantized with scale 1) above it, the same launches both ways) and
``phase_train_8bit`` (full-width OLMoE trained four steps with
``adamw8bit``'s in-place update: finite losses, moved params, int8
moments of the reckoned size, and on one step's full-width gradients
the in-place update bit for bit the functional one on the expert ``wi``
stack and ``compress_with_feedback`` exact to float32 rounding).
Then ``phase_paligemma``: full-width ``paligemma_3b`` with its patch
frontend (8 requests of 256 patch embeddings and 128 text tokens) through
the prefill step, the continuous-depth scorer at K 3, 6, 9 and 18 (euler
and hyper_euler, fused and unfused, launches exact, fused against
unfused, and equal in float32 at 4 layers), the serving CLI's text-only
cached decode and five train steps; and ``phase_whisper``: full-width
``whisper_base`` on frames (8, 1500, 512) through the prefill step
(``encode`` + ``decode_train``), 32 cached decode steps held to
teacher forcing with a planted fault (another request's cross K/V)
above the limit, five ``train_loop`` steps and a float32 step against
the all-plain model, then the serving CLI's continuous-depth drain and
cached decode of the decoder-only LM with learned positions that the
CLI (as the reference's) builds for ``whisper_base``.
Last, once serving is done, the trainer (``python -m
repro_torch.launch.train``): ``phase_train_kernels`` holds each kernel's
training route (the kernel's forward; flash's plain backward, the scans'
backward kernels) against the all-plain version at the training shapes,
gradients bit for bit (WKV6's within ``RWKV6_GRAD_TOL``), the forward
kernel once in the forward and never in the backward, each backward
kernel once in the backward;
``phase_train_cli`` trains full-width qwen3_4b through the CLI's
``main`` (8 x 128 tokens, 20 steps) and ``phase_train`` full-width
recurrentgemma_2b and rwkv6_1p6b through ``train_loop`` (5 steps each;
first with the scans' plain backwards for the comparison, then as it
runs), each with finite losses and grad norms, moved params and one
kernel launch per block application (and one backward kernel launch per
scan forward), and prints ms a step (synced beside the watchdog's
dispatch time), tokens/s, peak memory against the 12 bytes a parameter
at rest, the model-FLOP share and each timed backward's share;
then one float32 step at reduced depth held against the same step with
every kernel swapped for its plain version; ``phase_train_faults`` runs
the reference's three fault-tolerance scenarios on reduced qwen3_4b;
``phase_train_mesh`` the sharded train step and ``phase_serve_tp`` the
tensor-parallel prefill and decode steps (full-width nemotron_4_340b at
2 layers from the sharded weight draw), each over a (1, 1) mesh of a
world-1 nccl group and held to its unsharded counterpart.
Every phase prints one JSON line and raises on failure. The line before
the last is the kernels' record; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when no CUDA device is available or the port's sources are missing.
"""
import ast
import collections
import contextlib
import dataclasses
import gc
import itertools
import json
import os
import shutil
import socket
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
from repro_torch.configs import ShapeSpec, get  # noqa: E402
from repro_torch.core.tableaus import get as get_tableau  # noqa: E402
from repro_torch.kernels import LAUNCHES, _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.hyper_step import ops as hs_ops  # noqa: E402
from repro_torch.kernels.hyper_step.ref import fused_rk_update_ref  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as rg_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    rglru_scan_backward_ref, rglru_scan_ref)
from repro_torch.kernels.rwkv6_scan import ops as rw_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import (  # noqa: E402
    wkv6_scan_backward_ref, wkv6_scan_ref)
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import (  # noqa: E402
    FixedGrid, FlowTrainConfig, HypersolverTrainConfig, Integrator,
    NeuralODE, make_fit_step, make_integrator, odeint_dopri5,
    odeint_dopri5_batched, residual_fitting_loss, train_flowhead,
    train_hypersolver)
from repro_torch.data import (  # noqa: E402
    ShardedLoader, density_sampler, synthetic_images, token_batches)
from repro_torch.distributed.fault import (  # noqa: E402
    FailureInjector, FaultInjector, StepFailure, StepWatchdog,
    WatchdogConfig, _hash01)
from repro_torch.launch import serve, steps, train  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    StepSettings, make_train_step, shard_state)
from repro_torch.launch.engine import (  # noqa: E402
    EngineConfig, MultiRateEngine, greedy_generate, lm_depth_model,
    load_flow_params, load_g_params, snap_to_buckets)
from repro_torch.launch.oracle import RooflineOracle  # noqa: E402
from repro_torch.launch.refinery import (  # noqa: E402
    Refinery, RefineryConfig, ResidualLedger)
from repro_torch.launch.mesh import (  # noqa: E402
    ServingMesh, make_serving_mesh)
from repro_torch.launch.scheduler import InflightScheduler  # noqa: E402
from repro_torch.launch.workload import (  # noqa: E402
    latency_stats, poisson_trace, replay_scheduler)
from repro_torch.models import cdepth, encdec, lm  # noqa: E402
from repro_torch.models.encdec import init_encdec  # noqa: E402
from repro_torch.models.cdepth import (  # noqa: E402
    lm_flow_apply, lm_flow_init, lm_g_init)
from repro_torch.models import conv_node  # noqa: E402
from repro_torch.models.lm import init_lm  # noqa: E402
from repro_torch.nn.cnf import (  # noqa: E402
    cnf_log_prob, cnf_mlp_init, cnf_sample, depth_column,
    exact_trace_dynamics)
from repro_torch.nn.module import (  # noqa: E402
    mlp_apply, mlp_init, truncated_normal_init)
from repro_torch.optim import adamw, scaled  # noqa: E402
from repro_torch.optim.grad_compress import (  # noqa: E402
    compressed_allreduce_mean)
from repro_torch.optim.quantized_state import (  # noqa: E402
    dequantize_blockwise, quantize_blockwise)
from repro_torch.roofline.costmodel import (  # noqa: E402
    H100, Mesh2D, cell_cost, predicted)

B, S, D = 8, 128, 2560          # the serving phases' batch of prompts
GEN = 32                        # tokens each decode phase generates
# Teacher-forced decode limits, a share of the largest |logit|, each
# between the sound runs' largest reading and the planted fault's
# (``lost_cache_writes``) smallest, read by tools/decode_limits.py on the
# H100 (PERF.md section 6). bf16 readings differ by model, so each has
# its own: sound 7.8e-3 / 4.0e-4 / 4.3e-2 / 8.7e-2 / 2.8e-4 / 8.2e-3,
# fault 0.18 / 7.9e-3 / 1.09 / 0.249 / 2.0e-3 / 9.4e-2 (OLMoE against a
# chain of decode steps; OLMoE, PaliGemma and Whisper-base's decoder-only
# LM over five seeds); at CUT_LAYERS' depth over seven seeds, Nemotron-4
# sound 7.4e-3-8.6e-3, fault 7.4e-2-8.1e-2, and Llama-4 at the median
# position (DECODE_STAT) against a chain of decode steps sound
# 3.6e-3-3.9e-3, fault 4.0e-2-4.3e-2; at full depth over seven seeds,
# Mistral-NeMo-12B (40 layers) sound 1.70e-2-1.94e-2, fault 0.223-0.404,
# and Qwen3-8B (36 layers) sound 1.63e-2-1.84e-2, fault 0.191-0.403: 5e-2
# leaves both sides a factor of ~2.6 and more (the in-flight check of
# Mistral-NeMo's logits against the drain's, another row count's GEMMs,
# read 2.4e-2).
BF16_DECODE_TOL = {"qwen3_4b": 3e-2, "recurrentgemma_2b": 2e-3,
                   "rwkv6_1p6b": 0.2, "olmoe_1b_7b": 0.15,
                   "paligemma_3b": 1e-3, "whisper_base": 3e-2,
                   "nemotron_4_340b": 3e-2,
                   "llama4_maverick_400b_a17b": 1.2e-2,
                   "mistral_nemo_12b": 5e-2, "qwen3_8b": 5e-2}
# Models whose decode is held at the median generated position, not the
# worst: Llama-4 Maverick cut to one (dense, moe) group routes each token to
# 1 of 128 experts, and bf16 rounding between the prefill's attention and
# the chain's flips some positions' expert (the whole expert output
# changes); its MoE block feeds no later cache, so a flip moves that
# position's logits alone, where a lost cache write moves every later
# position. At the worst position the sound and planted-fault readings
# overlap (0.0046-0.428 against 0.425-0.472 over seven prompt seeds); at
# the median one they are 3.6e-3-3.9e-3 against 4.0e-2-4.3e-2.
DECODE_STAT = {"llama4_maverick_400b_a17b": "median"}
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
# What the phases measured, for the roofline comparison at the end
# (``report_roofline``): decode ms a token, train ms a step and the
# in-flight K per request, keyed by kind, then arch.
MEASURED = collections.defaultdict(dict)
FP32_PEAK = 67e12               # H100 SXM float32 outside the tensor cores
# dense bf16/fp16 tensor cores: the cost model's H100 record (one source
# for the card's rates, roofline/costmodel.py)
BF16_PEAK = H100.peak_flops


START = time.perf_counter()


def emit(**row):
    """Prints ``row`` as one JSON line; a phase's line also carries the
    seconds since the script started (``elapsed_s``), so consecutive
    lines give each phase's share of the run's time limit."""
    if "phase" in row:
        row["elapsed_s"] = time.perf_counter() - START
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
    """Published device-memory rate of the card (bytes/s), from the cost
    model's chip record: H100 SXM only."""
    if name == H100.name:
        return H100.hbm_bw
    raise RuntimeError(f"no memory rate on record for {name!r}")


def ordered_bits(t: torch.Tensor) -> torch.Tensor:
    """16-bit float patterns as integers ordered like the values."""
    b = t.view(torch.int16).to(torch.int32)
    return torch.where(b < 0, -(b & 0x7FFF), b)


def host_us_per_call(fn, calls: int = 200) -> float:
    """Host µs a call of ``fn`` over ``calls`` back-to-back calls, the
    stream synchronised before and after: Python dispatch and launch
    enqueue, where they take longer than the device's work."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / calls


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
    the image path's float32 euler + g step under a scalar eps (one
    row of 64 or 1,024 x 9,408 elements); and the CNF path's float32
    heun + g step under a scalar eps (one row of 2 x 65,536 elements)."""
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
        # phase_cnf's fused HyperHeun step (K 1, eps 1) on the z leaf of
        # its timed batch of 65,536 base draws
        HsCase("cnf-heun+g", (65536, 2), (f32, f32, f32), f32, (0.5, 0.5), 2,
               eps=1.0, active=None),
        # the drains' hyper_euler step at Mistral-NeMo-12B's and Qwen3-8B's
        # widths (phase_mistral_nemo, phase_qwen3_8b)
        HsCase("euler+g-5120", (B, S, 5120), (bf, bf), bf, (1.0,), 1),
        HsCase("euler+g-4096", (B, S, 4096), (bf, bf), bf, (1.0,), 1),
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


def phase_kernels(dev, bandwidth, cases=None):
    """hyper_step at every case of ``hs_cases`` (or ``cases``): kernel
    against plain version, both timed cold-L2, and the bound of this
    run's data (an active row reads every operand and writes z, a frozen
    row reads and writes z only)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for case in hs_cases() if cases is None else cases:
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


def attention_pairs(Sq, Sk, causal, window):
    """(query, key) pairs Sq query rows attend over Sk keys: the work
    this run's masks leave, not the dense Sq x Sk."""
    q = np.arange(Sq)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros_like(q)
    hi = q + 1 if causal else np.full_like(q, Sk)
    return int(np.sum(hi - lo))


# name, (B, Sq, Sk, H, KV, hd), dtype, causal, window: the serving shapes
# of both models (Griffin's local window does not bind at S 128),
# float16 and float32 at the Qwen3 shape (the fused-vs-unfused phase runs
# float32), a window that binds, ragged S with windows whose first
# visited tile is fully masked, OLMoE's serving shape (MHA 16/16), the
# training shape of phase_cdepth_lm's reduced LM (float32, hd 16);
# Whisper-base's attention at hd 64 (the encoder over 1,500 frames,
# non-causal; the decoder at 448 tokens, causal; cross-attention of 448
# queries over 1,500 frames; float32 at the training step's shapes; a
# ragged GQA cross case) and PaliGemma's (384 = 256 patches + 128 text
# tokens, MQA 8/1 at hd 256); Nemotron-4-340B's at hd 192 (GQA 96/8), with a
# ragged fp16 case under a binding window, its serving shape in float32 and
# a ragged GQA cross case
FLASH_CASES = [
    ("griffin", (8, 128, 128, 10, 1, 256), torch.bfloat16, True, 2048),
    ("qwen3", (8, 128, 128, 32, 8, 128), torch.bfloat16, True, None),
    ("qwen3-fp16", (8, 128, 128, 32, 8, 128), torch.float16, True, None),
    ("qwen3-fp32", (8, 128, 128, 32, 8, 128), torch.float32, True, None),
    ("window-binds", (1, 4096, 4096, 10, 1, 256), torch.bfloat16, True, 2048),
    ("ragged", (2, 200, 200, 10, 1, 256), torch.bfloat16, True, 130),
    ("ragged-fp32", (2, 200, 200, 32, 8, 128), torch.float32, True, 40),
    ("olmoe", (8, 128, 128, 16, 16, 128), torch.bfloat16, True, None),
    ("cdepth-lm", (8, 64, 64, 4, 2, 16), torch.float32, True, None),
    ("whisper-enc", (8, 1500, 1500, 8, 8, 64), torch.bfloat16, False, None),
    ("whisper-dec", (8, 448, 448, 8, 8, 64), torch.bfloat16, True, None),
    ("whisper-cross", (8, 448, 1500, 8, 8, 64), torch.bfloat16, False,
     None),
    ("whisper-cross-fp16", (8, 448, 1500, 8, 8, 64), torch.float16, False,
     None),
    ("whisper-dec-fp32", (8, 128, 128, 8, 8, 64), torch.float32, True, None),
    ("whisper-cross-fp32", (8, 128, 1500, 8, 8, 64), torch.float32, False,
     None),
    ("cross-ragged", (2, 77, 203, 8, 2, 64), torch.bfloat16, False, None),
    ("paligemma", (8, 384, 384, 8, 1, 256), torch.bfloat16, True, None),
    ("nemotron", (8, 128, 128, 96, 8, 192), torch.bfloat16, True, None),
    ("nemotron-ragged-fp16", (2, 200, 200, 24, 2, 192), torch.float16, True,
     130),
    ("nemotron-fp32", (8, 128, 128, 96, 8, 192), torch.float32, True, None),
    ("cross-192", (2, 77, 203, 12, 2, 192), torch.bfloat16, False, None),
]
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-2, torch.float32: 2e-5}


def sdpa_kwargs(sq, sk, causal, window, dev):
    """``scaled_dot_product_attention``'s mask arguments for a case."""
    if not causal:
        return {}
    if window is None or window >= sq:
        return dict(is_causal=True)
    pos = torch.arange(sq, device=dev)
    return dict(attn_mask=(pos[None, :] <= pos[:, None])
                & (pos[:, None] - pos[None, :] < window))


def phase_flash(dev, bandwidth, cases=FLASH_CASES):
    """flash_attention against its plain version (rtol = atol 2e-5 in
    fp32 with TF32 off, 2e-2 in bf16 and fp16: the bounds
    tests/test_kernels.py holds the Pallas kernel to, since the sums run in
    other orders), the kernel, plain and SDPA times cold-L2, and each
    case's bound (bf16 and fp16 at the tensor cores' peak)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    gen = torch.Generator(device=dev).manual_seed(4)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for name, (b, sq, sk, h, kv, hd), dtype, causal, window in cases:
        def draw(s, n):
            return torch.randn((b, s, n, hd), generator=gen,
                               device=dev).to(dtype)
        q, k, v = draw(sq, h), draw(sk, kv), draw(sk, kv)
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
        ref = attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = FLASH_TOL[dtype]
        if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol):
            raise AssertionError(f"flash_attention {name}: kernel disagrees "
                                 f"with plain (max abs err {err})")
        buf = torch.empty_like(q)
        ms = time_ms(lambda: fa_ops.launch(buf, q, k, v, causal, window),
                     flush)
        plain_ms = time_ms(lambda: attention_ref(q, k, v, causal=causal,
                                                 window=window), flush)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = sdpa_kwargs(sq, sk, causal, window, dev)
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True, **lib), flush)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = 4 * hd * b * h * attention_pairs(sq, sk, causal, window)
        peak = FP32_PEAK if dtype == torch.float32 else BF16_PEAK
        bound = max(nbytes / bandwidth, flops / peak) * 1e3
        rows.append(dict(case=name, shape=[b, sq, sk, h, kv, hd],
                         dtype=str(dtype).replace("torch.", ""),
                         causal=causal, window=window, max_abs_err=err,
                         tol=tol, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound,
                         bytes=nbytes, flops=flops,
                         bound_by="bytes" if nbytes / bandwidth
                         >= flops / peak else "operations"))
        del q, k, v, out, ref, buf
    emit(phase="kernels", kernel="flash_attention", cases=rows,
         max_abs_err=max(r["max_abs_err"] for r in rows),
         library="torch.nn.functional.scaled_dot_product_attention")
    return rows


def ulp16(x: torch.Tensor, dtype) -> torch.Tensor:
    """The spacing of the 16-bit float ``dtype`` at each |x| (fp32)."""
    digits = {torch.bfloat16: 8, torch.float16: 11}[dtype]
    _, e = torch.frexp(x.float().abs())
    tiny = {torch.bfloat16: 2.0 ** -133, torch.float16: 2.0 ** -24}[dtype]
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       e - digits).clamp_min(tiny)


def grad_gap(got: torch.Tensor, want: torch.Tensor, tol: float):
    """(max |got - want| over max |want|, every element within ``tol`` of
    max |want|). A gradient in a 16-bit dtype is the cast of an fp32 sum:
    the bound is held on that sum, and each of the two casts may add half
    a unit in the last place of the 16-bit type (one unit at the larger
    of the two values), since a sum that differs in its last fp32 bits
    can round to the neighbouring 16-bit value."""
    g, w = got.float(), want.float()
    gap = (g - w).abs()
    scale = float(w.abs().max()) if w.numel() else 0.0
    allow = torch.full_like(gap, tol * scale)
    if got.dtype in (torch.bfloat16, torch.float16):
        allow = allow + ulp16(torch.maximum(g.abs(), w.abs()), got.dtype)
    worst = float(gap.max()) if gap.numel() else 0.0
    return worst / max(scale, 1e-30), bool((gap <= allow).all())


def operator_grad_case(kernel, route, plain, ins, gen, tol=None):
    """One scan operator's gradient on the card against ``torch.autograd``
    of its plain loop at the same inputs and output gradients: ``route``
    runs the operator (the kernel's forward; its registered backward, the
    backward operator, whose CUDA implementation is the backward kernel
    ``kernel + "_backward"``), ``plain`` the loop; both return a tuple of
    outputs, and every input that is not None requires grad. Raises unless
    the forward kernel launched once in the forward and never in the
    backward, the backward kernel once in the backward and never in the
    forward, and every gradient is equal bit for bit (``tol`` None) or
    within ``tol`` (``grad_gap``); an input the plain loop leaves without
    a gradient must get none or zeros. Returns the launches, {input: max
    abs gap / max |autograd's|} and whether every gradient was equal bit
    for bit."""
    back = kernel + "_backward"
    leaf = lambda: [None if t is None else t.detach().clone()
                    .requires_grad_() for t in ins]
    mine, ref = leaf(), leaf()
    LAUNCHES.clear()
    outs = route(*mine)
    fwd = (LAUNCHES[kernel], LAUNCHES[back])
    gs = [torch.randn(o.shape, generator=gen, device=o.device) for o in outs]
    torch.autograd.backward(outs, gs)
    bwd = (LAUNCHES[kernel] - fwd[0], LAUNCHES[back] - fwd[1])
    torch.autograd.backward(plain(*ref), gs)
    torch.cuda.synchronize()
    rel, equal, ok = {}, True, True
    for i, (a, b) in enumerate(zip(mine, ref)):
        if a is None:
            continue
        if b.grad is None and (a.grad is None or not a.grad.any()):
            continue
        if a.grad is None or b.grad is None or a.grad.dtype != b.grad.dtype:
            raise AssertionError(f"{kernel}: input {i} has no gradient or "
                                 "another dtype")
        equal = equal and torch.equal(a.grad, b.grad)
        rel[i], fits = grad_gap(a.grad, b.grad, tol or 0.0)
        ok = ok and fits
    launches = dict(forward=fwd, backward=bwd)
    if (fwd, bwd) != ((1, 0), (0, 1)):
        raise AssertionError(f"{kernel}: launches (forward kernel, backward "
                             f"kernel) {launches}")
    if not (equal if tol is None else ok):
        raise AssertionError(f"{kernel}: the operator's gradient is off "
                             f"autograd of the plain loop's by {rel} "
                             f"(tol {tol})")
    return launches, rel, equal


# phase_rglru's cases that also check the gradient (fp32 and bf16 gates)
RGLRU_GRAD_CASES = ("serve", "ragged", "ragged-bf16")

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
    cold-L2, and the bound (2 reads and 1 fp32 write per element). In
    ``RGLRU_GRAD_CASES`` the operator's gradient (the kernel's forward, the
    backward operator ``rglru_scan_backward``, i.e. the backward kernel)
    against ``torch.autograd`` of the plain loop: ``torch.equal``, since
    the kernel's h equals the loop's and the backward kernel rounds each
    product and sum as autograd of the loop does; the forward kernel once
    in the forward, the backward kernel once in the backward."""
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
        grad = None
        if name in RGLRU_GRAD_CASES:
            launches, rel, equal = operator_grad_case(
                "rglru_scan", lambda a, b: (rg_ops.rglru_scan(a, b),),
                lambda a, b: (rglru_scan_ref(a, b),), [a, b], gen)
            grad = dict(launches=launches, max_rel_err=max(rel.values()),
                        bit_equal=equal)
        buf = torch.empty_like(out)
        ms = time_ms(lambda: rg_ops.launch(buf, a, b), flush)
        plain_ms = time_ms(lambda: rglru_scan_ref(a, b), flush)
        # the operator's dispatch: the wrapper's host time a call against
        # ``launch`` alone
        host_us = None if name != "serve" else dict(
            call=host_us_per_call(lambda: rg_ops.rglru_scan(a, b)),
            launch=host_us_per_call(lambda: rg_ops.launch(buf, a, b)))
        nbytes = 2 * a.numel() * a.element_size() + out.numel() * 4
        flops = 2 * a.numel()
        bound = max(nbytes / bandwidth, flops / FP32_PEAK) * 1e3
        rows.append(dict(case=name, shape=list(shape),
                         dtype=str(dtype).replace("torch.", ""),
                         max_abs_err=err, grad=grad, ms=ms,
                         plain_ms=plain_ms, host_us=host_us,
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
# phase_rwkv6's cases that also check the gradient, and its bound: each
# input's gradient within 1e-6 of the largest of autograd's for that
# input (``grad_gap``). The backward kernel recomputes the plain loop's
# states bit for bit and rounds each elementwise step as the plain loop
# does, so dS0 is equal bit for bit; only its five sums (dr, dk, dv, dw,
# u's) regroup, a few fp32 ulps (1.2e-7 each) of the largest gradient.
# A gradient cast to a 16-bit input's dtype may round to the neighbouring
# value where the sums differ in their last bits: ``grad_gap`` allows
# each cast its half unit in the last place. The cases with a state also
# check the gradient through S_T alone (no gradient of o).
RWKV6_GRAD_CASES = ("serve", "ragged-fp32", "state", "d128-state",
                    "decode")
RWKV6_GRAD_TOL = 1e-6


def phase_rwkv6(dev, bandwidth):
    """rwkv6_scan against its plain version (max abs error at most 2e-6
    of the largest plain output; the final state equal bit for bit, since
    the kernel rounds the state update as the plain version does and only
    regroups and reorders the output's sums), both timed cold-L2, and the
    bound (each operand read once, o and S_T written once; 5 flops per
    state element per token: k v, w S, + kv, and r S as an fma of 2). In
    ``RWKV6_GRAD_CASES`` the operator's gradient (the kernel's forward, the
    backward operator ``wkv6_backward``, i.e. the backward kernel) against
    ``torch.autograd`` of the plain loop, within ``RWKV6_GRAD_TOL``
    (``grad_gap``), through o and S_T and, with a state, through S_T
    alone; the forward kernel once in the forward, the backward kernel
    once in the backward."""
    gen = torch.Generator(device=dev).manual_seed(6)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for name, (b, t, h, d), xdt, wdt, udt, state in RWKV6_CASES:
        r, k, v, w, u = rwkv6_inputs((b, t, h, d), xdt, gen, dev, wdt, udt)
        S0 = torch.randn((b, h, d, d), generator=gen, device=dev) \
            if state else None
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
        grad = None
        if name in RWKV6_GRAD_CASES:
            outs = (slice(0, 2), slice(1, 2)) if state else (slice(0, 1),)
            grad = []
            for sel in outs:   # o (and S_T); then S_T alone
                def route(*x):
                    out = rw_ops.wkv6(*x, want_state=state)
                    return (tuple(out) if state else (out,))[sel]
                launches, rel, equal = operator_grad_case(
                    "rwkv6_scan", route, lambda *x: wkv6_scan_ref(*x)[sel],
                    [r, k, v, w, u, S0], gen, tol=RWKV6_GRAD_TOL)
                grad.append(dict(outputs=["o", "S_T"][sel],
                                 launches=launches,
                                 max_rel_err=max(rel.values()),
                                 bit_equal=equal, tol=RWKV6_GRAD_TOL))
        o_buf = torch.empty((b, t, h, d), dtype=torch.float32, device=dev)
        s_buf = torch.empty_like(S0) if state else None
        ms = time_ms(lambda: rw_ops.launch(o_buf, r, k, v, w, u, S0, s_buf),
                     flush)
        plain_ms = time_ms(lambda: wkv6_scan_ref(r, k, v, w, u, S0), flush)
        # the operator's dispatch: the wrapper's host time a call against
        # ``launch`` alone (the decode case is every decode step's call)
        host_us = None if name not in ("serve", "decode") else dict(
            call=host_us_per_call(lambda: rw_ops.wkv6(r, k, v, w, u, S0,
                                                      want_state=state)),
            launch=host_us_per_call(lambda: rw_ops.launch(
                o_buf, r, k, v, w, u, S0, s_buf)))
        nbytes = sum(x.numel() * x.element_size() for x in (r, k, v, w, u)) \
            + o_buf.numel() * 4 + (2 * S0.numel() * 4 if state else 0)
        flops = 5 * d * d * b * t * h
        bound = max(nbytes / bandwidth, flops / FP32_PEAK) * 1e3
        rows.append(dict(case=name, shape=[b, t, h, d],
                         dtypes=[str(x).replace("torch.", "")
                                 for x in (xdt, wdt, udt)],
                         state=state, max_abs_err=max(errs),
                         max_abs_plain=max(scale), tol=RWKV6_TOL, grad=grad,
                         host_us=host_us, ms=ms,
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


# name, (B, T, W), dtype of a and b, gradient: phase_rglru_backward's
# cases, the training shape (the fp32 gates nn/rglru.py gives the scan,
# and bf16), ragged widths in bf16 and fp16 (W 1000: 16-byte rows and a
# part-filled last block; W 333: rows not 16-byte aligned) and a gradient
# expanded over time (stride 0), which the kernel reads as it is
RGLRU_BACKWARD_CASES = [
    ("train", (8, 128, 2560), torch.float32, "dense"),
    ("train-bf16", (8, 128, 2560), torch.bfloat16, "dense"),
    ("w1000-bf16", (3, 77, 1000), torch.bfloat16, "dense"),
    ("w1000-fp16", (3, 77, 1000), torch.float16, "dense"),
    ("w333-bf16", (2, 45, 333), torch.bfloat16, "dense"),
    ("w333-fp16", (2, 45, 333), torch.float16, "dense"),
    ("w333-expanded", (2, 45, 333), torch.float32, "expanded"),
]


def input_bytes(t: torch.Tensor) -> int:
    """Bytes of a tensor's distinct elements (an expanded view's data)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def rglru_backward_inputs(case, gen, dev):
    """The backward operator's (grad, a, h) of one ``RGLRU_BACKWARD_CASES``
    row, drawn from ``gen``: h is the plain scan's output."""
    _, shape, dtype, kind = case
    a, b = rglru_inputs(shape, dtype, gen, dev)
    g = torch.randn(shape if kind == "dense" else shape[:1] + (1,)
                    + shape[2:], generator=gen, device=dev).expand(shape)
    return g, a, rglru_scan_ref(a, b)


def phase_rglru_backward(dev, bandwidth):
    """The RG-LRU backward kernel (the CUDA implementation of
    ``repro_torch::rglru_scan_backward``) against its plain version
    (``rglru_scan_backward_ref``) on the same inputs, da and db equal bit
    for bit in every case of ``RGLRU_BACKWARD_CASES``, both timed cold-L2,
    and the bound: grad, a and h read once, da and db written once, 3
    flops an element."""
    gen = torch.Generator(device=dev).manual_seed(7)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for case in RGLRU_BACKWARD_CASES:
        name, shape, dtype, kind = case
        g, a, h = rglru_backward_inputs(case, gen, dev)
        out = torch.ops.repro_torch.rglru_scan_backward(g, a, h, dtype)
        want = rglru_scan_backward_ref(g, a, h, dtype)
        torch.cuda.synchronize()
        err = max(float((x.float() - y.float()).abs().max())
                  for x, y in zip(out, want))
        if not all(x.dtype == y.dtype and torch.equal(x, y)
                   for x, y in zip(out, want)):
            raise AssertionError(f"rglru_scan_backward {name}: kernel "
                                 f"disagrees with plain (max abs {err})")
        da, db = out
        ms = time_ms(lambda: rg_ops.launch_backward(da, db, g, a, h), flush)
        plain_ms = time_ms(lambda: rglru_scan_backward_ref(g, a, h, dtype),
                           flush)
        nbytes = sum(input_bytes(t) for t in (g, a, h)) \
            + sum(t.numel() * t.element_size() for t in out)
        flops = 3 * a.numel()
        bound = max(nbytes / bandwidth, flops / FP32_PEAK) * 1e3
        rows.append(dict(case=name, shape=list(shape),
                         dtype=str(dtype).replace("torch.", ""), grad=kind,
                         max_abs_err=err, bit_equal=True, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound, bytes=nbytes,
                         bound_by="bytes" if nbytes / bandwidth
                         >= flops / FP32_PEAK else "operations"))
        del a, h, g, out, want
    emit(phase="kernels", kernel="rglru_scan_backward", cases=rows,
         max_abs_err=max(r["max_abs_err"] for r in rows), library=None,
         library_note="no single PyTorch call computes the gradient of a "
         "linear recurrence (torch has no scan op)")
    return rows


# name, (B, T, H, D), dtype of r, k, v and u (w fp32), with S0, with gS,
# with go: phase_rwkv6_backward's cases, the training shape (the dtypes
# the model gives: bf16 r, k, v, u, fp32 w; then all fp32, whose
# gradients have no cast after the kernel's sums; then with a state and
# its gradient), and D 8, 16, 32 and 128 at T 1 and T 200 with and
# without S0 and gS, D 64 at the edges of the kernel's 16-token chunks (T
# 16, one whole chunk, with S0 and gS; T 17, a chunk of one token after
# it), and a gradient through S_T alone (no go)
RWKV6_BACKWARD_CASES = [
    ("train", (8, 128, 32, 64), torch.bfloat16, False, False, True),
    ("train-fp32", (8, 128, 32, 64), torch.float32, False, False, True),
    ("train-state", (8, 128, 32, 64), torch.bfloat16, True, True, True),
    ("d8-t200", (2, 200, 4, 8), torch.float32, True, True, True),
    ("d8-t1", (3, 1, 4, 8), torch.float32, False, False, True),
    ("d16-t200", (2, 200, 4, 16), torch.bfloat16, False, True, True),
    ("d16-t1", (3, 1, 4, 16), torch.float32, True, False, True),
    ("d32-t77", (2, 77, 4, 32), torch.float32, False, True, True),
    ("d128-t200", (2, 200, 4, 128), torch.bfloat16, True, True, True),
    ("d128-t1", (2, 1, 8, 128), torch.float32, False, False, True),
    ("d64-t16", (2, 16, 4, 64), torch.float32, True, True, True),
    ("d64-t17", (2, 17, 4, 64), torch.bfloat16, False, False, True),
    ("go-absent", (2, 50, 4, 64), torch.float32, True, True, False),
]


def rwkv6_inputs(shape, xdt, gen, dev, wdt=torch.float32, udt=None):
    """r, k, v, w, u of ``shape`` (B, T, H, D): r, k, v normal in
    ``xdt``, the decay in the model's range exp(-exp(w0)), w0 in [-6, -1],
    in ``wdt``, and u = 0.3 normal in ``udt`` (default ``xdt``)."""
    b, t, h, d = shape
    r, k, v = (torch.randn(shape, generator=gen, device=dev).to(xdt)
               for _ in range(3))
    w0 = torch.linspace(-6.0, -1.0, h * d, device=dev).reshape(h, d)
    w = torch.exp(-torch.exp(w0 + 0.1 * torch.randn(
        shape, generator=gen, device=dev))).to(wdt)
    u = (0.3 * torch.randn((h, d), generator=gen, device=dev)).to(
        udt or xdt)
    return r, k, v, w, u


def rwkv6_backward_inputs(case, gen, dev):
    """The backward operator's arguments (go, gS, r, k, v, w, u, S0) of one
    ``RWKV6_BACKWARD_CASES`` row, drawn from ``gen``."""
    _, shape, xdt, s0, gs, go_on = case
    b, t, h, d = shape
    r, k, v, w, u = rwkv6_inputs(shape, xdt, gen, dev)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    S0 = randn(b, h, d, d) if s0 else None
    gS = randn(b, h, d, d) if gs else None
    go = randn(b, t, h, d) if go_on else None
    return go, gS, r, k, v, w, u, S0


def phase_rwkv6_backward(dev, bandwidth):
    """The WKV6 backward kernel (the CUDA implementation of
    ``repro_torch::wkv6_backward``) against its plain version
    (``wkv6_scan_backward_ref``) on the same inputs in every case of
    ``RWKV6_BACKWARD_CASES``: dS0 equal bit for bit, every other gradient
    within RWKV6_GRAD_TOL of its largest value (``grad_gap``); in the
    training case two more launches write the same bits (the kernel sums
    in a fixed order, with no atomics). Times the kernel's launch
    (``ms``) and the whole operator (``op_ms``: with its allocations and
    u's sums over the partials) against the plain version, cold-L2, and
    the bound: each input read once and each output written once, and 21
    flops a state element and token (10 without go); the workspace's
    write and read of the checkpoints (one state a head every 16 tokens)
    are beside it (``workspace_ms``: their bytes at the memory rate)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for case in RWKV6_BACKWARD_CASES:
        name, (b, t, h, d), xdt, s0, gs, go_on = case
        args = rwkv6_backward_inputs(case, gen, dev)
        S0 = args[-1]
        got = torch.ops.repro_torch.wkv6_backward(*args)
        want = wkv6_scan_backward_ref(*args)
        torch.cuda.synchronize()
        rel = {}
        for n, x, y in zip(("dr", "dk", "dv", "dw", "du"), got, want):
            rel[n], ok = grad_gap(x, y, RWKV6_GRAD_TOL)
            if not ok or x.dtype != y.dtype:
                raise AssertionError(f"rwkv6_scan_backward {name}: {n} off "
                                     f"the plain version's by {rel[n]} of "
                                     "its largest value")
        if s0 and not torch.equal(got[5], want[5]):
            raise AssertionError(f"rwkv6_scan_backward {name}: dS0 differs "
                                 "from the plain version's")
        err = max(float((x.float() - y.float()).abs().max())
                  for x, y in zip(got, want) if y.numel())
        grads = [torch.empty_like(x) for x in got[:4]]
        dS0 = torch.empty_like(S0) if s0 else None
        n_states, n_part, _ = rw_ops._workspace_floats(b, t, h, d)
        states = torch.empty(n_states, dtype=torch.float32, device=dev)
        part = torch.empty((b, t, h, d), dtype=torch.float32, device=dev)
        ms = time_ms(lambda: rw_ops.launch_backward(
            grads, dS0, states, part, *args), flush)
        repeat = None
        if name == "train":   # two launches, the same bits
            outs = [[torch.empty_like(x) for x in (*grads, part)]
                    for _ in range(2)]
            for o in outs:
                rw_ops.launch_backward(o[:4], dS0, states, o[4], *args)
            torch.cuda.synchronize()
            repeat = all(torch.equal(x, y) for x, y in zip(*outs))
            if not repeat:
                raise AssertionError("rwkv6_scan_backward train: two "
                                     "launches differ")
            del outs
        op_ms = time_ms(lambda: torch.ops.repro_torch.wkv6_backward(*args),
                        flush)
        plain_ms = time_ms(lambda: wkv6_scan_backward_ref(*args), flush,
                           reps=10)
        nbytes = sum(input_bytes(x) for x in args if x is not None) \
            + sum(x.numel() * x.element_size() for x in got)
        flops = (21 if go_on else 10) * b * t * h * d * d
        bound = max(nbytes / bandwidth, flops / FP32_PEAK) * 1e3
        rows.append(dict(case=name, shape=[b, t, h, d],
                         dtype=str(xdt).replace("torch.", ""), S0=s0,
                         gS=gs, go=go_on, max_abs_err=err, max_rel_err=rel,
                         dS0_bit_equal=s0 or None, tol=RWKV6_GRAD_TOL,
                         repeat_bit_equal=repeat,
                         ms=ms, op_ms=op_ms, plain_ms=plain_ms,
                         bound_ms=bound, bytes=nbytes, flops=flops,
                         workspace_ms=2 * n_states * 4 / bandwidth * 1e3,
                         bound_by="bytes" if nbytes / bandwidth
                         >= flops / FP32_PEAK else "operations"))
        del S0, args, got, want, grads, dS0, states, part
    emit(phase="kernels", kernel="rwkv6_scan_backward", cases=rows,
         max_abs_err=max(r["max_abs_err"] for r in rows),
         max_rel_err=max(max(r["max_rel_err"].values()) for r in rows),
         library=None, library_note="no single PyTorch call computes the "
         "gradient of the WKV6 recurrence")
    return rows


@contextlib.contextmanager
def count_blocks():
    """Counts block applications by kind while open, by wrapping
    ``block_apply`` where the model code calls it (models/lm.py and
    models/cdepth.py); the package itself keeps no such counter."""
    counts = collections.Counter()
    orig = lm.block_apply

    def counted(p, cfg, kind, *args, **kwargs):
        counts[kind] += 1
        return orig(p, cfg, kind, *args, **kwargs)

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
    """Every attention block application (dense, attn, moe) launched
    flash_attention once, every Griffin recurrent block application
    rglru_scan once, every RWKV6 block application rwkv6_scan once."""
    for kernel, kinds in (("flash_attention", ("dense", "attn", "moe")),
                          ("rglru_scan", ("rec",)),
                          ("rwkv6_scan", ("rwkv",))):
        applied = sum(blocks.get(k, 0) for k in kinds)
        if launches.get(kernel, 0) != applied:
            raise AssertionError(f"{tag}: {kernel} launched "
                                 f"{launches.get(kernel, 0)} times, the "
                                 f"{'/'.join(kinds)} block applications "
                                 f"were {applied}")


def check_only(launches, blocks, kinds, tag):
    """Raises unless a serving window applied blocks of exactly ``kinds``
    and launched no kernel but flash_attention and hyper_step."""
    if set(blocks) != set(kinds) or any(
            n for k, n in launches.items()
            if k not in ("flash_attention", "hyper_step")):
        raise AssertionError(f"{tag}: blocks {blocks}, launches {launches}: "
                             f"only {sorted(kinds)} blocks, flash_attention "
                             "and hyper_step should run")


def counted_drain(engine, prompt, full_top, kinds, tag):
    """One drain of ``prompt`` with its kernel launches and block
    applications counted: raises unless every request is served with K
    mixed, hyper_step ran once per solver step, flash_attention once per
    attention block application, and nothing but blocks of ``kinds`` and
    those two kernels ran. Returns the drain's report and launches."""
    LAUNCHES.clear()
    with count_blocks() as blocks, torch.no_grad():
        results, ms = synced_ms(lambda: engine.run(prompt))
    launches, blocks = dict(LAUNCHES), dict(blocks)
    check_served(results, tag)
    expected = packed_k_max_sum(results, engine.ecfg.max_batch)
    if launches.get("hyper_step", 0) != expected:
        raise AssertionError(f"{tag}: hyper_step launched "
                             f"{launches.get('hyper_step', 0)} times, the "
                             f"solver steps were {expected}")
    check_block_launches(launches, blocks, tag)
    check_only(launches, blocks, kinds, tag)
    return dict(seconds=ms / 1e3, tol=engine.ecfg.tol,
                K=[r.K for r in results],
                mean_nfe=float(np.mean([r.nfe for r in results])),
                agree=float(np.mean([np.mean(np.argmax(r.outputs, -1)
                                             == full_top[i])
                                     for i, r in enumerate(results)])),
                launches=launches, expected_hyper_step_launches=expected,
                block_applications=blocks), launches


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


def phase_inflight(dev, cfg, params, prompt, tol, via_cli=False,
                   keep_records=False):
    """A main path: the in-flight scheduler serving ``INFLIGHT_REQUESTS``
    full-width prompts of a model on its serve phase's params and
    calibrated tolerance (euler, multi-rate over buckets 2,4,8, fused),
    slots 4, seg 2, a Poisson trace at 0.25 per cost unit, seed 0; once
    with the synchronous loop and once with the overlap loop (for qwen3_4b
    through the serving CLI, whose weights from the same seed must equal
    the serve phase's). Every segment runs hyper_step once per step, every
    block application its kernel. Before the counted runs, the drain
    engine serves the same prompts (the reference for K, nfe and logits)
    and both loops run once more with their host syncs counted. A MoE
    model's counted runs also record the dropped fraction of every
    dispatch (``moe_drops``). ``keep_records`` leaves the sync loop's
    report in ``MEASURED["inflight_records"]`` for ``phase_mesh``."""
    torch.cuda.reset_peak_memory_stats(dev)
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
    with count_blocks() as blocks, (moe_drops() if cfg.n_experts else
                                    contextlib.nullcontext()) as drops:
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
    MEASURED["inflight"][cfg.name] = dict(
        K={r.uid: r.K for r in sync_rep.records},
        useful_steps=sync_rep.useful_steps)
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
         block_applications=blocks, **checked,
         moe_dropped=drop_summary(drops) if drops else None,
         peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    if keep_records:
        MEASURED["inflight_records"][cfg.name] = sync_rep
    del drain, sync_rep, over_rep
    torch.cuda.empty_cache()
    return launches


def synchronize_all():
    """Wait for every visible card (``torch.cuda.synchronize`` waits for
    the current one only)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def mesh_records_equal(tag, rep, ref):
    """Raises unless ``rep``'s records equal ``ref``'s request for request
    in completion order (uid, K, nfe, status, virtual stamps) with logits
    ``torch.equal``."""
    key = lambda r: (r.uid, r.K, r.nfe, r.status, r.t_submit, r.t_admit,
                     r.t_done)
    if [key(r) for r in rep.records] != [key(r) for r in ref.records]:
        raise AssertionError(f"{tag}: records differ from the unsharded "
                             f"pool's: {[key(r) for r in rep.records]} "
                             f"against {[key(r) for r in ref.records]}")
    for a, b in zip(rep.records, ref.records):
        if not torch.equal(torch.from_numpy(a.outputs),
                           torch.from_numpy(b.outputs)):
            raise AssertionError(f"{tag}: request {a.uid}'s logits differ "
                                 "from the unsharded pool's")


def phase_mesh(dev, cfg, params, prompt, tol):
    """A main path: the in-flight pool split over a serving mesh
    (``launch/mesh.py``), serving ``phase_inflight``'s prompts, params,
    tolerance, policy and Poisson trace: (a) ``make_serving_mesh`` of
    every visible card, (b) two sub-pools of two rows sharing this card
    (``ServingMesh((dev, dev))``), each with the sync and the overlap
    loop, held to (c) the unsharded pool's sync replay from
    ``phase_inflight``: request for request equal uid, K, nfe, status,
    completion order and virtual stamps, logits ``torch.equal``. Then a
    parametric g (hyper_euler, seeded) on the widest mesh, (a) on several
    cards, else (b): the sync loop with the g swapped mid-flight held to
    the unsharded pool's with the same swap. Every sub-pool's segment
    step runs hyper_step once, every block application its kernel. Then
    the serving CLI with ``--mesh 1`` serves the euler requests (held to
    (c)), with ``--mesh <every card>`` and that g restored by
    ``--g-ckpt`` serves the g's (held to the unsharded pool's without a
    swap), and ``--mesh`` one above the visible count exits non-zero
    naming that count. With one card the wall times are of the split on
    one card, not a multi-GPU time."""
    t_phase = time.perf_counter()
    ref = MEASURED["inflight_records"].pop(cfg.name)
    prompts = inflight_prompts(cfg, prompt)
    ecfg = EngineConfig(buckets=tuple(int(b) for b in BUCKETS.split(",")),
                        tol=tol, max_batch=B, solver="euler", fused=True)
    model = lm_depth_model(params, cfg, solver="euler", fused=True)
    count = torch.cuda.device_count()
    meshes = {"all_cards": make_serving_mesh(count),
              "two_on_one_card": ServingMesh((dev, dev))}
    trace = poisson_trace(prompts, rate=ARRIVAL_RATE, seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    gp = lm_g_init(gen, cfg, rank=32, device=dev)
    gp["w_out"] = truncated_normal_init(gen, gp["w_out"].shape, 0.02,
                                        gp["w_out"].dtype, dev)
    g_model = lm_depth_model(params, cfg, solver="hyper_euler",
                             g_params=gp, fused=True, refinable=True)
    g_ecfg = dataclasses.replace(ecfg, solver="hyper_euler")
    g_name = "all_cards" if count > 1 else "two_on_one_card"
    swapped = dict(gp, w_out=gp["w_out"] * 2)

    def swap_at_3():
        done = []

        def on_tick(sched):
            if sched.dispatches >= 3 and not done:
                done.append(1)
                sched.hot_swap_g(swapped)
        return on_tick

    cases, expected = [], 0
    LAUNCHES.clear()
    with count_blocks() as blocks:
        for name, mesh in meshes.items():
            for overlap in (False, True):
                sched = InflightScheduler(model, ecfg, slots=SLOTS, seg=SEG,
                                          mesh=mesh, overlap=overlap)
                synchronize_all()
                t0 = time.perf_counter()
                rep = replay_scheduler(sched, trace)
                synchronize_all()
                wall = time.perf_counter() - t0
                tag = f"{cfg.name} mesh {name} " \
                    f"{'overlap' if overlap else 'sync'}"
                mesh_records_equal(tag, own_outputs(rep), ref)
                expected += sched.dispatches * SEG * mesh.size
                cases.append(dict(mesh=name, devices=[str(d) for d in
                                                      mesh.devices],
                                  overlap=overlap, wall_s=wall,
                                  segments=sched.dispatches,
                                  equal_to_unsharded=True))
                del sched, rep
        g_reps = {}
        for key, mesh, swap in (("ref", None, False), ("swap", None, True),
                                ("swap_mesh", meshes[g_name], True)):
            sched = InflightScheduler(g_model, g_ecfg, slots=SLOTS, seg=SEG,
                                      mesh=mesh)
            g_reps[key] = own_outputs(replay_scheduler(
                sched, trace, on_tick=swap_at_3() if swap else None))
            expected += sched.dispatches * SEG * (mesh.size if mesh else 1)
            del sched
        mesh_records_equal(f"{cfg.name} mesh {g_name} g swapped",
                           g_reps["swap_mesh"], g_reps["swap"])
        if all(np.array_equal(a.outputs, b.outputs) for a, b in zip(
                g_reps["swap"].records, g_reps["ref"].records)):
            raise AssertionError(f"{cfg.name} mesh: the g swap changed no "
                                 "logits")
    launches, blocks = dict(LAUNCHES), dict(blocks)
    if launches.get("hyper_step", 0) != expected:
        raise AssertionError(f"{cfg.name} mesh: hyper_step launched "
                             f"{launches.get('hyper_step', 0)} times, the "
                             f"sub-pool segments x seg were {expected}")
    check_block_launches(launches, blocks, f"{cfg.name} mesh")

    t0 = time.perf_counter()
    cli = serve_cli(cfg.name, "--batch", str(INFLIGHT_REQUESTS), "--tol",
                    repr(tol), "--inflight", "--arrival-trace", "poisson",
                    "--mesh", "1")
    mesh_records_equal(f"{cfg.name} mesh CLI", own_outputs(cli["report"]),
                       ref)
    cli_s = time.perf_counter() - t0
    del cli
    ckpt = os.path.join(BUILD, "mesh_g")
    shutil.rmtree(ckpt, ignore_errors=True)
    CheckpointManager(ckpt).save(0, gp, wait=True)
    cli = serve_cli(cfg.name, "--batch", str(INFLIGHT_REQUESTS), "--tol",
                    repr(tol), "--inflight", "--arrival-trace", "poisson",
                    "--solver", "hyper_euler", "--g-ckpt", ckpt,
                    "--g-rank", "32", "--mesh", str(count))
    shutil.rmtree(ckpt)
    if (cli["sched"].model.g_apply is not None) != (count > 1):
        raise AssertionError(f"--mesh {count}: a loaded g is served on the "
                             "parametric path exactly when the mesh spans "
                             "several cards")
    mesh_records_equal(f"{cfg.name} mesh CLI --g-ckpt --mesh {count}",
                       own_outputs(cli["report"]), g_reps["ref"])
    del cli, g_reps
    try:
        serve_cli(cfg.name, "--inflight", "--mesh", str(count + 1))
    except SystemExit as e:
        refusal = str(e.code)
    else:
        raise AssertionError(f"--mesh {count + 1} served on {count} card(s)")
    if not refusal or f"visible ({count})" not in refusal:
        raise AssertionError(f"--mesh {count + 1} refusal does not name the "
                             f"visible count: {refusal!r}")
    emit(phase="mesh", arch=cfg.name, device_count=count,
         requests=INFLIGHT_REQUESTS, slots=SLOTS, seg=SEG, cases=cases,
         g_swapped_mesh=g_name, launches=launches,
         expected_hyper_step_launches=expected, block_applications=blocks,
         cli_mesh_1_s=cli_s, cli_refusal=refusal,
         note="multi-GPU timing not taken: one card" if count == 1 else
         f"{count} cards: wall times of one host thread driving them",
         seconds=time.perf_counter() - t_phase)
    del ref
    torch.cuda.empty_cache()
    return launches

# The roofline phase: the card the cost model's H100 record describes,
# its CLI run's time limit, and the smallest measured / predicted ratio a
# reading may show (no card beats its own roofline: a ratio below this
# means a rate or a byte count of the model is wrong).
ROOFLINE_CLI_TIMEOUT_S = 600
ROOFLINE_MIN_RATIO = 0.9
# the families each decode and train phase ran, priced at their cells
ROOFLINE_DECODE_ARCHS = ("qwen3_4b", "recurrentgemma_2b", "rwkv6_1p6b",
                         "olmoe_1b_7b", "paligemma_3b", "whisper_base")
ROOFLINE_TRAIN_ARCHS = ("qwen3_4b", "recurrentgemma_2b", "rwkv6_1p6b",
                        "paligemma_3b", "whisper_base")


@contextlib.contextmanager
def timed_segments():
    """While open, every segment call a slot pool builds
    (``Integrator.segment_cell``) is bracketed by two CUDA events; yields
    the list of (start, end) event pairs, one per segment."""
    events = []
    orig = Integrator.segment_cell

    def cell(self, *args, **kwargs):
        run = orig(self, *args, **kwargs)

        def timed(*call_args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = run(*call_args)
            end.record()
            events.append((start, end))
            return out
        return timed

    Integrator.segment_cell = cell
    try:
        yield events
    finally:
        Integrator.segment_cell = orig


def roofline_cli(tol, rate):
    """``python -m repro_torch.launch.serve`` in flight on the roofline
    clock, in a process of its own: the in-flight phases' 16 prompts,
    slots, seg and tolerance, the Poisson rate per device-us. Returns
    its latency line's dict and each request's K by uid; raises unless
    it exits 0."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "qwen3_4b", "--batch", str(INFLIGHT_REQUESTS), "--prompt-len",
           str(S), "--solver", "euler", "--multirate", "--fused",
           "--buckets", BUCKETS, "--tol", repr(tol), "--slots", str(SLOTS),
           "--seg", str(SEG), "--inflight", "--arrival-trace", "poisson",
           "--cost-oracle", "roofline", "--arrival-rate", repr(rate)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=ROOFLINE_CLI_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"serve CLI on the roofline clock exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    stats = [ast.literal_eval(l.split("] ", 1)[1]) for l in lines
             if l.startswith("[inflight poisson] ")]
    K = {int(l.split()[1].rstrip(":")): int(l.split("K=")[1].split()[0])
         for l in lines if l.strip().startswith("req ")}
    if len(stats) != 1:
        raise AssertionError(f"serve CLI printed {len(stats)} latency "
                             f"lines: {proc.stdout[-2000:]}")
    return stats[0], K


def phase_roofline(dev, params, prompt, tol):
    """A main path on the roofline clock (``launch/oracle.py::
    RooflineOracle``, ctx 128, the H100 record), on qwen3_4b's serve-phase
    params and tolerance. Raises unless the card is the one the record
    describes. (1) The drain engine serves the 8 prompts on the
    sequential clock and on the roofline clock: completions equal bit for
    bit (logits, hence tokens; K, nfe, status, order). (2) The in-flight
    phases' 16 prompts on a Poisson trace at ARRIVAL_RATE per field
    evaluation of the pool (``ARRIVAL_RATE / oracle.step_time(SLOTS)``
    per device-us), sync loop then overlap loop: equal bit for bit, each
    request's K and the useful step count equal ``phase_inflight``'s,
    ``latency_stats`` in device_us; each sync segment timed by CUDA
    events around its ``segment_cell``. (3) The serving CLI once with
    ``--cost-oracle roofline``, in its own process: exits 0, device_us,
    the same K. Launches: hyper_step once per solver step, the block
    kernels once per block application. Returns the launches and the
    segment's row of ``report_roofline``."""
    name = torch.cuda.get_device_name(0)
    if name != H100.name:
        raise AssertionError(f"the cost model's record is {H100.name!r}, "
                             f"the card is {name!r}: its rates would not "
                             "describe this card")
    cfg = get("qwen3_4b")
    oracle = RooflineOracle(cfg, ctx=S)
    rate = ARRIVAL_RATE / oracle.step_time(SLOTS)
    prompts = inflight_prompts(cfg, prompt)
    ecfg = EngineConfig(buckets=tuple(int(b) for b in BUCKETS.split(",")),
                        tol=tol, max_batch=B, solver="euler", fused=True)
    model = lm_depth_model(params, cfg, solver="euler", fused=True)
    trace = poisson_trace(prompts, rate=rate, seed=0)
    t0 = time.perf_counter()
    LAUNCHES.clear()
    with count_blocks() as blocks, torch.no_grad():
        seq = MultiRateEngine(model, ecfg).run(prompt)
        engine = MultiRateEngine(model, ecfg, oracle=oracle)
        roof = engine.run(prompt)
        drain_us = engine.last_report.cost
        with timed_segments() as events:
            sync_sched = InflightScheduler(model, ecfg, slots=SLOTS,
                                           seg=SEG, oracle=oracle)
            sync_rep = replay_scheduler(sync_sched, trace)
        torch.cuda.synchronize()
        seg_us = [a.elapsed_time(b) * 1e3 for a, b in events]
        sync_rep = own_outputs(sync_rep)
        over_sched = InflightScheduler(model, ecfg, slots=SLOTS, seg=SEG,
                                       oracle=oracle, overlap=True)
        over_rep = own_outputs(replay_scheduler(over_sched, trace))
    launches, blocks = dict(LAUNCHES), dict(blocks)
    served_s = time.perf_counter() - t0

    key = lambda r: (r.uid, r.K, r.nfe, r.status)
    if [key(r) for r in roof] != [key(r) for r in seq] or not all(
            np.array_equal(a.outputs, b.outputs) for a, b in zip(roof, seq)):
        raise AssertionError("roofline drain: completions differ from the "
                             "sequential clock's")
    check_served(roof, "roofline drain")
    stamps = lambda r: (r.uid, r.K, r.nfe, r.status, r.t_submit, r.t_admit,
                        r.t_done)
    if [stamps(r) for r in sync_rep.records] != \
            [stamps(r) for r in over_rep.records] or not all(
            np.array_equal(a.outputs, b.outputs)
            for a, b in zip(sync_rep.records, over_rep.records)):
        raise AssertionError("roofline in flight: sync and overlap differ")
    ref = MEASURED["inflight"][cfg.name]
    got = {r.uid: r.K for r in sync_rep.records}
    if got != ref["K"] or sync_rep.useful_steps != ref["useful_steps"] \
            or any(r.status != "ok" for r in sync_rep.records):
        raise AssertionError(f"roofline in flight: K {got}, useful steps "
                             f"{sync_rep.useful_steps}; phase_inflight's "
                             f"{ref}")
    stats = latency_stats(sync_rep)
    units = {latency_stats(r)["cost_unit"] for r in (sync_rep, over_rep)}
    dispatches = sync_sched.dispatches + over_sched.dispatches
    expected = 2 * packed_k_max_sum(seq, B) + dispatches * SEG
    if launches.get("hyper_step", 0) != expected or units != {"device_us"}:
        raise AssertionError(f"roofline: hyper_step launched "
                             f"{launches.get('hyper_step', 0)} times, the "
                             f"solver steps were {expected}; units {units}")
    check_block_launches(launches, blocks, "roofline")
    if len(seg_us) != sync_sched.dispatches:
        raise AssertionError(f"roofline: {len(seg_us)} timed segments of "
                             f"{sync_sched.dispatches}")
    del seq, roof, sync_rep, over_rep
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    cli_stats, cli_K = roofline_cli(tol, rate)
    cli_s = time.perf_counter() - t1
    if cli_stats["cost_unit"] != "device_us" or cli_K != ref["K"]:
        raise AssertionError(f"roofline CLI: {cli_stats}, K {cli_K}; "
                             f"phase_inflight's {ref['K']}")

    one = Mesh2D(1, 1, 1)
    cell = cell_cost(cfg, ShapeSpec(f"oracle_decode{S}_b{SLOTS}", "decode",
                                    S, SLOTS), one,
                     depth_fraction=1.0 / oracle.n_groups)
    pred_us = oracle.segment_cost((S,), SEG, SLOTS, 1)
    measured = float(np.median(seg_us))
    segment = dict(row="inflight_segment_us", arch=cfg.name,
                   cell=f"decode ctx {S}, width {SLOTS}, 1/"
                        f"{oracle.n_groups} of depth, x {SEG} steps",
                   predicted=pred_us, measured=measured,
                   ratio=measured / pred_us,
                   dominant=predicted(cell, one)[1],
                   t_collective_us=cell.t_collective * 1e6 * SEG)
    emit(phase="roofline", arch=cfg.name, chip=H100.name, ctx=S,
         step_time_us=oracle.step_time(SLOTS), arrival_rate_per_us=rate,
         drain_cost_us=drain_us, segments=len(seg_us),
         segment_us=dict(median=measured, min=float(np.min(seg_us)),
                         max=float(np.max(seg_us))),
         segment_cost_us=pred_us,
         virtual=dict(p50_latency=stats["p50_latency"],
                      p99_latency=stats["p99_latency"],
                      throughput=stats["throughput"],
                      cost_unit=stats["cost_unit"]),
         cli_latency=cli_stats,
         served_s=served_s, cli_s=cli_s, launches=launches,
         expected_hyper_step_launches=expected, block_applications=blocks)
    return launches, segment


def report_roofline(segment, decode_archs=ROOFLINE_DECODE_ARCHS,
                    train_archs=ROOFLINE_TRAIN_ARCHS):
    """The ``roofline_vs_measured`` line: the in-flight segment (from
    ``phase_roofline``), each decode phase's ms a token against the
    decode cell of its batch and context (B prompts, S + GEN positions)
    beside ``decode_limits``' weight-bytes bound, ``phase_kv_int8``'s
    decode with each cache at KV_PROMPT + GEN positions (the int8 cell's
    ``decode_hbm_bytes(kv_int8=True)``), and each train phase's synced ms
    a step against the train cell of B x S tokens (remat none and one
    microbatch, the trainer's settings; ``phase_train_8bit``'s with
    one-byte moments), all on one card of the H100 record. One card
    sends no collective, so each row predicts the larger of compute and
    memory (``costmodel.predicted``) and prints ``t_collective_ms``
    beside it. Raises if any measured time is below ROOFLINE_MIN_RATIO
    times its prediction."""
    one = Mesh2D(1, 1, 1)

    def one_card(t):
        pred, dominant = predicted(t, one)
        return pred * 1e3, dominant

    rows = [segment] if segment is not None else []
    for arch in decode_archs:
        cfg = get(arch)
        m = MEASURED["decode_encdec" if cfg.is_encdec else "decode"][arch]
        t = cell_cost(cfg, ShapeSpec(f"decode_{B}x{S + GEN}", "decode",
                                     S + GEN, B), one)
        pred, dominant = one_card(t)
        rows.append(dict(row="decode_ms_per_token", arch=arch,
                         cell=f"decode B {B}, ctx {S + GEN}",
                         predicted=pred, measured=m["ms"],
                         ratio=m["ms"] / pred, dominant=dominant,
                         t_collective_ms=t.t_collective * 1e3,
                         weight_bytes_bound_ms=m["weight_bytes_bound_ms"]))
    for (arch, kv), ms in MEASURED["decode_long"].items():
        ctx = KV_PROMPT + GEN
        t = cell_cost(get(arch), ShapeSpec(f"decode_{B}x{ctx}", "decode",
                                           ctx, B), one,
                      kv_int8=kv == "int8")
        pred, dominant = one_card(t)
        rows.append(dict(row="decode_ms_per_token", arch=arch,
                         cell=f"decode B {B}, ctx {ctx}, {kv} KV cache",
                         predicted=pred, measured=ms, ratio=ms / pred,
                         dominant=dominant,
                         t_collective_ms=t.t_collective * 1e3,
                         decode_hbm_bytes=t.hbm_bytes_dev))
    train = [(arch, MEASURED["train"][arch], 4, "") for arch in train_archs]
    train += [(arch, ms, 1, ", int8 moments")
              for arch, ms in MEASURED["train_8bit"].items()]
    for arch, ms, moment_bytes, note in train:
        cfg = get(arch)
        t = cell_cost(cfg, ShapeSpec(f"train_{B}x{S}", "train", S, B), one,
                      remat="none", microbatches=1,
                      moment_bytes=moment_bytes)
        pred, dominant = one_card(t)
        rows.append(dict(row="train_ms_per_step", arch=arch,
                         cell=f"train B {B} x S {S}, remat none{note}",
                         predicted=pred, measured=ms, ratio=ms / pred,
                         dominant=dominant,
                         t_collective_ms=t.t_collective * 1e3))
    emit(roofline_vs_measured=rows, chip=H100.name,
         min_ratio=ROOFLINE_MIN_RATIO)
    low = [r for r in rows if r["ratio"] < ROOFLINE_MIN_RATIO]
    if low:
        raise AssertionError(f"measured below {ROOFLINE_MIN_RATIO} x the "
                             f"roofline's prediction: {low}")
    return rows


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


@contextlib.contextmanager
def timed_captures(ledger):
    """While open, each ``ledger.capture_pool`` call is timed between two
    device syncs; yields ``{"ms": [...], "offered": [rows offered, rows
    kept]}`` over the calls that had rows. On exit the wrapper is deleted
    from the instance, so the class's method shows through again:
    assigning the bound method back would make the ledger hold itself, a
    reference cycle that keeps the served model alive past ``del``."""
    stats = {"ms": [], "offered": [0, 0]}
    capture_pool = ledger.capture_pool

    def timed(pool, rows):
        n, ms = synced_ms(lambda: capture_pool(pool, rows))
        if len(rows):
            stats["ms"].append(ms)
            stats["offered"][0] += len(rows)
            stats["offered"][1] += n
        return n

    ledger.capture_pool = timed
    try:
        yield stats
    finally:
        del ledger.capture_pool


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
    LAUNCHES.clear()
    with count_blocks() as blocks, timed_captures(ledger) as captured:
        sched, rep, wall_s = replay(model, ecfg, prompts, ledger=ledger)
    launches, blocks = dict(LAUNCHES), dict(blocks)
    offered, capture_ms = captured["offered"], captured["ms"]
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
    return {"flash_attention": kinds["dense"] + kinds["attn"] + kinds["moe"],
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
    h, _ = lm._blocks(params, cfg, lm.add_positions(
        params, cfg, lm._embed(params, cfg, tokens)))
    return lm._readout(params, cfg, h[:, start:], w)


def decode_chain_logits(params, cfg, tokens, start, w):
    """The logits from position ``start`` on of one ``lm_decode_step`` per
    position from an empty cache: the reference's own prefill (a scan of
    decode steps) and decode. For a MoE model this is the teacher-forced
    yardstick: each step routes its B tokens with the decode rule, where
    the forward routes all B·S tokens together at the training capacity
    (a different function wherever either drops a slot)."""
    caches = lm.init_lm_cache(cfg, tokens.shape[0], tokens.shape[1],
                              device=tokens.device)
    out = []
    for t in range(tokens.shape[1]):
        logits, caches = lm.lm_decode_step(params, cfg, tokens[:, t], caches,
                                           t, readout_w=w)
        out.append(logits)
    return torch.stack(out[start:], dim=1)


def teacher_forced_per_position(params, cfg, prompt, logits, toks, w):
    """Each generated position's largest |decode logit - teacher-forced
    logit| over the largest |teacher-forced logit|, (B, gen): the forward
    (a MoE model: the decode-step chain, ``decode_chain_logits``) runs the
    prompt and every generated token but the last, and its positions
    P-1.. are the logits the generate produced at each step."""
    seq = torch.cat([prompt, toks[:, :-1].to(prompt.dtype)], dim=1)
    tf = decode_chain_logits if cfg.n_experts else forward_logits
    full = tf(params, cfg, seq, prompt.shape[1] - 1, w)
    return (logits - full).abs().amax(-1) / full.abs().max()


def teacher_forced_err(params, cfg, prompt, logits, toks, w, stat="max"):
    """``teacher_forced_per_position`` at the worst position, or at the
    median one (``stat="median"``)."""
    per = teacher_forced_per_position(params, cfg, prompt, logits, toks, w)
    return float(per.max() if stat == "max" else per.median())


def check_decode(params, cfg, prompt, logits, toks, w, tol):
    """Holds a generate's logits to the teacher-forced forward within
    ``tol`` of the largest |logit| (at the worst position, or at the
    median one for a model in ``DECODE_STAT``), and the same generate
    under ``lost_cache_writes`` above it; raises unless both hold."""
    stat = DECODE_STAT.get(cfg.name, "max")
    err = teacher_forced_err(params, cfg, prompt, logits, toks, w, stat)
    with lost_cache_writes():
        f_logits, f_toks, _, _ = generate_logits(params, cfg, prompt,
                                                 toks.shape[1], w)
    fault = teacher_forced_err(params, cfg, prompt, f_logits, f_toks, w,
                               stat)
    if not err <= tol < fault:
        raise AssertionError(
            f"{cfg.name} {cfg.dtype}: teacher-forced decode error {err}, "
            f"planted fault {fault}, limit {tol} of the largest |logit| "
            f"({stat} position)")
    return dict(teacher_forced_rel_err=err, planted_fault_rel_err=fault,
                limit=tol, position=stat)


def decode_breakdown(params, cfg, prompt, gen, dev):
    """The generate's pieces, run again outside the counted window
    (``generate_logits``): prefill ms, raising unless its logits equal the
    readout of ``lm_forward``'s hidden states at the last position bit for
    bit (a MoE model's: of the full-sequence stack that fills the caches,
    each position routed as a decode step); decode ms per token, raising
    unless every logit is finite; the bf16 decode logits held to a
    teacher-forced forward (``check_decode``, the model's
    ``BF16_DECODE_TOL``); and one step's float32 readout (median of
    CUDA-event timings). A MoE model's dropped fractions are read for
    both dispatches: the decode steps' and prefill positions' (einsum,
    C = ceil(k B 2 / E)) and a forward's over the same tokens (sorted,
    C from all B·S tokens at the config's factor)."""
    dt = lm.dtype_of(cfg.dtype)
    toks = torch.as_tensor(prompt, device=dev)
    drops = {}
    with torch.no_grad():
        w = lm.readout_weight(params, cfg, dt)
        with (moe_drops() if cfg.n_experts else
              contextlib.nullcontext()) as dec_drops:
            logits, gen_toks, prefill_ms, step_ms = generate_logits(
                params, cfg, toks, gen, w)
        if cfg.n_experts:
            caches = lm.init_lm_cache(cfg, toks.shape[0], toks.shape[1],
                                      device=dev)
            h, _ = lm._blocks(params, cfg, lm._embed(params, cfg, toks),
                              caches)
            last = lm._readout(params, cfg, h[:, -1:], w)[:, 0]
            del caches, h
            seq = torch.cat([toks, gen_toks[:, :-1].to(toks.dtype)], dim=1)
            with moe_drops() as fwd_drops:
                forward_logits(params, cfg, seq, -1, w)
            drops = {**drop_summary(dec_drops), **drop_summary(fwd_drops)}
        else:
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
                readout_ms_per_step=float(np.median(times[5:])), **checked,
                moe_dropped=drops or None)


def phase_decode(dev, bandwidth, cfg, run):
    """A main path: the cached greedy decode of a full-width model, bf16,
    8 prompts of 128 tokens, 32 generated tokens. ``run()`` drives the
    generate through an entry point a user calls and returns (tokens,
    seconds, params, prompt); its kernel launches are counted and must be
    exactly ``expected_decode_launches``. Then ``decode_breakdown`` times
    the pieces and holds the prefill and the decode logits to the
    forward. The bound per token is the resident weights' bytes (each
    read once a step; a MoE decode step reads every expert's) over the
    card's memory rate."""
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
    weight_bytes = sum(l.numel() * l.element_size()
                       for l in pytree.tree_leaves(params))
    MEASURED["decode"][cfg.name] = dict(
        ms=pieces["decode_ms_per_token"],
        weight_bytes_bound_ms=weight_bytes / bandwidth * 1e3)
    emit(phase="decode", arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, batch=B, prompt_len=S,
         gen=GEN, seconds=seconds, tok_per_s=B * GEN / seconds,
         launches=launches, expected_launches=expected, **pieces,
         params=n_params, weight_bytes=weight_bytes,
         weight_bytes_bound_ms_per_token=weight_bytes / bandwidth * 1e3,
         peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         sample=toks[0, :8].tolist())
    return launches


def phase_decode_cli(dev, bandwidth, arch):
    """Full-width ``arch`` through the serving CLI with no --solver: the
    default, the cached decode path."""
    def run():
        out = serve.main(["--arch", arch, "--batch", str(B),
                          "--prompt-len", str(S), "--gen", str(GEN)])
        return out["tokens"], out["seconds"], out["params"], out["prompt"]
    launches = phase_decode(dev, bandwidth, get(arch), run)
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


# ------------------------------------------------------------------ OLMoE ----
# Full-width olmoe_1b_7b (arXiv:2409.02060: 16 moe layers, d 2048, MHA 16/16
# of 128 with qk-norm, 64 experts top-8 of d_ff 1024; ~6.9 B parameters,
# ~13.8 GB in bf16) on the 8 x 128 prompts the other families serve. Expert
# routing is not row independent: a drain row routes its 128 tokens alone
# (C = 20 slots an expert), a decode step its 8 tokens (C = 2), a full
# forward all 1,024 (C = 160).


@contextlib.contextmanager
def moe_drops():
    """Records, while open, the dropped fraction of every MoE dispatch the
    model code makes, keyed by dispatch and grouping: ``einsum/position``
    (``moe_apply``: decode steps and prefill positions), ``sorted/all``
    (``moe_apply_sorted`` over a whole batch: forwards, probes) and
    ``sorted/row`` (each row alone: multi-rate steps and segments). It
    wraps the names models/lm.py calls; the package keeps no such
    record."""
    drops = collections.defaultdict(list)
    orig = {"einsum": lm.moe_apply, "sorted": lm.moe_apply_sorted}

    def recorded(kind):
        def call(*args, **kwargs):
            out = orig[kind](*args, **kwargs)
            drops[f"{kind}/{kwargs.get('groups', 'all')}"].append(
                out.fraction_dropped)
            return out
        return call

    lm.moe_apply, lm.moe_apply_sorted = recorded("einsum"), recorded("sorted")
    try:
        yield drops
    finally:
        lm.moe_apply, lm.moe_apply_sorted = orig["einsum"], orig["sorted"]


def drop_summary(drops):
    """Dispatches, mean and largest dropped fraction, by ``moe_drops``
    key."""
    out = {}
    for key, fracs in sorted(drops.items()):
        f = torch.stack(fracs).float().cpu().numpy()
        out[key] = dict(dispatches=len(fracs), mean=float(f.mean()),
                        max=float(f.max()))
    return out


def phase_serve_olmoe(dev):
    """A main path: full-width olmoe_1b_7b served through the CLI (euler,
    multi-rate over buckets 2,4,8, fused; K mixed by a calibration drain
    first) and the engine (hyper_euler with a seeded g, its tolerance
    from this run's probe errors), each window counted: every moe block's
    attention runs flash_attention, every solver step hyper_step, and
    nothing else runs. Prints the drain walls and breakdown, mean NFE and
    agreement with the full forward, the dropped fractions and peak
    memory. Agreement falls short of 1.0 even where K reaches the depth:
    a drain row routes alone (C 20) where the forward routes the batch
    (C 160), as in the reference."""
    arch = "olmoe_1b_7b"
    cfg = get(arch)
    with moe_drops() as drops:
        report, launches, blocks, params, prompt = serve_counted(dev, arch)
    gen = torch.Generator(device=dev).manual_seed(1)
    gp = lm_g_init(gen, cfg, rank=32, device=dev)
    gp["w_out"] = truncated_normal_init(gen, gp["w_out"].shape, 0.02,
                                        gp["w_out"].dtype, dev)
    with torch.no_grad():
        tol = straddling_tol(hyper_engine(params, cfg, gp, 1e-2)
                             .probe(prompt)[1])
        full_top = lm.lm_forward(params, cfg, torch.as_tensor(
            prompt, device=dev))[0].argmax(-1).cpu().numpy()
    check_only(launches, blocks, {"moe"}, f"{arch} serve euler")
    hyper, hyper_launches = counted_drain(
        hyper_engine(params, cfg, gp, tol), prompt, full_top, {"moe"},
        f"{arch} hyper_euler")
    total = collections.Counter(launches) + collections.Counter(
        hyper_launches)
    report["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    emit(**report, hyper_euler=hyper, moe_dropped=drop_summary(drops),
         weight_bytes=sum(l.numel() * l.element_size()
                          for l in pytree.tree_leaves(params)))
    del gp
    torch.cuda.empty_cache()
    return dict(total), params, prompt, report["euler"]["tol"]


# --------------------------------------- Nemotron-4 and Llama-4 Maverick ----
# The repo's two largest published architectures at full width, their depth
# cut to what one H100 holds beside a drain's and a decode's temporaries:
# nemotron_4_340b (arXiv:2402.16819: d 18,432, 96 heads of 192 over 8 KV
# heads, a non-gated squared-ReLU FFN of 73,728, vocab 256,000) at 4 of its
# 96 layers, 23.25 B parameters, 46.5 GB in bf16 (the float32 readout matrix
# every readout builds adds 18.9 GB); llama4_maverick_400b_a17b (d 5,120, 40
# heads of 128 over 8, vocab 202,048) at 2 of its 48 layers, one (dense,
# moe) group: 128 experts of 8,192 at top-1 and a shared expert, ~18.6 B
# parameters, 37.1 GB. Each is drawn, served and decoded alone, the card
# released between them (the two do not fit together).
CUT_LAYERS = {"nemotron_4_340b": 4, "llama4_maverick_400b_a17b": 2}
# The largest dense models one H100 holds whole, served at full width and
# full depth by the same phase, and also in flight (the value: whether the
# overlap loop runs through the serving CLI): mistral_nemo_12b
# (hf:mistralai/Mistral-Nemo-Base-2407: 40 layers, d 5,120 over attention
# 4,096 wide, 32 heads of 128 over 8, d_ff 14,336, vocab 131,072; 12.25 B
# parameters, 24.5 GB in bf16) and qwen3_8b (hf:Qwen/Qwen3-8B: 36 layers,
# d 4,096, 32 heads of 128 over 8 with qk-norm, an untied head, vocab
# 151,936; 8.19 B parameters, 16.4 GB).
INFLIGHT_VIA_CLI = {"mistral_nemo_12b": True, "qwen3_8b": False}


def cut_config(arch):
    """Full-width ``arch`` at ``CUT_LAYERS[arch]`` layers, or at its own
    depth where it has no entry there (the serving CLI builds only full
    depth, so a cut model runs through the engine)."""
    cfg = get(arch)
    return dataclasses.replace(cfg, n_layers=CUT_LAYERS.get(arch,
                                                            cfg.n_layers))


def euler_engine(params, cfg, tol):
    """The serving CLI's drain (euler, multi-rate over BUCKETS, fused,
    packs of 8), built on ``cfg`` as the CLI builds it on a full config."""
    model = lm_depth_model(params, cfg, solver="euler", fused=True)
    ecfg = EngineConfig(buckets=tuple(int(b) for b in BUCKETS.split(",")),
                        tol=tol, max_batch=8, solver="euler", fused=True)
    return MultiRateEngine(model, ecfg)


def phase_cut_model(dev, bandwidth, arch):
    """A main path: ``cut_config(arch)``, bf16, seeded random weights (the
    CLI's seed and prompts), served through the engine as the CLI serves
    (euler, multi-rate over buckets 2, 4, 8, fused, its tolerance from a
    calibration drain's probe errors) and with hyper_euler and a seeded g
    (its tolerance from this run's probe), each drain counted
    (``counted_drain``); for a model in ``INFLIGHT_VIA_CLI``, then
    ``phase_inflight`` on the same params; then the cached greedy decode
    of 32 tokens (``phase_decode``: launches exact, the decode held to its
    teacher-forced limit). Prints each drain's wall, breakdown, mean NFE
    and agreement with the full forward, a MoE model's dropped fractions,
    the decode's ms a token beside the weight-bytes bound and the cost
    model's bound (for a MoE model, of the active parameters), and peak
    memory."""
    cfg = cut_config(arch)
    kinds = set(lm.block_pattern(cfg))
    torch.cuda.reset_peak_memory_stats(dev)
    params, init_ms = synced_ms(lambda: init_lm(
        torch.Generator(device=dev).manual_seed(0), cfg, device=dev))
    prompt = np.random.RandomState(1).randint(
        0, cfg.vocab, size=(B, S)).astype(np.int32)
    gen = torch.Generator(device=dev).manual_seed(1)
    gp = lm_g_init(gen, cfg, rank=32, device=dev)
    gp["w_out"] = truncated_normal_init(gen, gp["w_out"].shape, 0.02,
                                        gp["w_out"].dtype, dev)
    with torch.no_grad():
        full_top = lm.lm_forward(params, cfg, torch.as_tensor(
            prompt, device=dev))[0].argmax(-1).cpu().numpy()
        tol_euler = straddling_tol([r.err_probe for r in euler_engine(
            params, cfg, 1e-2).run(prompt)])
        tol_hyper = straddling_tol(hyper_engine(params, cfg, gp, 1e-2)
                                   .probe(prompt)[1])
    with (moe_drops() if cfg.n_experts else
          contextlib.nullcontext()) as drops:
        engine = euler_engine(params, cfg, tol_euler)
        euler, launches = counted_drain(engine, prompt, full_top, kinds,
                                        f"{arch} euler")
        hyper, hyper_launches = counted_drain(
            hyper_engine(params, cfg, gp, tol_hyper), prompt, full_top,
            kinds, f"{arch} hyper_euler")
    weight_bytes = sum(l.numel() * l.element_size()
                       for l in pytree.tree_leaves(params))
    emit(phase="serve", arch=cfg.name, layers=cfg.n_layers,
         full_layers=get(arch).n_layers, d_model=cfg.d_model,
         d_head=cfg.d_head, dtype=cfg.dtype, batch=B, prompt_len=S,
         init_ms=init_ms, euler=euler, hyper_euler=hyper,
         euler_breakdown_ms=serve_breakdown(engine, prompt),
         moe_dropped=drop_summary(drops) if cfg.n_experts else None,
         params=lm.count_params(params), weight_bytes=weight_bytes,
         logits_bytes=B * S * cfg.vocab * 4,
         peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    del engine, gp
    release_card()
    inflight_launches = {}
    if arch in INFLIGHT_VIA_CLI:
        inflight_launches = phase_inflight(
            dev, cfg, params, prompt, tol_euler,
            via_cli=INFLIGHT_VIA_CLI[arch])
        release_card()

    def run():
        with torch.no_grad():
            toks, ms = synced_ms(lambda: greedy_generate(params, cfg, prompt,
                                                         GEN))
        return toks.cpu(), ms / 1e3, params, prompt
    decode_launches = phase_decode(dev, bandwidth, cfg, run)
    one = Mesh2D(1, 1, 1)
    cost_ms, dominant = predicted(cell_cost(cfg, ShapeSpec(
        f"decode_{B}x{S + GEN}", "decode", S + GEN, B), one), one)
    emit(phase="decode_bounds", arch=cfg.name, layers=cfg.n_layers,
         decode_ms_per_token=MEASURED["decode"][cfg.name]["ms"],
         weight_bytes_bound_ms=weight_bytes / bandwidth * 1e3,
         cost_model_ms=cost_ms * 1e3, cost_model_dominant=dominant,
         cost_model_counts="active parameters" if cfg.n_experts
         else "every parameter")
    del params
    release_card()
    return sum((collections.Counter(c) for c in (
        launches, hyper_launches, inflight_launches, decode_launches)),
        collections.Counter())


def phase_nemotron(dev, bandwidth):
    """Full-width nemotron_4_340b at 4 layers (``phase_cut_model``): every
    attention block through the flash kernel at head width 192."""
    return phase_cut_model(dev, bandwidth, "nemotron_4_340b")


def phase_llama4(dev, bandwidth):
    """Full-width llama4_maverick_400b_a17b at 2 layers, one (dense, moe)
    group (``phase_cut_model``): 128 experts at top-1 beside a shared
    expert, the dispatch's dropped fractions printed."""
    return phase_cut_model(dev, bandwidth, "llama4_maverick_400b_a17b")


def phase_mistral_nemo(dev, bandwidth):
    """Full-width mistral_nemo_12b at its 40 layers (``phase_cut_model``):
    attention 4,096 wide under a stream of 5,120, through the flash
    kernel; in flight with the overlap loop through the serving CLI."""
    return phase_cut_model(dev, bandwidth, "mistral_nemo_12b")


def phase_qwen3_8b(dev, bandwidth):
    """Full-width qwen3_8b at its 36 layers (``phase_cut_model``): qk-norm
    and an untied head; in flight through the scheduler."""
    return phase_cut_model(dev, bandwidth, "qwen3_8b")


# ------------------------------------------------------ quantized paths ----
# The single-card half of the reference's performance options: the int8 KV
# cache (``set_perf_options(kv_int8=True)``) and q-chunked attention on
# full-width qwen3_4b at an 8 x 4,096 prompt, the int8 MoE dispatch
# (``int8_dispatch``) on full-width olmoe_1b_7b, and full-width OLMoE
# trained with 8-bit Adam moments (``optim.adamw8bit``). No kernel is new:
# the prefills run flash_attention, the OLMoE drain hyper_step.
KV_PROMPT, KV_CHUNK = 4096, 512
# int8 against bf16 cache, teacher-forced on the bf16 run's tokens: each
# step's largest |logit difference| over that step's largest |bf16 logit|,
# between the sound run's largest reading and the planted fault's
# (``lost_scale_writes``), read on the H100 with the serve phase's weights
# (seed 0): sound 7.6e-3 to 9.2e-3 over the 32 steps, fault 8.2e-3 at the
# prefill rising to 1.72e-2 at the last step (a lost token weighs 1 of
# ~4,100 keys, so the fault grows a step at a time).
KV_INT8_TOL = 1.25e-2
# an int8 cache's bytes over the bf16 cache's (int8 payload plus float32
# scales per token and head: (1 + 4 / 128) / 2 = 0.516 at head width 128)
KV_INT8_BYTES_RATIO = 0.52
# one moe block's mean |y_int8 - y| over mean |y| (the reference's own
# bound, tests/test_nn_layers.py::test_moe_int8_dispatch_close_to_fp)
MOE_INT8_BLOCK_BOUND = 0.05
# the whole model with int8 dispatch on against off (a forward's logits
# and a fixed-K drain's outputs): largest |difference| over largest |off|,
# between the sound readings and the planted fault's
# (``int8_without_scales``), read on the H100 with seed-0 weights: sound
# 0.087 / 0.123 (forward / drain) on a RandomState(0) prompt and 0.064 /
# 0.116 on the serving CLI's, fault 1.37 / 1.35 and 1.35 / 1.27. Routing
# differs after the first block (a token's expert choice flips), which
# is most of the sound reading.
MOE_INT8_TOL = 0.3
MOE_INT8_K = 4
TRAIN_8BIT_STEPS = 4
# AdamW at rest in training with float32 moments: bf16 param and grad,
# float32 mu and nu (TRAIN_BYTES_PER_PARAM); with int8 moments each moment
# costs 1 + 4/256 bytes an element
TRAIN_8BIT_BYTES_PER_PARAM = 2 + 2 + 2 * (1 + 4 / 256)
# a block's compression error is at most half its scale, up to float32
# rounding: the quotient g / scale and the dequantized q * scale (values of
# up to 127 scales) are each rounded within 2^-24 of 128 scales, so the
# error may exceed half a scale by 4 * 128 * 2^-24 = 2^-15 of it
COMPRESS_ROUNDING = 2.0 ** -15
# elements per block-aligned chunk of the full-width checks on one step's
# gradients (another size than the in-place update's own)
TRAIN_8BIT_CHECK_CHUNK = 3 << 24


@contextlib.contextmanager
def perf_options(**kw):
    """``lm.set_perf_options(**kw)`` while open, the options before it
    after."""
    saved = dict(lm.PERF_OPT)
    lm.set_perf_options(**kw)
    try:
        yield
    finally:
        lm.set_perf_options(**saved)


@contextlib.contextmanager
def attention_chunking(q_chunk):
    from repro_torch.nn import attention as nn_attention
    nn_attention.set_attention_chunking(q_chunk)
    try:
        yield
    finally:
        nn_attention.set_attention_chunking(None)


@contextlib.contextmanager
def lost_scale_writes():
    """A planted fault for the int8 cache: a decode step writes its
    token's int8 k and v but not their scales, which stay as they were
    (zero), so every later step reads that token's k and v as zeros. The
    prefill's writes stay."""
    from repro_torch.nn import attention as nn_attention
    orig = nn_attention.write_kv

    def faulty(cache, slots, k, v):
        saved = {n: cache[n][:, slots].clone() for n in cache
                 if n.endswith("_scale")}
        orig(cache, slots, k, v)
        for n, s in saved.items():
            cache[n][:, slots] = s

    nn_attention.write_kv = faulty
    try:
        yield
    finally:
        nn_attention.write_kv = orig


@contextlib.contextmanager
def int8_without_scales():
    """A planted fault for the int8 MoE dispatch: the int8 payload is
    dequantized with scale 1, so the experts see values up to 127 where
    the tokens were of order 1."""
    from repro_torch.nn import moe as nn_moe
    orig = nn_moe.quantize_absmax

    def faulty(xt):
        q, scale = orig(xt)
        return q, torch.ones_like(scale)

    nn_moe.quantize_absmax = faulty
    try:
        yield
    finally:
        nn_moe.quantize_absmax = orig


def rel_err(a, b):
    """Largest |a - b| over the largest |b| (inf where a is not finite)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if not bool(torch.isfinite(a).all()):
        return float("inf")
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def tree_bytes(tree):
    return sum(l.numel() * l.element_size() for l in pytree.tree_leaves(tree))


def forced_decode_logits(params, cfg, prompt, toks, w):
    """A prefill of ``prompt`` into fresh caches (``init_lm_cache`` under
    the options in force), then one ``lm_decode_step`` per token of
    ``toks`` but the last, teacher-forced. Returns (logits (B, gen, V),
    caches, prefill ms, decode ms per token, the prefill's
    flash_attention launches)."""
    P, gen = prompt.shape[1], toks.shape[1]
    caches = lm.init_lm_cache(cfg, prompt.shape[0], P + gen,
                              device=prompt.device)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    logits, caches = lm.lm_prefill(params, cfg, prompt, caches, readout_w=w)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    flash = LAUNCHES.get("flash_attention", 0)
    out = [logits]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = lm.lm_decode_step(params, cfg, toks[:, i], caches,
                                           P + i, readout_w=w)
        out.append(logits)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (gen - 1)
    return torch.stack(out, dim=1), caches, prefill_ms, step_ms, flash


def per_step_err(logits, ref):
    """Each step's largest |logit difference| over that step's largest
    |reference logit| (inf where a logit is not finite)."""
    return [rel_err(logits[:, j], ref[:, j]) for j in range(ref.shape[1])]


def phase_kv_int8(dev, bandwidth, params):
    """A main path: full-width qwen3_4b (bf16, the serve phase's params)
    prefilled with 8 prompts of KV_PROMPT tokens and decoded GEN steps,
    once with the bf16 cache (greedy, ``generate_logits``) and once under
    ``set_perf_options(kv_int8=True)`` teacher-forced on the bf16 run's
    tokens. Raises unless the int8 caches hold int8 k, v and float32
    scales in at most KV_INT8_BYTES_RATIO of the bf16 cache's bytes, the
    int8 prefill launched flash_attention once per layer, every step's
    int8 logits are within KV_INT8_TOL of the bf16 cache's, and the same
    run under ``lost_scale_writes`` is above it. Prints prefill ms, decode
    ms a token with each cache, the KV bytes, peak memory and the
    weight-bytes and KV-bytes bounds a token; the roofline line gets both
    decode times (``report_roofline``)."""
    cfg = get("qwen3_4b")
    dt = lm.dtype_of(cfg.dtype)
    prompt = torch.as_tensor(np.random.RandomState(11).randint(
        0, cfg.vocab, (B, KV_PROMPT)), device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        w = lm.readout_weight(params, cfg, dt)
        # untimed: the first prefill at this shape warms up the kernels'
        # and the GEMMs' choices, which the first timed run would pay for
        lm.lm_prefill(params, cfg, prompt, lm.init_lm_cache(
            cfg, B, KV_PROMPT, device=dev), readout_w=w)
        bf16, toks, bf16_prefill_ms, bf16_step_ms = generate_logits(
            params, cfg, prompt, GEN, w)
        bf16_bytes = tree_bytes(lm.init_lm_cache(
            cfg, B, KV_PROMPT + GEN, device="meta"))
        with perf_options(kv_int8=True):
            logits, caches, prefill_ms, step_ms, flash = \
                forced_decode_logits(params, cfg, prompt, toks, w)
            kinds = {k: str(v.dtype) for k, v in
                     caches["groups"]["b0"].items()}
            kv_bytes = tree_bytes(caches)
            del caches
            errs = per_step_err(logits, bf16)
            del logits
            with lost_scale_writes():
                f_logits, _, _, _, _ = forced_decode_logits(
                    params, cfg, prompt, toks, w)
            fault = per_step_err(f_logits, bf16)
            del f_logits
    del w, bf16
    want = {"k": "torch.int8", "v": "torch.int8",
            "k_scale": "torch.float32", "v_scale": "torch.float32"}
    layers = cfg.n_layers
    n_params = lm.count_params(params)
    weight_bytes = tree_bytes(params)
    report = dict(
        phase="kv_int8", arch=cfg.name, layers=layers, dtype=cfg.dtype,
        batch=B, prompt_len=KV_PROMPT, gen=GEN, cache_leaves=kinds,
        kv_bytes=dict(int8=kv_bytes, bf16=bf16_bytes,
                      ratio=kv_bytes / bf16_bytes),
        prefill_ms=dict(int8=prefill_ms, bf16=bf16_prefill_ms),
        decode_ms_per_token=dict(int8=step_ms, bf16=bf16_step_ms),
        flash_launches_in_int8_prefill=flash,
        teacher_forced_rel_err=errs, max_rel_err=max(errs),
        planted_fault_rel_err=fault, max_planted_fault_rel_err=max(fault),
        limit=KV_INT8_TOL,
        weight_bytes_bound_ms_per_token=weight_bytes / bandwidth * 1e3,
        kv_bytes_bound_ms_per_token=dict(int8=kv_bytes / bandwidth * 1e3,
                                         bf16=bf16_bytes / bandwidth * 1e3),
        params=n_params,
        peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        sample=toks[0, :8].tolist())
    emit(**report)
    MEASURED["decode_long"][(cfg.name, "int8")] = step_ms
    MEASURED["decode_long"][(cfg.name, "bf16")] = bf16_step_ms
    if kinds != want:
        raise AssertionError(f"kv_int8: cache leaves {kinds}, want {want}")
    if not kv_bytes <= KV_INT8_BYTES_RATIO * bf16_bytes:
        raise AssertionError(f"kv_int8: {kv_bytes} cache bytes against "
                             f"{bf16_bytes} in bf16")
    if flash != layers:
        raise AssertionError(f"kv_int8: the prefill launched flash "
                             f"{flash} times for {layers} layers")
    if not max(errs) <= KV_INT8_TOL < max(fault):
        raise AssertionError(
            f"kv_int8: teacher-forced error {max(errs)}, planted fault "
            f"{max(fault)}, limit {KV_INT8_TOL} of the largest |logit|")
    torch.cuda.empty_cache()
    return {"flash_attention": flash}


def phase_chunking(dev, params):
    """Full-width qwen3_4b's prefill of 8 x KV_PROMPT tokens with and
    without ``set_attention_chunking(KV_CHUNK)``: on the card the flash
    kernel runs unchanged under chunking (it never forms the (S, S)
    scores), so the logits must be ``torch.equal`` and the flash launches
    the same, one per layer. Returns the launches."""
    cfg = get("qwen3_4b")
    prompt = torch.as_tensor(np.random.RandomState(12).randint(
        0, cfg.vocab, (B, KV_PROMPT)), device=dev)
    out, flash = [], []
    with torch.no_grad():
        for chunk in (None, KV_CHUNK):
            caches = lm.init_lm_cache(cfg, B, KV_PROMPT, device=dev)
            LAUNCHES.clear()
            with attention_chunking(chunk):
                (logits, _), ms = synced_ms(lambda: lm.lm_prefill(
                    params, cfg, prompt, caches))
            flash.append(LAUNCHES.get("flash_attention", 0))
            out.append((logits, ms))
            del caches
    equal = torch.equal(out[0][0], out[1][0])
    emit(phase="chunking", arch=cfg.name, batch=B, prompt_len=KV_PROMPT,
         q_chunk=KV_CHUNK, logits_equal=equal, flash_launches=flash,
         prefill_ms=dict(unchunked=out[0][1], chunked=out[1][1]))
    if not equal or flash != [cfg.n_layers] * 2:
        raise AssertionError(f"chunking: logits equal {equal}, flash "
                             f"launches {flash} for {cfg.n_layers} layers")
    torch.cuda.empty_cache()
    return {"flash_attention": sum(flash)}


def moe_int8_drain(params, cfg, prompt, **opts):
    """One drain of ``prompt`` through the engine at a fixed K of
    MOE_INT8_K (euler, fused) under the given ``set_perf_options``: (the
    requests' outputs (B, S, V), ms, launches, dropped fractions)."""
    engine = MultiRateEngine(
        lm_depth_model(params, cfg, solver="euler", fused=True),
        EngineConfig(buckets=(MOE_INT8_K,), controller="fixed",
                     fixed_K=MOE_INT8_K, max_batch=B, solver="euler",
                     fused=True))
    LAUNCHES.clear()
    with perf_options(**opts), moe_drops() as drops, torch.no_grad():
        results, ms = synced_ms(lambda: engine.run(prompt))
    launches = dict(LAUNCHES)
    if [r.K for r in results] != [MOE_INT8_K] * len(results) \
            or any(r.status != "ok" for r in results):
        raise AssertionError(f"moe_int8 drain: K {[r.K for r in results]}, "
                             f"status {[r.status for r in results]}")
    out = np.stack([r.outputs for r in sorted(results, key=lambda r: r.uid)])
    return out, ms, launches, drops


def phase_moe_int8(dev, params, prompt):
    """On full-width olmoe_1b_7b (the serve phase's params and prompt),
    ``int8_dispatch`` on against off. One moe block (group 0, its ln2 of
    the prompt's embeddings, 8 x 128 tokens): raises unless mean |dy| /
    mean |y| < MOE_INT8_BLOCK_BOUND and the routing terms (aux, z,
    dropped fraction) are equal, since the router reads the unquantized
    tokens. The whole model: the full-sequence forward's logits and a
    fixed-K drain's outputs (``moe_int8_drain``, K MOE_INT8_K, both runs
    the same steps) within MOE_INT8_TOL, the same runs under
    ``int8_without_scales`` above it, and flash_attention and hyper_step
    launched as often with int8 as without. Prints each block's dropped
    fraction both ways (routing may differ after the first block) and
    the drains' ms. Returns the int8 drain's launches."""
    cfg = get("olmoe_1b_7b")
    toks = torch.as_tensor(prompt, device=dev)
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k,
              capacity_factor=cfg.capacity_factor, act=cfg.act)
    with torch.no_grad():
        gp = lm.group_params(params, 0)["b0"]
        xn = lm.rmsnorm(gp["ln2"], lm._embed(params, cfg, toks))
        fp = lm.moe_apply_sorted(gp["moe"], xn, **kw)
        q8 = lm.moe_apply_sorted(gp["moe"], xn, int8_dispatch=True, **kw)
        block_err = float(torch.mean(torch.abs(fp.y.float() - q8.y.float()))
                          / torch.mean(torch.abs(fp.y.float())))
        same_routing = all(torch.equal(a, b) for a, b in zip(fp[1:], q8[1:]))
        del xn, fp, q8
        fwd = {}
        for tag, ctx in (("off", contextlib.nullcontext),
                         ("int8", lambda: perf_options(int8_dispatch=True))):
            with ctx(), moe_drops() as drops:
                fwd[tag] = lm.lm_forward(params, cfg, toks)[0]
            fwd[tag + "_dropped"] = drop_summary(drops)
            fwd[tag + "_by_block"] = [float(f) for f in drops["sorted/all"]]
        with perf_options(int8_dispatch=True), int8_without_scales():
            fault_fwd = rel_err(lm.lm_forward(params, cfg, toks)[0],
                                fwd["off"])
        fwd_err = rel_err(fwd.pop("int8"), fwd["off"])
        del fwd["off"]
    off, off_ms, off_launches, _ = moe_int8_drain(params, cfg, prompt)
    on, on_ms, on_launches, on_drops = moe_int8_drain(
        params, cfg, prompt, int8_dispatch=True)
    with int8_without_scales():
        fault, _, _, _ = moe_int8_drain(params, cfg, prompt,
                                        int8_dispatch=True)
    drain_err, fault_drain = rel_err(on, off), rel_err(fault, off)
    report = dict(
        phase="moe_int8", arch=cfg.name, batch=B, prompt_len=S,
        block=dict(mean_abs_rel=block_err, bound=MOE_INT8_BLOCK_BOUND,
                   routing_equal=same_routing),
        forward=dict(rel_err=fwd_err, planted_fault_rel_err=fault_fwd,
                     dropped_by_block=dict(off=fwd["off_by_block"],
                                           int8=fwd["int8_by_block"])),
        drain=dict(K=MOE_INT8_K, rel_err=drain_err,
                   planted_fault_rel_err=fault_drain,
                   ms=dict(off=off_ms, int8=on_ms),
                   launches=dict(off=off_launches, int8=on_launches),
                   dropped_int8=drop_summary(on_drops)),
        limit=MOE_INT8_TOL)
    emit(**report)
    if not block_err < MOE_INT8_BLOCK_BOUND or not same_routing:
        raise AssertionError(f"moe_int8 block: mean |dy| / mean |y| "
                             f"{block_err}, routing equal {same_routing}")
    for tag, err, flt in (("forward", fwd_err, fault_fwd),
                          ("drain", drain_err, fault_drain)):
        if not err <= MOE_INT8_TOL < flt:
            raise AssertionError(f"moe_int8 {tag}: error {err}, planted "
                                 f"fault {flt}, limit {MOE_INT8_TOL}")
    if off_launches != on_launches or not on_launches.get("hyper_step") \
            or not on_launches.get("flash_attention"):
        raise AssertionError(f"moe_int8 drain launches: off {off_launches}, "
                             f"int8 {on_launches}")
    torch.cuda.empty_cache()
    return on_launches


def moment_leaves(tree):
    from repro_torch.optim import QTensor
    return pytree.tree_leaves(tree, is_leaf=lambda t: isinstance(t, QTensor))


def check_8bit_update(opt, params, grads, state, step, scale, key):
    """On the leaf at ``key`` (a path into ``params``): ``update_in_place``
    on copies of the leaf and its moments against ``update`` then
    ``apply_updates`` on the originals, one block-aligned chunk of
    TRAIN_8BIT_CHECK_CHUNK elements at a time (blocks are quantized
    alone, so the functional update of a chunk is the whole leaf's on
    those blocks). Returns the elements and blocks that differ."""
    from repro_torch.optim import Adam8bitState, QTensor, apply_updates
    from repro_torch.optim.quantized_state import BLOCK
    leaves = pytree.tree_leaves(params)
    names = leaf_names(params)
    i = names.index(key)
    p, g = leaves[i], grads[i]
    mq, vq = moment_leaves(state.mu)[i], moment_leaves(state.nu)[i]
    copies = [p.clone(), QTensor(mq.q.clone(), mq.scale.clone()),
              QTensor(vq.q.clone(), vq.scale.clone())]
    opt.update_in_place([g], Adam8bitState([copies[1]], [copies[2]]),
                        [copies[0]], step, scale)
    bad_p = bad_blocks = 0
    pf, gf, cf = p.view(-1), g.reshape(-1), copies[0].view(-1)
    for lo in range(0, p.numel(), TRAIN_8BIT_CHECK_CHUNK):
        hi = min(lo + TRAIN_8BIT_CHECK_CHUNK, p.numel())
        rows = slice(lo // BLOCK, -(-hi // BLOCK))
        st = Adam8bitState([QTensor(mq.q[rows], mq.scale[rows])],
                           [QTensor(vq.q[rows], vq.scale[rows])])
        u, st = opt.update([scaled(gf[lo:hi], scale)], st, [pf[lo:hi]], step)
        new_p = apply_updates([pf[lo:hi]], u)[0]
        bad_p += int((new_p != cf[lo:hi]).sum())
        for mine, ref in ((copies[1], st.mu[0]), (copies[2], st.nu[0])):
            bad_blocks += int(((mine.q[rows] != ref.q).any(1)
                               | (mine.scale[rows] != ref.scale)[:, 0])
                              .sum())
        del u, st, new_p
    return dict(leaf=key, elements=p.numel(), params_differing=bad_p,
                moment_blocks_differing=bad_blocks)


def check_compression(grads, scale):
    """``compress_with_feedback`` of one step's clipped gradients (float32,
    as the clip leaves them) from a zero error, leaf by leaf in
    block-aligned chunks: the largest |g_hat + e' - (g + e)| over the
    largest |g| (float32 rounding) and the largest block error over half
    its block's scale (at most 1 + COMPRESS_ROUNDING)."""
    from repro_torch.optim import (compress_with_feedback,
                                   init_error_feedback, quantize_blockwise)
    from repro_torch.optim.quantized_state import BLOCK
    worst_sum = worst_block = 0.0
    for g in grads:
        gf = g.reshape(-1)
        for lo in range(0, gf.numel(), TRAIN_8BIT_CHECK_CHUNK):
            g32 = scaled(gf[lo:lo + TRAIN_8BIT_CHECK_CHUNK], scale)
            e = init_error_feedback([g32])
            g_hat, e_new = compress_with_feedback([g32], e)
            total = (g_hat[0] + e_new[0]) - (g32 + e[0])
            worst_sum = max(worst_sum, float(total.abs().max()
                                             / g32.abs().max().clamp_min(
                                                 1e-30)))
            err = torch.nn.functional.pad(
                e_new[0], (0, (-g32.numel()) % BLOCK)).reshape(-1, BLOCK)
            half = quantize_blockwise(g32 + e[0]).scale / 2
            worst_block = max(worst_block, float(
                (err.abs().amax(1, keepdim=True) / half).max()))
            del g32, e, g_hat, e_new, total, err, half
    return dict(max_rel_sum_err=worst_sum, max_block_err_over_half_scale=
                worst_block)


def phase_train_8bit(dev, params):
    """A main path: full-width olmoe_1b_7b (the serve phase's params,
    trained in place) for TRAIN_8BIT_STEPS steps of 8 x 128 tokens with
    ``adamw8bit(linear_warmup_cosine(lr, lr / 10, 200, 10 000),
    weight_decay=0.1).update_in_place``: the trainer's step
    (``launch/steps.py::make_train_step``'s value and grad of ``lm_loss``
    at remat none, its global-norm clip, batches through a
    ``ShardedLoader``) with the 8-bit moments in place of AdamW's.
    Raises unless every loss and grad norm is finite, flash launched once
    per block application, params moved and the moments are int8 of the
    reckoned size. Then, on one more step's full-width gradients, raises
    unless ``update_in_place`` equals ``update`` + ``apply_updates`` on
    the expert ``wi`` stack bit for bit (``check_8bit_update``) and
    ``compress_with_feedback`` keeps g_hat + e' = g + e to float32
    rounding with every block's error at most half its scale
    (``check_compression``). Prints ms a step, peak memory against the
    bytes float32 moments would hold at rest, and the rest bytes."""
    from repro_torch.optim import (adamw8bit, clip_scale, global_norm,
                                   linear_warmup_cosine)
    from repro_torch.optim.quantized_state import BLOCK
    cfg = get("olmoe_1b_7b")
    s = StepSettings()
    opt = adamw8bit(linear_warmup_cosine(s.lr, s.lr * 0.1, 200, 10_000),
                    weight_decay=0.1)

    def loss_fn(p, mb):
        return lm.lm_loss(p, cfg, mb["tokens"], mb["targets"], remat="none")

    names = leaf_names(params)
    watch = [n for n in names if n.endswith(("moe/router/kernel",
                                             "moe/wi", "attn/wq/kernel"))]
    leaves = dict(zip(names, pytree.tree_leaves(params)))
    before = {n: leaves[n][0].clone() for n in watch}
    n = lm.count_params(params)
    torch.cuda.reset_peak_memory_stats(dev)
    state = opt.init(params)
    loader = ShardedLoader(({"tokens": t, "targets": y} for t, y in
                            itertools.islice(token_batches(
                                cfg.vocab, B, S, seed=0, device="cpu"),
                                TRAIN_8BIT_STEPS + 1)), device=dev)
    hist, ms = [], []
    LAUNCHES.clear()
    with count_blocks() as blocks:
        for step in range(TRAIN_8BIT_STEPS):
            batch = next(loader)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _, grads = steps._value_and_grad(loss_fn, params, batch)
            with torch.no_grad():
                gnorm = global_norm(grads)
                opt.update_in_place(grads, state, params, step,
                                    clip_scale(gnorm, s.grad_clip))
            del grads
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            hist.append(dict(loss=float(loss), grad_norm=float(gnorm)))
    launches, blocks = dict(LAUNCHES), dict(blocks)
    peak = torch.cuda.max_memory_allocated(dev)
    moments = moment_leaves(state.mu) + moment_leaves(state.nu)
    moment_bytes = tree_bytes(moments)
    reckoned = 2 * sum(-(-l.numel() // BLOCK) * (BLOCK + 4)
                       for l in pytree.tree_leaves(params))
    kinds = {str(m.q.dtype) for m in moments} | {str(m.scale.dtype)
                                                 for m in moments}
    moved = {k: float((leaves[k][0] != v).float().mean())
             for k, v in before.items()}
    del before
    # one more step's gradients, for the checks against the functional
    # update and the compression
    loss, _, grads = steps._value_and_grad(loss_fn, params, next(loader))
    with torch.no_grad():
        scale = clip_scale(global_norm(grads), s.grad_clip)
        wi = next(k for k in names if k.endswith("moe/wi"))
        update_check = check_8bit_update(opt, params, grads, state,
                                         TRAIN_8BIT_STEPS, scale, wi)
        compress = check_compression(grads, scale)
    del grads, state, moments
    rest = tree_bytes(params) + moment_bytes
    report = dict(
        phase="train_8bit", arch=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, dtype=cfg.dtype, batch=B, seq=S,
        steps=TRAIN_8BIT_STEPS, losses=[h["loss"] for h in hist],
        grad_norms=[h["grad_norm"] for h in hist], ms_per_step=ms,
        ms_per_step_median=float(np.median(ms[1:])), params=n,
        moved_share_of_first_slice=moved, moment_bytes=moment_bytes,
        reckoned_moment_bytes=reckoned, moment_dtypes=sorted(kinds),
        rest_bytes=rest, rest_gb=rest / 1e9,
        float32_moments_at_rest_gb=n * TRAIN_BYTES_PER_PARAM / 1e9,
        int8_moments_at_rest_gb=n * TRAIN_8BIT_BYTES_PER_PARAM / 1e9,
        peak_memory_gb=peak / 1e9, update_in_place_check=update_check,
        compression_check=compress, launches=launches,
        block_applications=blocks)
    emit(**report)
    MEASURED["train_8bit"][cfg.name] = report["ms_per_step_median"]
    vals = [h[k] for h in hist for k in ("loss", "grad_norm")]
    if not np.isfinite(vals).all():
        raise AssertionError(f"train_8bit: non-finite loss or grad norm "
                             f"{hist}")
    check_block_launches(launches, blocks, "olmoe_1b_7b train_8bit")
    if sum(blocks.values()) != cfg.n_layers * TRAIN_8BIT_STEPS:
        raise AssertionError(f"train_8bit: {blocks} block applications")
    if not any(v > 0 for v in moved.values()):
        raise AssertionError(f"train_8bit: no parameter moved: {moved}")
    if kinds != {"torch.int8", "torch.float32"} or moment_bytes != reckoned:
        raise AssertionError(f"train_8bit: moments {sorted(kinds)} of "
                             f"{moment_bytes} bytes, reckoned {reckoned}")
    if update_check["params_differing"] or \
            update_check["moment_blocks_differing"]:
        raise AssertionError(f"train_8bit: update_in_place differs from "
                             f"update + apply_updates: {update_check}")
    if not (compress["max_rel_sum_err"] <= 2.0 ** -22
            and compress["max_block_err_over_half_scale"]
            <= 1 + COMPRESS_ROUNDING):
        raise AssertionError(f"train_8bit: compression {compress}")
    release_card()
    return launches


# ----------------------------------------------------- LM hypersolver fit ----
# benchmarks/bench_cdepth_lm.py's "small" budget on the port, float32 on
# the card: reduced qwen3_4b at 8 layers trained by 150 AdamW steps of
# lm_loss on the synthetic token stream, then for each K a rank-32
# HyperEuler correction fitted by 80 iterations of cdepth_residual_loss,
# and the bench's rows (argmax agreement, logit MAE, KL against full
# depth) for euler and hyper_euler. The K 4 correction then goes through
# the port's CheckpointManager and --g-ckpt's loader and is served at K 4
# by the drain engine.
CDEPTH_LM_STEPS, CDEPTH_LM_FIT_ITERS = 150, 80
CDEPTH_LM_KS, CDEPTH_LM_RANK, CDEPTH_LM_SERVE_K = (1, 2, 4, 8), 32, 4


def cdepth_lm_cfg():
    """bench_cdepth_lm._cfg: reduced qwen3_4b at 8 layers (float32, d 64,
    4 heads of 16 over 2 kv heads)."""
    return dataclasses.replace(get("qwen3_4b").reduced(), n_layers=8)


def train_cdepth_lm(params, steps):
    """bench_cdepth_lm.train_small_lm from ``params``: AdamW 1e-3 steps of
    ``lm_loss``, gradients clipped to global norm 1.0, on
    token_batches(vocab, 8, 64, seed=3). Returns (params, losses)."""
    cfg = cdepth_lm_cfg()
    opt = adamw(1e-3)
    step = make_fit_step(lambda p, x, y: lm.lm_loss(p, cfg, x, y)[0], opt,
                         1.0)
    st = opt.init(params)
    it = token_batches(cfg.vocab, 8, 64, seed=3,
                       device=params["embed"]["table"].device)
    losses = []
    for i in range(steps):
        toks, tgts = next(it)
        params, st, loss = step(params, st, i, toks, tgts)
        losses.append(loss)
    return params, [float(l) for l in losses]


def fit_cdepth_g(params, gp, K, iters):
    """The bench's fit at mesh length K from ``gp``: AdamW 3e-3 steps of
    ``cdepth_residual_loss``, clipped to global norm 1.0, on
    token_batches(vocab, 4, 32, seed=13) with a new batch every 10
    iterations (the stream's first batch is drawn and passed over, as
    there). Returns (g params, losses)."""
    cfg = cdepth_lm_cfg()
    opt = adamw(3e-3)
    step = make_fit_step(
        lambda g, b: cdepth.cdepth_residual_loss(params, g, cfg, b, K), opt,
        1.0)
    st = opt.init(gp)
    it = token_batches(cfg.vocab, 4, 32, seed=13,
                       device=params["embed"]["table"].device)
    batch, _ = next(it)
    losses = []
    for i in range(iters):
        if i % 10 == 0:
            batch, _ = next(it)
        gp, st, loss = step(gp, st, i, batch)
        losses.append(loss)
    return gp, [float(l) for l in losses]


def cdepth_lm_rows(params, gps, toks):
    """bench_cdepth_lm.main's rows, unrounded: for each K (``gps`` maps K
    to its correction), euler and hyper_euler through
    ``lm_forward_cdepth`` against the full-depth forward on ``toks``."""
    cfg = cdepth_lm_cfg()
    n_groups = lm.group_layout(cfg)[1]
    full, _ = lm.lm_forward(params, cfg, toks)
    lp_full = torch.log_softmax(full, -1)
    rows = []
    for K, gp in gps.items():
        for g in (None, gp):
            out = cdepth.lm_forward_cdepth(params, cfg, toks, K=K,
                                           solver="euler", g_params=g)
            lp = torch.log_softmax(out, -1)
            rows.append(dict(
                bench="cdepth_lm",
                solver="euler" if g is None else "hyper_euler", K=K,
                full_depth_groups=n_groups, nfe_fraction=K / n_groups,
                argmax_agreement=float(
                    (full.argmax(-1) == out.argmax(-1)).float().mean()),
                logit_mae=float((full - out).abs().mean()),
                kl_vs_full_depth=float(torch.mean(torch.sum(
                    lp_full.exp() * (lp_full - lp), -1)))))
    return rows


def check_cdepth_lm(train_losses, fit_losses, rows):
    """Raises unless the training loss and the fit loss of every K short
    of the depth fall (mean of the last 10 below the first 10; at full
    depth Euler is exact, the target residual zero) and hyper_euler's KL
    is below euler's at every K short of the depth."""
    n_groups = rows[0]["full_depth_groups"]
    for tag, losses in [("lm_loss", train_losses)] + [
            (f"fit K={K}", l) for K, l in fit_losses.items()
            if K < n_groups]:
        if not np.mean(losses[-10:]) < np.mean(losses[:10]):
            raise AssertionError(f"cdepth_lm {tag}: loss did not fall "
                                 f"({losses[:3]} .. {losses[-3:]})")
    kl = {(r["solver"], r["K"]): r["kl_vs_full_depth"] for r in rows}
    for K in sorted({r["K"] for r in rows}):
        if K < n_groups and not kl["hyper_euler", K] < kl["euler", K]:
            raise AssertionError(f"cdepth_lm K={K}: hyper_euler KL "
                                 f"{kl['hyper_euler', K]} not below euler's "
                                 f"{kl['euler', K]}")


def serve_saved_g(params, gp, toks, K, ckpt_dir):
    """The fitted correction through the port's ``CheckpointManager`` and
    ``load_g_params`` (``--g-ckpt``'s loader), raising unless it comes
    back bit for bit, then served at K by the drain engine (hyper_euler,
    fixed K, fused) on the trained params. Returns (the completions, the
    restored g)."""
    cfg = cdepth_lm_cfg()
    CheckpointManager(ckpt_dir).save(CDEPTH_LM_FIT_ITERS, gp, wait=True)
    dev = params["embed"]["table"].device
    restored = load_g_params(ckpt_dir, cfg, rank=CDEPTH_LM_RANK, device=dev)
    if sorted(restored) != sorted(gp) or not all(
            torch.equal(restored[k], gp[k]) for k in gp):
        raise AssertionError("cdepth_lm: the restored g differs from the "
                             "saved one")
    engine = MultiRateEngine(
        lm_depth_model(params, cfg, solver="hyper_euler", g_params=restored,
                       fused=True),
        EngineConfig(buckets=(K,), controller="fixed", fixed_K=K,
                     max_batch=toks.shape[0], solver="hyper_euler",
                     fused=True))
    with torch.no_grad():
        return engine.run(toks.cpu().numpy()), restored


def phase_cdepth_lm(dev):
    """A main path (ROADMAP item 16, the LM hypersolver fitted by the
    paper's residual loss): ``benchmarks/bench_cdepth_lm.py``'s small
    budget on the card, float32 (``train_cdepth_lm``, ``fit_cdepth_g``,
    ``cdepth_lm_rows``), raising unless the losses fall and hyper_euler's
    KL beats euler's below full depth (``check_cdepth_lm``). Training
    runs flash_attention's forward in every block of every step (its
    gradient is the plain version's). Then ``serve_saved_g``: the K 4 g
    saved, restored and served by the engine, whose launches are counted
    (hyper_step once per solver step, flash_attention once per block),
    raising unless its argmax agreement with the full forward equals the
    K 4 hyper_euler row's."""
    assert not torch.backends.cuda.matmul.allow_tf32
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = cdepth_lm_cfg()
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                     device=dev)
    LAUNCHES.clear()
    (params, train_losses), train_ms = synced_ms(
        lambda: train_cdepth_lm(params, CDEPTH_LM_STEPS))
    train_flash = LAUNCHES["flash_attention"]
    if train_flash != CDEPTH_LM_STEPS * cfg.n_layers:
        raise AssertionError(f"cdepth_lm training: flash_attention launched "
                             f"{train_flash} times, the blocks were "
                             f"{CDEPTH_LM_STEPS * cfg.n_layers}")
    gps, fit_losses, fit_ms = {}, {}, {}
    for K in CDEPTH_LM_KS:
        gp = lm_g_init(torch.Generator(device=dev).manual_seed(2), cfg,
                       rank=CDEPTH_LM_RANK, param_dtype=torch.float32,
                       device=dev)
        (gps[K], fit_losses[K]), fit_ms[K] = synced_ms(
            lambda: fit_cdepth_g(params, gp, K, CDEPTH_LM_FIT_ITERS))
    toks, _ = next(token_batches(cfg.vocab, 4, 32, seed=11, device=dev))
    with torch.no_grad():
        rows = cdepth_lm_rows(params, gps, toks)
        full = lm.lm_forward(params, cfg, toks)[0]
        row_logits = cdepth.lm_forward_cdepth(
            params, cfg, toks, K=CDEPTH_LM_SERVE_K, solver="euler",
            g_params=gps[CDEPTH_LM_SERVE_K])
    check_cdepth_lm(train_losses, fit_losses, rows)

    ckpt = os.path.join(BUILD, "cdepth_lm_g")
    shutil.rmtree(ckpt, ignore_errors=True)
    LAUNCHES.clear()
    with count_blocks() as blocks:
        served, _ = serve_saved_g(params, gps[CDEPTH_LM_SERVE_K], toks,
                                  CDEPTH_LM_SERVE_K, ckpt)
    launches, blocks = dict(LAUNCHES), dict(blocks)
    shutil.rmtree(ckpt)
    if launches.get("hyper_step", 0) != CDEPTH_LM_SERVE_K:
        raise AssertionError(f"cdepth_lm serve: hyper_step launched "
                             f"{launches.get('hyper_step', 0)} times, the "
                             f"solver steps were {CDEPTH_LM_SERVE_K}")
    check_block_launches(launches, blocks, "cdepth_lm serve")
    top = full.argmax(-1).cpu().numpy()
    agree = float(np.mean([np.mean(np.argmax(r.outputs, -1) == top[i])
                           for i, r in enumerate(served)]))
    row = next(r for r in rows if r["K"] == CDEPTH_LM_SERVE_K
               and r["solver"] == "hyper_euler")
    if agree != row["argmax_agreement"] or any(
            r.status != "ok" or r.K != CDEPTH_LM_SERVE_K for r in served):
        raise AssertionError(f"cdepth_lm serve: agreement {agree}, the "
                             f"row's {row['argmax_agreement']}; "
                             f"{[(r.status, r.K) for r in served]}")
    emit(phase="cdepth_lm", cfg=dict(arch=cfg.name, layers=cfg.n_layers,
                                     d_model=cfg.d_model, dtype=cfg.dtype),
         train_steps=CDEPTH_LM_STEPS, fit_iters=CDEPTH_LM_FIT_ITERS,
         rank=CDEPTH_LM_RANK, rows=rows,
         train_loss=dict(first=train_losses[:3], last=train_losses[-3:]),
         fit_loss={K: dict(first=l[:3], last=l[-3:])
                   for K, l in fit_losses.items()},
         train_ms_per_step=train_ms / CDEPTH_LM_STEPS,
         fit_ms_per_iter={K: ms / CDEPTH_LM_FIT_ITERS
                          for K, ms in fit_ms.items()},
         train_flash_launches=train_flash,
         served=dict(K=CDEPTH_LM_SERVE_K, agree=agree,
                     max_abs_diff_vs_row=float(max(
                         np.abs(r.outputs - row_logits[i].cpu().numpy())
                         .max() for i, r in enumerate(served)))),
         launches=launches, block_applications=blocks,
         peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    del params, gps
    torch.cuda.empty_cache()
    return launches


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


# The paper's CNF density sampling (Sec. 4.2, Figs. 1 and 7;
# ``benchmarks/bench_cnf.py`` in the reference) on the port, float32 at
# its "small" budget: train an FFJORD CNF (paper C.3: [z, s] -> 128 ->
# 128 -> 128 -> 2, exact trace) by NLL through RK4 at K 8 (AdamW 1e-3,
# batch 128, clip 10), fit a HyperHeun at K 1 by residual fitting on
# lock-step dopri5 (1e-5) trajectories of 256 fresh base draws every 100
# iterations (AdamW 5e-3, weight decay 1e-6, clip 10), then sample 1,024
# base draws with dopri5 and with three 2-NFE candidates, each unfused
# and fused. Rings trains 200 steps, not the bench's 400: a step takes
# ~160 ms on the H100 (host-bound, PERF.md section 6), and the script's
# time limit is shared with every other phase.
CNF_TRAIN_ITERS = {"pinwheel": 400, "rings": 200}
CNF_FIT_ITERS, CNF_BATCH, CNF_FIT_BATCH = 300, 128, 256
CNF_SAMPLES, CNF_TIMED, CNF_TOL = 1024, (1024, 65536), 1e-5
# the batched dopri5's endpoints against the lock-step one's, a share of
# max(1, max |x_ref|): both hold every step's error to 1e-5, the lock-step
# solve as an RMS over the whole batch, the batched one per sample
CNF_BATCHED_TOL = 1e-3


def cnf_g_init(gen, device=None):
    """The bench's ``_g_init``: a two-layer net over [z, dz, dlogp, s] ->
    (dz_corr, dlogp_corr), its last layer zero."""
    return mlp_init(gen, (2 + 2 + 1 + 1, 64, 3), final_zero=True,
                    device=device)


def cnf_g_apply(gp, eps, s, x, state, dstate):
    """The bench's ``_g_apply``."""
    z, _ = state
    dz, dlogp = dstate
    h = torch.cat([z, dz, dlogp[..., None], depth_column(s, z)], dim=-1)
    out = mlp_apply(gp, h, act=torch.tanh)
    return (out[..., :2], out[..., 2])


def hyper_heun(gp, fused=False):
    return Integrator(tableau=get_tableau("heun"), fused=fused,
                      g=lambda e, s, z, dz: cnf_g_apply(gp, e, s, None, z, dz))


def cnf_nll(params, x):
    return -torch.mean(cnf_log_prob(params, x, K=8, solver="rk4"))


def cnf_train_step():
    """The bench's ``train_cnf`` step: (step, optimizer)."""
    opt = adamw(1e-3)
    return make_fit_step(cnf_nll, opt, 10.0), opt


def cnf_fit_step(aug, K=1):
    """The bench's ``fit_hyperheun`` step over dopri5 trajectories of the
    sampling field ``aug``: (step, optimizer)."""
    grid = FixedGrid.over(0.0, 1.0, K)
    opt = adamw(5e-3, weight_decay=1e-6)
    return make_fit_step(lambda g, traj: residual_fitting_loss(
        hyper_heun(g), aug, traj, grid), opt, 10.0), opt


def cnf_state0(z0):
    return (z0, torch.zeros(z0.shape[:-1], dtype=z0.dtype, device=z0.device))


def train_cnf(density, dev, iters, batch=CNF_BATCH, seed=0):
    """The bench's ``train_cnf``: (params, losses, ms a step)."""
    params = cnf_mlp_init(torch.Generator(device=dev).manual_seed(seed),
                          device=dev)
    step, opt = cnf_train_step()
    st = opt.init(params)
    sampler = density_sampler(density, batch, seed=seed + 1, device=dev)

    def run(params, st):
        losses = []
        for i in range(iters):
            params, st, loss = step(params, st, i, next(sampler))
            losses.append(loss)
        return params, losses

    (params, losses), ms = synced_ms(lambda: run(params, st))
    return params, [float(l) for l in losses], ms / iters


def fit_hyperheun(params, dev, iters, K=1, seed=7):
    """The bench's ``fit_hyperheun``: (g params, losses, ms an iteration,
    the dopri5 NFE of each target)."""
    aug = exact_trace_dynamics(params)
    gp = cnf_g_init(torch.Generator(device=dev).manual_seed(seed), dev)
    step, opt = cnf_fit_step(aug, K)
    st = opt.init(gp)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    grid = FixedGrid.over(0.0, 1.0, K)

    def run(gp, st):
        losses, nfes, traj = [], [], None
        for i in range(iters):
            if i % 100 == 0:          # paper: swap every 100 iterations
                z0 = torch.randn((CNF_FIT_BATCH, 2), generator=gen, device=dev)
                traj, nfe = odeint_dopri5(aug, cnf_state0(z0), grid,
                                          atol=CNF_TOL, rtol=CNF_TOL)
                nfes.append(nfe)
            gp, st, loss = step(gp, st, i, traj)
            losses.append(loss)
        return gp, losses, nfes

    (gp, losses, nfes), ms = synced_ms(lambda: run(gp, st))
    return gp, [float(l) for l in losses], ms / iters, nfes


def hist_l1(a, b, bins=24, lo=-4.5, hi=4.5):
    """The bench's ``_hist_l1``: mean |difference| of two 2-D histogram
    densities."""
    ha, _, _ = np.histogram2d(a[:, 0], a[:, 1], bins=bins,
                              range=[[lo, hi], [lo, hi]], density=True)
    hb, _, _ = np.histogram2d(b[:, 0], b[:, 1], bins=bins,
                              range=[[lo, hi], [lo, hi]], density=True)
    return float(np.abs(ha - hb).mean())


def cnf_candidates(gp, fused):
    """The bench's 2-NFE candidates: (integrator, K) by name."""
    return {"hyper_heun@2nfe": (hyper_heun(gp, fused), 1),
            "heun@2nfe": (Integrator(get_tableau("heun"), fused=fused), 1),
            "euler@2nfe": (Integrator(get_tableau("euler"), fused=fused), 2)}


def cnf_rows(params, gp, z0, x_ref, data, ref_nfe):
    """The bench's ``main`` rows for one density: every candidate sampled
    unfused and fused, its displacement from the dopri5 samples and hist-L1
    to the data, with the fused sample's largest difference from the
    unfused one and the hyper_step launches it made."""
    rows = []
    for name in cnf_candidates(gp, False):
        row = dict(method=name, nfe=2)
        for fused in (False, True):
            integ, K = cnf_candidates(gp, fused)[name]
            before = LAUNCHES["hyper_step"]
            x, _ = cnf_sample(params, z0, K=K, solver=integ)
            tag = "fused" if fused else "unfused"
            row[f"disp_vs_dopri5_{tag}"] = float(torch.mean(
                torch.linalg.norm(x - x_ref, dim=-1)))
            row[f"hist_l1_vs_data_{tag}"] = hist_l1(x.cpu().numpy(), data)
            if fused:
                row.update(K=K, launches=LAUNCHES["hyper_step"] - before,
                           fused_diff=float((x - x_plain).abs().max()),
                           max_abs_x=float(x_plain.abs().max()))
            x_plain = x
        row.update(hist_l1_dopri5_vs_data=hist_l1(x_ref.cpu().numpy(), data),
                   dopri5_nfe=ref_nfe)
        rows.append(row)
    return rows


def check_cnf(density, train_losses, fit_losses, rows, batched, nll):
    """Raises unless the training NLL and the fit loss fell (the mean of
    the last 10 below the first 10's), every fused sample is within
    FUSED_TOL of max |x| of its unfused twin with exactly 2 x K hyper_step
    launches (two state leaves), HyperHeun's displacement at 2 NFE is
    below Heun's and Euler's there (paper Fig. 1), the batched dopri5's
    endpoints are within CNF_BATCHED_TOL of the lock-step one's, and every
    number (the data's NLL too) is finite."""
    for tag, losses in (("training NLL", train_losses),
                        ("fit loss", fit_losses)):
        if not np.mean(losses[-10:]) < np.mean(losses[:10]):
            raise AssertionError(f"{density}: {tag} did not fall "
                                 f"{losses[:10]} .. {losses[-10:]}")
    for r in rows:
        nums = [v for v in r.values() if isinstance(v, (int, float))]
        if not np.isfinite(nums).all():
            raise AssertionError(f"{density}: non-finite number {r}")
        if r["fused_diff"] > FUSED_TOL * r["max_abs_x"]:
            raise AssertionError(f"{density}: fused differs from unfused {r}")
        if r["launches"] != 2 * r["K"]:
            raise AssertionError(f"{density}: {r['launches']} hyper_step "
                                 f"launches for K {r['K']} ({r['method']})")
    disp = {r["method"]: r for r in rows}
    for tag in ("unfused", "fused"):
        key = f"disp_vs_dopri5_{tag}"
        hyper = disp["hyper_heun@2nfe"][key]
        if not (hyper < disp["heun@2nfe"][key]
                and hyper < disp["euler@2nfe"][key]):
            raise AssertionError(f"{density}: HyperHeun@2 displacement "
                                 f"{hyper} not below Heun's and Euler's "
                                 f"({tag})")
    if not np.isfinite(nll):
        raise AssertionError(f"{density}: the data's NLL is {nll}")
    nums = [v for v in batched.values() if isinstance(v, (int, float))]
    if not np.isfinite(nums).all() or batched["max_diff"] > \
            CNF_BATCHED_TOL * max(1.0, batched["max_abs_x"]):
        raise AssertionError(f"{density}: batched dopri5 disagrees with the "
                             f"lock-step solve {batched}")


def cnf_timings(params, gp, dev):
    """Wall ms (median of 5, between device syncs) and host syncs of a
    2-NFE HyperHeun sample, fused and unfused, and of both dopri5 solves,
    at each size of CNF_TIMED (base draws of seed 43)."""
    aug = exact_trace_dynamics(params)
    gen = torch.Generator(device=dev).manual_seed(43)
    grid = FixedGrid.over(0.0, 1.0, 1)
    out = {}
    for n in CNF_TIMED:
        z0 = torch.randn((n, 2), generator=gen, device=dev)
        runs = {
            "hyper_heun@2nfe_unfused": lambda: cnf_sample(
                params, z0, K=1, solver=hyper_heun(gp)),
            "hyper_heun@2nfe_fused": lambda: cnf_sample(
                params, z0, K=1, solver=hyper_heun(gp, fused=True)),
            "dopri5_lockstep": lambda: odeint_dopri5(
                aug, cnf_state0(z0), grid, atol=CNF_TOL, rtol=CNF_TOL),
            "dopri5_batched": lambda: odeint_dopri5_batched(
                aug, cnf_state0(z0), grid, atol=CNF_TOL, rtol=CNF_TOL),
        }
        for tag, fn in runs.items():
            with count_syncs() as where:         # also the warm-up
                fn()
            out[f"{tag}_{n}"] = dict(
                host_syncs=sum(where.values()),
                ms=float(np.median([synced_ms(fn)[1] for _ in range(5)])))
    return out


def cnf_pipeline(dev, density, train_iters, fit_iters=CNF_FIT_ITERS):
    """One density through train, fit, the dopri5 references and the
    candidates (the main path, launches counted from 0), then the
    timings. Returns (report, launches)."""
    t0 = time.perf_counter()
    LAUNCHES.clear()
    params, train_losses, train_ms = train_cnf(density, dev, train_iters)
    gp, fit_losses, fit_ms, fit_nfes = fit_hyperheun(params, dev, fit_iters)
    aug = exact_trace_dynamics(params)
    z0 = torch.randn((CNF_SAMPLES, 2),
                     generator=torch.Generator(device=dev).manual_seed(42),
                     device=dev)
    data_t = next(density_sampler(density, CNF_SAMPLES, seed=77, device=dev))
    data = data_t.cpu().numpy()
    with torch.no_grad():
        grid = FixedGrid.over(0.0, 1.0, 1)
        ref, ref_nfe = odeint_dopri5(aug, cnf_state0(z0), grid,
                                     atol=CNF_TOL, rtol=CNF_TOL)
        x_ref = ref[0][-1]
        rows = cnf_rows(params, gp, z0, x_ref, data, ref_nfe)
        traj_b, nfe_b = odeint_dopri5_batched(aug, cnf_state0(z0), grid,
                                              atol=CNF_TOL, rtol=CNF_TOL)
        nfe_b = nfe_b.cpu().numpy()
        batched = dict(nfe_min=int(nfe_b.min()),
                       nfe_median=float(np.median(nfe_b)),
                       nfe_max=int(nfe_b.max()), lockstep_nfe=ref_nfe,
                       max_diff=float((traj_b[0][:, -1] - x_ref).abs().max()),
                       max_abs_x=float(x_ref.abs().max()))
        nll = float(cnf_nll(params, data_t))
    launches = dict(LAUNCHES)
    check_cnf(density, train_losses, fit_losses, rows, batched, nll)
    with torch.no_grad():
        timed = cnf_timings(params, gp, dev)
    report = dict(
        train=dict(iters=train_iters, batch=CNF_BATCH, ms_per_step=train_ms,
                   nll_first10=float(np.mean(train_losses[:10])),
                   nll_last10=float(np.mean(train_losses[-10:]))),
        fit=dict(iters=fit_iters, K=1, ms_per_iter=fit_ms,
                 loss_first10=float(np.mean(fit_losses[:10])),
                 loss_last10=float(np.mean(fit_losses[-10:])),
                 dopri5_nfe=fit_nfes),
        data_nll=nll, rows=rows, dopri5_batched=batched, timed=timed,
        launches=launches, seconds=time.perf_counter() - t0)
    return report, launches


def phase_cnf(dev):
    """A main path: the paper's CNF sampling for both densities
    (``cnf_pipeline``), every fused step through hyper_step. Returns the
    launches of their main paths."""
    torch.cuda.reset_peak_memory_stats(dev)
    launches = collections.Counter()
    report = {}
    for density, iters in CNF_TRAIN_ITERS.items():
        report[density], counted = cnf_pipeline(dev, density, iters)
        launches.update(counted)
    emit(phase="cnf", dtype="float32", samples=CNF_SAMPLES,
         fused_tol=FUSED_TOL, **report,
         peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    torch.cuda.empty_cache()
    return launches


# The paper's trajectory-fitting tracker (App. C.1, Fig. 8;
# ``benchmarks/bench_trajectory.py`` in the reference) at its "small"
# budget: a Neural ODE f [z, s] -> 64 -> 64 -> 2 (tanh) trained through
# RK4 at K 32 to track beta(s) = [sin 2 pi s, cos 2 pi s] (AdamW 3e-3,
# batch 8, clip 1.0), a HyperEuler g [z, dz, s] -> 64 -> 64 -> 64 -> 2 fit
# by trajectory fitting at K 16 (``train_hypersolver``, lr 3e-3 -> 1e-4,
# dopri5 targets at 1e-7), and the global error of each solver at K 4, 8,
# 16 and 25 against dopri5 at 1e-8 on 64 initial points.
TRACK_DIM, TRACK_TRAIN_ITERS, TRACK_FIT_ITERS, TRACK_FIT_K = 2, 400, 400, 16
TRACK_KS, TRACK_POINTS = (4, 8, 16, 25), 64
TRACK_SOLVERS = ("euler", "hyper_euler", "midpoint", "rk4")


def beta(s):
    """The bench's ``_beta``: the tracked curve [sin 2 pi s, cos 2 pi s]."""
    return torch.stack([torch.sin(2 * np.pi * s), torch.cos(2 * np.pi * s)],
                       -1)


def tracker_node():
    """The bench's ``_make_node``: f(s, z) = MLP([z, s]), tanh."""
    def f_apply(p, s, x, z):
        return mlp_apply(p, torch.cat([z, depth_column(s, z)], -1),
                         act=torch.tanh)

    return NeuralODE(f_apply=f_apply, hx_apply=lambda p, x: x,
                     hy_apply=lambda p, z: z)


def tracker_z0(gen, n, dev):
    """n initial points beta(0) + 0.05 N(0, I), drawn from ``gen``."""
    return beta(torch.zeros(n, device=dev)) + 0.05 * torch.randn(
        (n, TRACK_DIM), generator=gen, device=dev)


def tracker_train_step(node, K=32):
    """The bench's ``train_tracker`` step: the mean squared distance of
    the RK4 trajectory from beta at the K + 1 knots. (step, optimizer)."""
    grid = FixedGrid.over(0, 1, K)

    def loss_fn(p, z0):
        traj = make_integrator("rk4").solve(node.field(p, None), z0, grid)
        target = beta(grid.s_span.to(z0.device))[:, None, :]
        return torch.mean((traj - target) ** 2)

    opt = adamw(3e-3)
    return make_fit_step(loss_fn, opt, 1.0), opt


def train_tracker(dev, iters, seed=0):
    """The bench's ``train_tracker``: (node, params, losses, ms a step)."""
    node = tracker_node()
    params = mlp_init(torch.Generator(device=dev).manual_seed(seed),
                      (TRACK_DIM + 1, 64, 64, TRACK_DIM), device=dev)
    step, opt = tracker_train_step(node)
    st = opt.init(params)
    gen = torch.Generator(device=dev).manual_seed(1)

    def run(params, st):
        losses = []
        for i in range(iters):
            params, st, loss = step(params, st, i, tracker_z0(gen, 8, dev))
            losses.append(loss)
        return params, losses

    (params, losses), ms = synced_ms(lambda: run(params, st))
    return node, params, [float(l) for l in losses], ms / iters


def tracker_g_apply(gp, eps, s, x, z, dz):
    """The bench's ``_g_apply``: g([z, dz, s]), tanh."""
    return mlp_apply(gp, torch.cat([z, dz, depth_column(s, z)], -1),
                     act=torch.tanh)


def tracker_fit_config(iters, K=TRACK_FIT_K):
    return HypersolverTrainConfig(
        base_solver="euler", K=K, iters=iters, lr=3e-3, lr_min=1e-4,
        atol=1e-7, rtol=1e-7, residual_weight=0.0, trajectory_weight=1.0)


def fit_tracker_hypersolver(node, params, dev, iters, K=TRACK_FIT_K):
    """The bench's ``fit_tracker_hypersolver``: trajectory fitting through
    ``train_hypersolver`` on batches of 16 initial points. (g params,
    losses, ms an iteration)."""
    gp = mlp_init(torch.Generator(device=dev).manual_seed(5),
                  (2 * TRACK_DIM + 1, 64, 64, 64, TRACK_DIM),
                  final_zero=True, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)

    def batches():
        while True:
            yield tracker_z0(gen, 16, dev)

    (gp, losses), ms = synced_ms(lambda: train_hypersolver(
        node, params, tracker_g_apply, gp, batches(),
        tracker_fit_config(iters, K)))
    return gp, losses, ms / iters


def tracker_rows(node, params, gp, z0, z_ref, Ks=TRACK_KS):
    """The bench's ``main`` rows: the global error of each solver at each
    K against ``z_ref``, hyper_euler also fused (its largest difference
    from the unfused solve and the hyper_step launches it made)."""
    f = node.field(params, z0)
    rows = []
    for K in Ks:
        grid = FixedGrid.over(0.0, 1.0, K)
        for name in TRACK_SOLVERS:
            hyper = name == "hyper_euler"
            row = dict(solver=name, K=K)
            for fused in ((False, True) if hyper else (False,)):
                integ = (make_integrator("euler", tracker_g_apply, gp, z0,
                                         fused=fused) if hyper
                         else make_integrator(name))
                before = LAUNCHES["hyper_step"]
                zT = integ.solve(f, z0, grid, return_traj=False)
                err = float(torch.mean(torch.linalg.norm(zT - z_ref, dim=-1)))
                if fused:
                    row.update(global_err_fused=err,
                               launches=LAUNCHES["hyper_step"] - before,
                               fused_diff=float((zT - z_plain).abs().max()),
                               max_abs_z=float(z_plain.abs().max()))
                else:
                    row["global_err"], z_plain = err, zT
            row["nfe"] = integ.nfe(K)
            rows.append(row)
    return rows


def check_tracking(train_losses, fit_losses, rows):
    """Raises unless both losses fell (the mean of the last 10 below the
    first 10's), HyperEuler's global error at K 16 (its fitted mesh) is
    below Euler's (paper Fig. 8), and every fused solve is within
    FUSED_TOL of max |zT| of the unfused one with exactly K hyper_step
    launches."""
    for tag, losses in (("training loss", train_losses),
                        ("fit loss", fit_losses)):
        if not np.mean(losses[-10:]) < np.mean(losses[:10]):
            raise AssertionError(f"tracker: {tag} did not fall "
                                 f"{losses[:10]} .. {losses[-10:]}")
    for r in rows:
        if not np.isfinite(r["global_err"]):
            raise AssertionError(f"tracker: non-finite error {r}")
        if r["solver"] != "hyper_euler":
            continue
        if r["fused_diff"] > FUSED_TOL * r["max_abs_z"]:
            raise AssertionError(f"tracker: fused differs from unfused {r}")
        if r["launches"] != r["K"]:
            raise AssertionError(f"tracker: {r['launches']} hyper_step "
                                 f"launches for K {r['K']}")
    at = {r["solver"]: r for r in rows if r["K"] == TRACK_FIT_K}
    for key in ("global_err", "global_err_fused"):
        if not at["hyper_euler"][key] < at["euler"]["global_err"]:
            raise AssertionError(f"tracker: HyperEuler ({key}) does not "
                                 f"beat Euler at K {TRACK_FIT_K}")


def phase_tracking(dev, train_iters=TRACK_TRAIN_ITERS,
                   fit_iters=TRACK_FIT_ITERS):
    """A main path: the trajectory-fitting tracker, train, fit, the dopri5
    reference and the solver rows (launches counted from 0), every fused
    step through hyper_step. Returns the launches."""
    t0 = time.perf_counter()
    LAUNCHES.clear()
    node, params, train_losses, train_ms = train_tracker(dev, train_iters)
    gp, fit_losses, fit_ms = fit_tracker_hypersolver(node, params, dev,
                                                     fit_iters)
    z0 = tracker_z0(torch.Generator(device=dev).manual_seed(9), TRACK_POINTS,
                    dev)
    with torch.no_grad():
        with count_syncs() as where:
            ref, _, ref_nfe = node.reference_trajectory(
                params, z0, K=TRACK_FIT_K, atol=1e-8, rtol=1e-8)
        rows = tracker_rows(node, params, gp, z0, ref[-1])
    launches = dict(LAUNCHES)
    check_tracking(train_losses, fit_losses, rows)
    emit(phase="tracking", dtype="float32", points=TRACK_POINTS,
         fused_tol=FUSED_TOL,
         train=dict(iters=train_iters, K=32, ms_per_step=train_ms,
                    loss_first10=float(np.mean(train_losses[:10])),
                    loss_last10=float(np.mean(train_losses[-10:]))),
         fit=dict(iters=fit_iters, K=TRACK_FIT_K, ms_per_iter=fit_ms,
                  loss_first10=float(np.mean(fit_losses[:10])),
                  loss_last10=float(np.mean(fit_losses[-10:]))),
         dopri5=dict(tol=1e-8, K=TRACK_FIT_K, nfe=ref_nfe,
                     host_syncs=sum(where.values())),
         rows=rows, launches=launches, seconds=time.perf_counter() - t0)
    return launches


# --------------------------------------------------------------- training ----
# The trainer (``python -m repro_torch.launch.train``, ``launch/steps.py``)
# on the card: AdamW over the warmup-cosine schedule, the global-norm
# clip, params and moments updated in place leaf by leaf; the flash,
# RG-LRU and WKV6 kernels in the forward; in the backward flash's plain
# version differentiated (``_Flash``) and the scans' backward operators
# (``repro_torch::rglru_scan_backward``, ``repro_torch::wkv6_backward``:
# the plain loops' gradients as recurrences backward in time).
# Full width for the three dense families at 8 x 128 tokens a step
# (OLMoE-1B-7B's 6.92 B parameters need ~83 GB at rest in training: it
# trains reduced only, in the fault phase's place on the CPU tests).
TRAIN_CLI_STEPS, TRAIN_STEPS = 20, 5
# The float32 step's kernel route against the all-plain one: the largest
# difference of the gradient tree (and of the updated params) over its
# largest value, between the sound readings' largest and the planted
# fault's (``gradless_kernels``) smallest, read by tools/train_smoke.py
# --fp32-seeds 13 14 15 16 17 on the H100 (PERF.md section 6): sound
# 5.1e-7 / 2.2e-7 / 2.7e-3, fault 0.50 / 4.3e-3 / 1.0. RWKV6's sound
# gradients differ most in the first block's u, wk and wr: the model's
# own conditioning, since the all-plain float32 step is as far from a
# float64 step in those leaves (tools/rwkv6_fp32_gap.py, PERF.md).
TRAIN_FP32_TOL = {"qwen3_4b": 1e-4, "recurrentgemma_2b": 1e-4,
                  "rwkv6_1p6b": 2e-2, "whisper_base": 1e-4}
# bytes a parameter holds at rest in training: bf16 param and grad,
# float32 mu and nu
TRAIN_BYTES_PER_PARAM = 2 + 2 + 4 + 4
# (kernel, case, shape, dtype or with-state, window): phase_train_kernels
TRAIN_KERNEL_CASES = [
    ("flash_attention", "qwen3", (8, 128, 32, 8, 128), torch.bfloat16, None),
    ("flash_attention", "griffin", (8, 128, 10, 1, 256), torch.bfloat16,
     2048),
    ("flash_attention", "nemotron", (8, 128, 96, 8, 192), torch.bfloat16,
     None),
    ("rglru_scan", "serve", (8, 128, 2560), torch.float32, None),
    ("rglru_scan", "serve-bf16", (8, 128, 2560), torch.bfloat16, None),
    ("rwkv6_scan", "serve", (8, 128, 32, 64), False, None),
    ("rwkv6_scan", "state", (8, 128, 32, 64), True, None),
]


def train_case_inputs(kernel, shape, kind, window, gen, dev):
    """(inputs, route, plain, check) of one TRAIN_KERNEL_CASES row: the
    wrapper as the model calls it, the plain version, and the forward
    check of the kernel's phase (flash within FLASH_TOL, RG-LRU bit for
    bit, WKV6 within RWKV6_TOL of the largest output, S_T bit for bit);
    route and plain return a tuple of outputs."""
    def randn(*s):
        return torch.randn(s, generator=gen, device=dev)

    if kernel == "flash_attention":
        b, s, h, kv, hd = shape
        ins = [randn(b, s, n, hd).to(kind) for n in (h, kv, kv)]
        tol = FLASH_TOL[kind]

        def check(o, p):
            if not torch.allclose(o[0].float(), p[0].float(), rtol=tol,
                                  atol=tol):
                raise AssertionError("flash_attention: kernel route "
                                     "disagrees with plain")
        return (ins, lambda q, k, v: (fa_ops.flash_attention(
            q, k, v, causal=True, window=window),),
            lambda q, k, v: (attention_ref(q, k, v, causal=True,
                                           window=window),), check)
    if kernel == "rglru_scan":
        def check(o, p):
            if not torch.equal(o[0], p[0]):
                raise AssertionError("rglru_scan: kernel route disagrees "
                                     "with plain")
        return (list(rglru_inputs(shape, kind, gen, dev)),
                lambda a, b: (rg_ops.rglru_scan(a, b),),
                lambda a, b: (rglru_scan_ref(a, b),), check)
    b, t, h, d = shape
    state = kind
    r, k, v, w, u = rwkv6_inputs(shape, torch.bfloat16, gen, dev)
    S0 = randn(b, h, d, d) if state else None
    n_out = 2 if state else 1

    def route(*x):
        out = rw_ops.wkv6(*x, want_state=state)
        return tuple(out) if state else (out,)

    def check(o, p):
        err = float((o[0] - p[0]).detach().abs().max())
        if err > RWKV6_TOL * float(p[0].detach().abs().max()) or (
                state and not torch.equal(o[1], p[1])):
            raise AssertionError("rwkv6_scan: kernel route disagrees with "
                                 "plain")
    return ([r, k, v, w, u, S0], route,
            lambda *x: wkv6_scan_ref(*x)[:n_out], check)


def phase_train_kernels(dev, cases=TRAIN_KERNEL_CASES):
    """The kernels' training routes against the plain versions on the
    card, at the full-width models' training shapes: the forward within
    each kernel phase's limit; the gradient of every input (every input
    requires grad) against the all-plain version's at the same inputs and
    output gradients, equal bit for bit for flash (its backward is the
    plain version's) and RG-LRU (its backward kernel rounds as autograd of
    the plain loop does), within RWKV6_GRAD_TOL of each input's largest
    gradient for WKV6 (``grad_gap``: its backward kernel regroups five
    sums), where the plain backward operator, called on the card at the
    same inputs, is also held equal bit for bit to autograd of the plain
    loop; the forward kernel once in the forward and never in the
    backward, each scan's backward kernel once in the backward and never
    in the forward (flash has none). Times the route's forward + backward
    against the plain version's (cold L2); the comparison's launches
    count for no path."""
    gen = torch.Generator(device=dev).manual_seed(21)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for kernel, name, shape, kind, window in cases:
        ins, route, plain, check = train_case_inputs(kernel, shape, kind,
                                                     window, gen, dev)
        leaf = lambda: [None if t is None else
                        t.detach().clone().requires_grad_() for t in ins]
        mine, ref = leaf(), leaf()
        back = kernel + "_backward"
        LAUNCHES.clear()
        outs = route(*mine)
        fwd = (LAUNCHES[kernel], LAUNCHES[back])
        gs = [torch.randn(o.shape, generator=gen, device=dev) for o in outs]
        torch.autograd.backward(outs, gs)
        bwd = (LAUNCHES[kernel] - fwd[0], LAUNCHES[back] - fwd[1])
        want = plain(*ref)
        torch.autograd.backward(want, gs)
        torch.cuda.synchronize()
        check(outs, want)
        if (fwd, bwd) != ((1, 0), (0, int(kernel != "flash_attention"))):
            raise AssertionError(f"{kernel} {name}: (forward kernel, "
                                 f"backward kernel) launches {fwd} in the "
                                 f"forward, {bwd} in the backward")
        tol = RWKV6_GRAD_TOL if kernel == "rwkv6_scan" else None
        diffs, rel, equal = {}, {}, True
        for i, (a, b) in enumerate(zip(mine, ref)):
            if a is None:
                continue
            if a.grad is None or b.grad is None or a.grad.dtype != \
                    b.grad.dtype:
                raise AssertionError(f"{kernel} {name}: input {i} has "
                                     "no gradient or another dtype")
            diffs[i] = float((a.grad.float() - b.grad.float()).abs().max())
            rel[i], fits = grad_gap(a.grad, b.grad, tol or 0.0)
            equal = equal and torch.equal(a.grad, b.grad)
            if not (torch.equal(a.grad, b.grad) if tol is None else fits):
                raise AssertionError(
                    f"{kernel} {name}: input {i}'s gradient differs from "
                    f"the plain version's by up to {diffs[i]} ({rel[i]} "
                    f"of its largest value; tol {tol})")
        plain_op_equal = None
        if kernel == "rwkv6_scan":
            got = wkv6_scan_backward_ref(
                gs[0], gs[1] if len(gs) > 1 else None,
                *[None if t is None else t.detach() for t in ins])
            plain_op_equal = all(b is None or torch.equal(x, b.grad)
                                 for x, b in zip(got, ref))
            if not plain_op_equal:
                raise AssertionError(f"{kernel} {name}: the plain backward "
                                     "operator differs from autograd of "
                                     "the plain loop")
        live = [t for t in mine if t is not None]
        ms = time_ms(lambda: torch.autograd.grad(route(*mine), live, gs),
                     flush, reps=10)
        plain_ms = time_ms(lambda: torch.autograd.grad(plain(*ref), [
            t for t in ref if t is not None], gs), flush, reps=10)
        rows.append(dict(kernel=kernel, case=name, shape=list(shape),
                         dtype=("r, k, v, u bf16, w fp32" + (
                             ", S0 fp32" if kind else "")
                             if kernel == "rwkv6_scan"
                             else str(kind).replace("torch.", "")),
                         launches=dict(forward=fwd, backward=bwd),
                         grad_max_abs_diff=max(diffs.values()),
                         grad_max_rel_diff=max(rel.values()), tol=tol,
                         grads_bit_equal=equal,
                         plain_backward_op_bit_equal=plain_op_equal,
                         ms_forward_backward=ms,
                         plain_ms_forward_backward=plain_ms))
        del ins, mine, ref, outs, want, gs, live
    emit(phase="train_kernels", cases=rows)
    torch.cuda.empty_cache()
    return rows


class SyncedWatchdog(StepWatchdog):
    """The trainer's watchdog, with each step's synced wall time beside
    its own: ``step_times`` (the watchdog's, the host's dispatch of the
    step, as the reference times it) and ``synced`` (device synced before
    the call and after the NaN screen)."""

    def __init__(self, cfg=None):
        super().__init__(cfg or WatchdogConfig())
        self.synced = []

    def run(self, fn, *args, loss_of=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return super().run(fn, *args, loss_of=loss_of)
        finally:
            torch.cuda.synchronize()
            self.synced.append(time.perf_counter() - t0)


@contextlib.contextmanager
def synced_watchdogs():
    """While open, ``train_loop`` makes its default watchdog a
    ``SyncedWatchdog``; yields the ones made."""
    made = []
    orig = train.StepWatchdog

    def make(cfg):
        made.append(SyncedWatchdog(cfg))
        return made[-1]

    train.StepWatchdog = make
    try:
        yield made
    finally:
        train.StepWatchdog = orig


def event_timed(events, key, fn):
    """``fn`` with each call bracketed by CUDA events kept in
    ``events[key]``."""
    def run(*args, **kwargs):
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        out = fn(*args, **kwargs)
        pair[1].record()
        events[key].append(pair)
        return out
    return run


@contextlib.contextmanager
def timed_step_parts():
    """While open, each backward of the kernels' training routes (flash's
    plain backward, ``_Flash.backward``; the scans' backward operators as
    their autograd registrations call them, ``rg_ops._scan_backward`` and
    ``rw_ops._wkv6_backward``: the backward kernels, or their plain
    versions under ``plain_scan_backwards``) and each forward + backward
    of a train step (``steps._value_and_grad``, keyed
    ``forward_backward``) is bracketed by CUDA events; yields ``{key:
    [(start, end), ...]}`` (``step_part_ms`` reads them per step). The rest
    of a step is the clip and the in-place AdamW update."""
    routes = {"flash_attention": (fa_ops._Flash, "backward"),
              "rglru_scan_backward": (rg_ops, "_scan_backward"),
              "rwkv6_scan_backward": (rw_ops, "_wkv6_backward")}
    events = collections.defaultdict(list)
    saved = {k: vars(o)[a] for k, (o, a) in routes.items()}
    value_and_grad = steps._value_and_grad
    for k, (o, a) in routes.items():
        timed = event_timed(events, k, getattr(o, a))
        setattr(o, a, staticmethod(timed) if isinstance(o, type) else timed)
    steps._value_and_grad = event_timed(events, "forward_backward",
                                        value_and_grad)
    try:
        yield events
    finally:
        steps._value_and_grad = value_and_grad
        for k, (o, a) in routes.items():
            setattr(o, a, saved[k])


@contextlib.contextmanager
def plain_scan_backwards():
    """While open, the scans' autograd registrations call the backward
    operators' plain versions (``ref.py``, the loops backward in time) in
    place of the backward kernels, on the card: the training step as it
    ran before the backward kernels, for a comparison in one process."""
    with attributes_swapped([
            (rg_ops, "_scan_backward", rglru_scan_backward_ref),
            (rw_ops, "_wkv6_backward", wkv6_scan_backward_ref)]):
        yield


def step_part_ms(events, steps):
    """Device ms of each step per key of ``timed_step_parts`` (a key's
    events split evenly over the steps, in order)."""
    torch.cuda.synchronize()
    out = {}
    for k, v in events.items():
        per = len(v) // steps
        out[k] = [float(sum(s.elapsed_time(e) for s, e in
                            v[i * per:(i + 1) * per]))
                  for i in range(steps)]
    return out


def moved_share(params, cfg, dev, seed=0):
    """Share of parameter elements that differ from ``init_lm``'s draw
    (``init_encdec``'s for an encoder-decoder config) at ``seed``
    (train_loop's init), drawn again leaf by leaf."""
    init = (init_encdec if cfg.is_encdec else init_lm)(
        torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    moved = sum(int((a != b).sum()) for a, b in zip(
        pytree.tree_leaves(params), pytree.tree_leaves(init)))
    del init
    torch.cuda.empty_cache()
    return moved / lm.count_params(params)


def train_report(tag, cfg, params, hist, dog, events, launches, blocks,
                 dev, batch=B, seq=S, scan_backward_kernels=True):
    """Checks a full-width training run (losses and grad norms finite,
    params moved, each kernel once per block application and step, each
    scan's backward kernel as often as its forward kernel, or never with
    ``scan_backward_kernels`` false) and its numbers: synced ms a step
    (median after the first), tokens/s, peak memory against the
    reckoning, the model-FLOP bound's share (6 N tokens over the bf16
    peak, N every parameter), the device ms of a forward + backward (the
    rest of the synced step is the clip, the update and the host's gaps)
    and each timed backward's ms and share of the step (flash's plain
    backward, the scans' backward operators), each the median over the
    steps after the first."""
    vals = [h[k] for h in hist for k in ("loss", "grad_norm")]
    if not np.isfinite(vals).all():
        raise AssertionError(f"{tag}: non-finite loss or grad norm {hist}")
    check_block_launches(launches, blocks, tag)
    for kernel in ("rglru_scan", "rwkv6_scan"):
        want = launches.get(kernel, 0) if scan_backward_kernels else 0
        if launches.get(kernel + "_backward", 0) != want:
            raise AssertionError(f"{tag}: {kernel}_backward launched "
                                 f"{launches.get(kernel + '_backward', 0)} "
                                 f"times, {kernel} {launches.get(kernel, 0)}")
    steps = len(hist)
    if sum(blocks.values()) != cfg.n_layers * steps:
        raise AssertionError(f"{tag}: {blocks} block applications in "
                             f"{steps} steps of {cfg.n_layers} layers")
    moved = moved_share(params, cfg, dev)
    if not moved > 0:
        raise AssertionError(f"{tag}: no parameter moved in {steps} steps")
    n = lm.count_params(params)
    # medians over the steps after the first (which allocates and warms)
    step_s = float(np.median(dog.synced[1:]))
    parts = {k: float(np.median(v[1:]))
             for k, v in step_part_ms(events, steps).items()}
    fwd_bwd = parts.pop("forward_backward")
    MEASURED["train"][cfg.name] = step_s * 1e3
    return dict(
        arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        dtype=cfg.dtype, batch=batch, seq=seq, steps=steps,
        losses=[h["loss"] for h in hist],
        grad_norms=[h["grad_norm"] for h in hist],
        params=n, moved_share=moved,
        ms_per_step_synced=step_s * 1e3,
        synced_ms=[t * 1e3 for t in dog.synced],
        watchdog_ms=[t * 1e3 for t in dog.step_times],
        tokens_per_s=batch * seq / step_s,
        peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        reckoning_at_rest_gb=n * TRAIN_BYTES_PER_PARAM / 1e9,
        model_flop_bound_ms=6 * n * batch * seq / BF16_PEAK * 1e3,
        model_flop_share=6 * n * batch * seq / BF16_PEAK / step_s,
        forward_backward_ms_per_step=fwd_bwd,
        clip_and_update_ms_per_step=step_s * 1e3 - fwd_bwd,
        backward_ms_per_step=parts,
        backward_share={k: v / (step_s * 1e3) for k, v in parts.items()},
        launches=launches, block_applications=blocks)


def phase_train_cli(dev):
    """A main path through the trainer's CLI: full-width qwen3_4b, 8 x 128
    tokens, TRAIN_CLI_STEPS steps, the CLI's settings (remat none,
    zero_opt off, lr 3e-4 under the warmup-cosine schedule), no
    checkpoint (one would write ~48 GB). Raises unless every loss and
    grad norm is finite, the params moved and flash launched exactly
    once per attention block and step; prints ``train_report``'s
    numbers. Returns the launches."""
    cfg = get("qwen3_4b")
    torch.cuda.reset_peak_memory_stats(dev)
    LAUNCHES.clear()
    with count_blocks() as blocks, synced_watchdogs() as dogs, \
            timed_step_parts() as bwd:
        out = train.main(["--arch", "qwen3_4b", "--steps",
                          str(TRAIN_CLI_STEPS), "--batch", str(B), "--seq",
                          str(S), "--log-every", "5"])
    launches, blocks = dict(LAUNCHES), dict(blocks)
    tag = "qwen3_4b train cli"
    report = train_report(tag, cfg, out["params"], out["history"], dogs[0],
                          bwd, launches, blocks, dev)
    emit(phase="train_cli", cli_wall_s=out["seconds"], **report)
    del out
    release_card()
    return launches


def phase_train(dev):
    """A main path through ``train_loop``: full-width recurrentgemma_2b and
    rwkv6_1p6b, TRAIN_STEPS steps each of 8 x 128 tokens with the CLI's
    settings; the batches are ``token_batches``' on the host, placed by a
    ``ShardedLoader`` (pinned, non-blocking copies). The same checks and
    numbers as ``phase_train_cli``, each model first with the scans'
    backward operators swapped for their plain versions
    (``plain_scan_backwards``: the step as it ran before the backward
    kernels, ``phase="train_plain_backward"``, launches not counted),
    then as it runs (the main path). Then one float32 step of each dense
    family at ``FP32_DECODE_LAYERS`` depth and full width
    (``train_fp32_step``, ``check_train_fp32``): the kernel route's
    gradient tree and updated params within TRAIN_FP32_TOL of the largest
    value of the same step with every kernel swapped for its plain
    version, and a planted fault (the kernels without a training route,
    dropping their gradients) outside it.
    Returns the launches."""
    # both vocabularies exceed the stream's 512-token alphabet, so one
    # host stream serves both models
    host = list(itertools.islice(token_batches(
        get("rwkv6_1p6b").vocab, B, S, seed=0, device="cpu"), TRAIN_STEPS))
    settings = StepSettings(remat="none", zero_opt=False)
    launches = collections.Counter()
    for arch, kernels in itertools.product(
            ("recurrentgemma_2b", "rwkv6_1p6b"), (False, True)):
        cfg = get(arch)
        loader = ShardedLoader(({"tokens": t, "targets": y} for t, y in host),
                               device=dev)
        dog = SyncedWatchdog()
        torch.cuda.reset_peak_memory_stats(dev)
        LAUNCHES.clear()
        with count_blocks() as blocks, (contextlib.nullcontext() if kernels
                                        else plain_scan_backwards()), \
                timed_step_parts() as bwd:
            params, opt_state, hist = train.train_loop(
                cfg, settings, TRAIN_STEPS, loader, watchdog=dog, device=dev)
        del opt_state
        counted, blocks = dict(LAUNCHES), dict(blocks)
        if kernels:
            launches.update(counted)
        report = train_report(f"{arch} train", cfg, params, hist, dog,
                              bwd, counted, blocks, dev,
                              scan_backward_kernels=kernels)
        emit(phase="train" if kernels else "train_plain_backward", **report)
        del params, loader
        release_card()
    fp32 = {arch: train_fp32_step(dev, arch, n, host[0])
            for arch, n in FP32_DECODE_LAYERS.items()}
    emit(phase="train_fp32", tol=TRAIN_FP32_TOL, **fp32)
    for arch, r in fp32.items():
        check_train_fp32(arch, r)
    return launches


@contextlib.contextmanager
def swapped_kernels(flash, rglru, wkv6):
    """While open, the layers call these in place of the kernel wrappers
    (``nn/attention.py``, ``nn/rglru.py``, ``nn/rwkv6.py``)."""
    from repro_torch.nn import attention as nn_attention
    from repro_torch.nn import rglru as nn_rglru
    from repro_torch.nn import rwkv6 as nn_rwkv6
    with attributes_swapped([(nn_attention, "flash_attention", flash),
                             (nn_rglru, "rglru_scan", rglru),
                             (nn_rwkv6, "wkv6", wkv6)]):
        yield


@contextlib.contextmanager
def attributes_swapped(swaps):
    """While open, each ``(module, name, value)`` of ``swaps`` is set;
    the old values come back after."""
    saved = [getattr(m, n) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for (m, n, _), f in zip(swaps, saved):
            setattr(m, n, f)


@contextlib.contextmanager
def plain_kernels():
    """Every layer calls its kernel's plain version (the ``ref.py``): the
    all-plain model the kernel routes are held against."""
    def wkv6_plain(r, k, v, w, u, S0=None, *, want_state=False):
        o, S_T = wkv6_scan_ref(r, k, v, w, u, S0)
        return (o, S_T) if want_state else o

    with swapped_kernels(
            lambda q, k, v, causal=True, window=None:
            attention_ref(q, k, v, causal=causal, window=window),
            rglru_scan_ref, wkv6_plain):
        yield


@contextlib.contextmanager
def gradless_kernels():
    """A planted fault: every layer launches its kernel with no training
    route, so its output carries no gradient (the scan wrappers before
    the trainer's slice): what the float32 step's check must catch."""
    def rglru_gradless(a, b):
        with torch.no_grad():
            return rg_ops.rglru_scan(a, b)

    def wkv6_gradless(r, k, v, w, u, S0=None, *, want_state=False):
        with torch.no_grad():
            return rw_ops.wkv6(r, k, v, w, u, S0, want_state=want_state)

    with swapped_kernels(
            lambda q, k, v, causal=True, window=None:
            fa_ops._forward(q, k, v, causal, window),
            rglru_gradless, wkv6_gradless):
        yield


def leaf_names(tree, prefix=""):
    """'/'-joined dict keys of each leaf, in ``pytree.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in leaf_names(v, f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def tree_diff(a, b, names):
    """The largest |a - b| over two leaf lists against b's largest |value|,
    and the three leaves with the largest difference."""
    diffs = [float((x - y).abs().max()) for x, y in zip(a, b)]
    top = sorted(zip(diffs, names, [float(y.abs().max()) for y in b]),
                 reverse=True)[:3]
    return dict(max_abs_diff=max(diffs),
                max_abs=max(float(y.abs().max()) for y in b),
                top=[dict(leaf=n, diff=d, leaf_max=m) for d, n, m in top])


def train_fp32_step(dev, arch, n_layers, batch, seed=13):
    """One float32 train step at ``n_layers`` (an encoder-decoder's
    encoder and decoder each), full width, from the same params, through
    the kernel routes, through the plain versions, and through the
    planted fault (``gradless_kernels``), params drawn from ``seed``:
    each route's gradient tree and updated params against the plain
    route's (``tree_diff``), the loss of each, and the launches of the
    kernel route. ``batch``: (tokens, targets), or a dict of the step's
    inputs."""
    cfg = dataclasses.replace(get(arch), n_layers=n_layers, dtype="float32",
                              param_dtype="float32")
    if cfg.is_encdec:
        cfg = dataclasses.replace(cfg, enc_layers=n_layers,
                                  dec_layers=n_layers)
    settings = StepSettings(remat="none", zero_opt=False, lr=1e-2)
    step_fn, opt = make_train_step(cfg, settings)
    if not isinstance(batch, dict):
        batch = {"tokens": batch[0], "targets": batch[1]}
    batch = {k: v.to(dev) for k, v in batch.items()}
    params0 = (init_encdec if cfg.is_encdec else init_lm)(
        torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    names = leaf_names(params0)

    def loss_fn(p, mb):
        if cfg.is_encdec:
            return encdec.encdec_loss(p, cfg, mb["frames"], mb["tokens"],
                                      mb["targets"])
        return lm.lm_loss(p, cfg, mb["tokens"], mb["targets"])

    out = {}
    for route, ctx in (("kernel", contextlib.nullcontext),
                       ("plain", plain_kernels),
                       ("gradless", gradless_kernels)):
        params = pytree.tree_map(torch.clone, params0)
        st = opt.init(params)
        LAUNCHES.clear()
        with ctx():
            _, _, grads = steps._value_and_grad(loss_fn, params, batch)
            params, st, met = step_fn(params, st, 0, batch)
        out[route] = (grads, pytree.tree_leaves(params), float(met["loss"]),
                      sum(LAUNCHES.values()))
        del st, params
    report = dict(layers=n_layers, launches=out["kernel"][3],
                  plain_launches=out["plain"][3],
                  largest_update=max(float((x - y).abs().max()) for x, y in
                                     zip(out["plain"][1],
                                         pytree.tree_leaves(params0))))
    for route in ("kernel", "gradless"):
        report[route] = dict(
            loss=out[route][2], plain_loss=out["plain"][2],
            grads=tree_diff(out[route][0], out["plain"][0], names),
            params=tree_diff(out[route][1], out["plain"][1], names))
    del out, params0
    torch.cuda.empty_cache()
    return report


def check_train_fp32(arch, r):
    """The kernel route within TRAIN_FP32_TOL[arch] of the largest value of
    the plain route's gradient tree and updated params, the planted fault
    outside it, the kernels launched through the kernel route only, and
    the params moved."""
    tol = TRAIN_FP32_TOL[arch]
    rel = lambda d: d["max_abs_diff"] / d["max_abs"]
    bad = []
    if not (rel(r["kernel"]["grads"]) <= tol
            and rel(r["kernel"]["params"]) <= tol):
        bad.append("the kernel route is off the plain one")
    if not rel(r["gradless"]["grads"]) > tol:
        bad.append("the planted fault went unseen")
    if r["launches"] == 0 or r["plain_launches"] != 0 \
            or not r["largest_update"] > 0:
        bad.append("launches or update wrong")
    if bad:
        raise AssertionError(f"{arch} fp32 step: {'; '.join(bad)}: {r}")


def train_remat(cfg, batch, dev):
    """One value-and-grad of ``lm_loss`` under each remat policy on the
    card: ``"dots"`` and ``"full"`` give ``"none"``'s loss and gradients
    (within 1e-6 of the largest gradient: the embedding's backward
    accumulates with atomics), and launch flash once per dense block in
    the forward and once more in the recompute."""
    params = init_lm(torch.Generator(device=dev).manual_seed(3), cfg,
                     device=dev)
    batch = {"tokens": batch[0], "targets": batch[1]}
    out = {}
    for remat in lm.REMAT_POLICIES:
        LAUNCHES.clear()
        loss, _, grads = steps._value_and_grad(
            lambda p, mb: lm.lm_loss(p, cfg, mb["tokens"], mb["targets"],
                                     remat=remat), params, batch)
        out[remat] = (float(loss), grads, LAUNCHES["flash_attention"])
    loss0, g0, n0 = out["none"]
    g_max = max(float(g.abs().max()) for g in g0)
    report = {}
    for remat in ("dots", "full"):
        loss, g, n = out[remat]
        diff = max(float((a - b).abs().max()) for a, b in zip(g, g0))
        report[remat] = dict(loss_equal=loss == loss0, grad_max_abs_diff=diff,
                             grads_bit_equal=all(torch.equal(a, b)
                                                 for a, b in zip(g, g0)),
                             flash_launches=n)
        if loss != loss0 or diff > 1e-6 * g_max or n != 2 * n0 \
                or n0 != cfg.n_layers:
            raise AssertionError(f"{cfg.name} remat {remat}: {report} "
                                 f"(none: {n0} launches, largest gradient "
                                 f"{g_max})")
    return report


def phase_train_faults(dev):
    """tests/test_fault_tolerance.py's three scenarios on the card, through
    ``train_loop`` with reduced qwen3_4b (float32), batch 4 x 32 of the
    seed-5 stream, checkpoints under build/: (1) failures at steps 6 and
    9 with checkpoints every 4 give the uninterrupted 12-step run's
    losses at rtol 1e-4 (the embedding's backward accumulates with
    atomics, so a replay may differ in the last bits), with 2 restarts;
    (2) a failure at step 2 on every attempt exhausts a budget of 2 and
    raises ``StepFailure``; (3) a second loop on a 4-step run's directory
    resumes at step 4 and runs 4 steps. And ``train_remat`` on the first
    batch. Returns the launches of the scenarios (flash once per dense
    block application, checked)."""
    cfg = get("qwen3_4b").reduced()
    settings = StepSettings(microbatches=1, remat="none", zero_opt=False,
                            lr=1e-3)
    host = list(itertools.islice(token_batches(cfg.vocab, 4, 32, seed=5,
                                               device=dev), 12))

    class Replayable:
        def __iter__(self):
            return ({"tokens": t, "targets": y} for t, y in host)

    root = os.path.join(BUILD, "train_faults")
    shutil.rmtree(root, ignore_errors=True)
    LAUNCHES.clear()
    with count_blocks() as blocks:
        _, _, ref = train.train_loop(cfg, settings, 12, Replayable(),
                                     device=dev)
        wd = StepWatchdog(WatchdogConfig(max_restarts=5))
        _, _, hist = train.train_loop(
            cfg, settings, 12, Replayable(),
            ckpt=CheckpointManager(os.path.join(root, "ft"), keep=3),
            ckpt_every=4, injector=FailureInjector(fail_at=(6, 9)),
            watchdog=wd, device=dev)

        class AlwaysFail(FailureInjector):
            def maybe_fail(self, step):
                if step == 2:
                    raise StepFailure("permanent")

        budget = StepWatchdog(WatchdogConfig(max_restarts=2))
        try:
            train.train_loop(cfg, settings, 5, Replayable(),
                             ckpt=CheckpointManager(
                                 os.path.join(root, "budget"), keep=2),
                             ckpt_every=1, injector=AlwaysFail(),
                             watchdog=budget, device=dev)
            raised = False
        except StepFailure:
            raised = True
        ckpt = CheckpointManager(os.path.join(root, "elastic"), keep=2)
        _, _, h1 = train.train_loop(cfg, settings, 4, Replayable(),
                                    ckpt=ckpt, ckpt_every=2, device=dev)
        _, _, h2 = train.train_loop(cfg, settings, 8, Replayable(),
                                    ckpt=ckpt, ckpt_every=4, device=dev)
    launches, blocks = dict(LAUNCHES), dict(blocks)
    shutil.rmtree(root, ignore_errors=True)
    tag = "qwen3_4b reduced train faults"
    check_block_launches(launches, blocks, tag)
    want = {h["step"]: h["loss"] for h in ref}
    got = {h["step"]: h["loss"] for h in hist}
    rel = max(abs(got[s] - want[s]) / abs(want[s]) for s in want) \
        if set(got) == set(want) else float("inf")
    if wd.restarts != 2 or not rel <= 1e-4:
        raise AssertionError(f"{tag}: restarts {wd.restarts}, losses of "
                             f"the interrupted run {rel} off the "
                             "uninterrupted run's")
    if not raised or budget.restarts != 3:
        raise AssertionError(f"{tag}: an exhausted budget did not raise "
                             f"(restarts {budget.restarts})")
    if h2[0]["step"] != 4 or len(h2) != 4:
        raise AssertionError(f"{tag}: the second loop ran steps "
                             f"{[h['step'] for h in h2]}")
    remat = train_remat(cfg, host[0], dev)
    emit(phase="train_faults", arch=cfg.name, layers=cfg.n_layers,
         batch=4, seq=32, remat=remat, restarts=wd.restarts,
         replay_max_rel_diff=rel,
         replay_bit_equal=got == want, losses=[h["loss"] for h in ref],
         budget_restarts=budget.restarts,
         resumed_steps=[h["step"] for h in h2],
         resumed_equal=[h["loss"] for h in h1 + h2]
         == [want.get(h["step"]) for h in h1 + h2],
         launches=launches, block_applications=blocks)
    return launches


# ----------------------------------------------- PaliGemma and Whisper ----
# Full-width paligemma_3b (hf:google/paligemma-3b: the Gemma-2B decoder, 18
# layers, d 2048, MQA 8/1 of 256, GeGLU 16384, vocab 257216; 2.51 B
# parameters, 5.03 GB in bf16) with its patch frontend: 8 requests, each
# 256 patch embeddings (a seeded numpy normal, the SigLIP stub) before 128
# text tokens, 384 positions. Full-width whisper_base (arXiv:2212.04356: 6 +
# 6 layers, d 512, MHA 8/8 of 64, GELU 2048, vocab 51865; 121.0 M
# parameters with the reference's 65,536- and 32,768-row position tables)
# on frames (8, 1500, 512) and 128 decoder tokens.
PALI_TEXT = S
PALI_KS = (3, 6, 9, 18)
WHISPER_FRAMES, WHISPER_TOKENS = 1500, 128
# float32 checks at reduced depth, full width: PaliGemma at 4 layers (the
# fused-vs-unfused check), Whisper at 2 + 2 layers (the train step)
PALI_FP32_LAYERS, WHISPER_FP32_LAYERS = 4, 2
# Teacher-forced cached decode of Whisper (bf16, 32 steps against
# decode_train's logits), a share of the largest |logit|, between the
# sound readings and the planted fault's (``foreign_cross_kv``), read by
# tools/decode_limits.py on the H100 over five seeds: sound 3.9e-3 to
# 4.6e-3, fault 5.5e-2 to 7.0e-2
WHISPER_DECODE_TOL = 1.5e-2
# PaliGemma's fused and unfused continuous-depth solves in bf16: the fused
# step rounds z + eps (b.r + eps g) once, the unfused leaf algebra after
# each product, so they differ by bf16 rounding through the stack; a share
# of the largest |logit|, 4x the readings on the H100 (2.1e-3 to 2.5e-3
# over K 3 to 18, both solvers). The float32 check holds them equal.
PALI_FUSED_TOL = 1e-2


def pali_batch(cfg, dev, seed):
    """One PaliGemma step's inputs: (B, PALI_TEXT) tokens and targets and
    (B, 256, d) patch embeddings from a numpy RandomState."""
    rs = np.random.RandomState(seed)
    toks = [torch.as_tensor(rs.randint(0, cfg.vocab, (B, PALI_TEXT)),
                            device=dev) for _ in range(2)]
    fe = rs.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model)
                            ).astype(np.float32)
    return {"tokens": toks[0], "targets": toks[1],
            "frontend": torch.as_tensor(fe, device=dev).to(
                lm.dtype_of(cfg.dtype))}


def logits_rel_diff(a, b):
    return float((a - b).abs().max() / b.abs().max())


def pali_cdepth(params, cfg, batch, ref_top, gp):
    """``lm_forward_cdepth(frontend=)`` at each of PALI_KS, euler and
    hyper_euler (the seeded g), unfused and fused: each solve's launches
    (flash once per step, one dense block a group; hyper_step once per
    fused step, none unfused) exact, NFE, argmax agreement with
    ``lm_forward(frontend=)`` (``ref_top``), and the fused solve against
    the unfused one within PALI_FUSED_TOL of the largest |logit|. Returns
    (rows, launches)."""
    rows, launches = [], collections.Counter()
    for solver in ("euler", "hyper_euler"):
        g = gp if solver == "hyper_euler" else None
        for K in PALI_KS:
            out = {}
            for fused in (False, True):
                LAUNCHES.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, stats = cdepth.lm_forward_cdepth(
                    params, cfg, batch["tokens"], K, solver, g,
                    frontend=batch["frontend"], with_stats=True, fused=fused)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                got = dict(LAUNCHES)
                launches.update(got)
                want = {"flash_attention": K, "hyper_step": K if fused else 0}
                if {k: got.get(k, 0) for k in want} != want:
                    raise AssertionError(f"paligemma cdepth {solver} K {K} "
                                         f"fused {fused}: launches {got}, "
                                         f"expected {want}")
                if not bool(torch.isfinite(logits).all()):
                    raise AssertionError(f"paligemma cdepth {solver} K {K}: "
                                         "non-finite logits")
                out[fused] = (logits, ms, int(stats.nfe[0]))
            diff = logits_rel_diff(out[True][0], out[False][0])
            if not diff <= PALI_FUSED_TOL:
                raise AssertionError(f"paligemma cdepth {solver} K {K}: fused "
                                     f"off the unfused solve by {diff}")
            top = out[True][0].argmax(-1)
            rows.append(dict(
                solver=solver, K=K, nfe=out[True][2],
                agreement=float((top == ref_top).float().mean()),
                text_agreement=float((top[:, -PALI_TEXT:]
                                      == ref_top[:, -PALI_TEXT:])
                                     .float().mean()),
                fused_rel_diff=diff, ms_unfused=out[False][1],
                ms_fused=out[True][1]))
            del out, top
    return rows, launches


def pali_fused_fp32(dev):
    """Float32 at PALI_FP32_LAYERS, full width, TF32 off, with the
    frontend: the fused and unfused solves (euler and hyper_euler with a
    seeded g, K 2 and 4) agree to rtol 1e-4, atol 1e-5 of the largest
    logit (``phase_fused_vs_unfused``'s bound)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get("paligemma_3b"), n_layers=PALI_FP32_LAYERS,
                              dtype="float32", param_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(31)
    params = init_lm(gen, cfg, device=dev)
    gp = lm_g_init(gen, cfg, rank=32, device=dev)
    gp["w_out"] = truncated_normal_init(gen, gp["w_out"].shape, 0.02,
                                        gp["w_out"].dtype, dev)
    batch = pali_batch(cfg, dev, 32)
    report = {}
    with torch.no_grad():
        for solver, g in (("euler", None), ("hyper_euler", gp)):
            for K in (2, 4):
                a, b = (cdepth.lm_forward_cdepth(
                    params, cfg, batch["tokens"], K, solver, g,
                    frontend=batch["frontend"], fused=fused)
                    for fused in (False, True))
                scale = float(a.abs().max())
                ok = bool(((b - a).abs() <= 1e-4 * a.abs() + 1e-5 * scale)
                          .all())
                report[f"{solver}-K{K}"] = dict(
                    max_abs_diff=float((b - a).abs().max()),
                    max_abs_logit=scale)
                if not ok:
                    raise AssertionError(f"paligemma fp32 {solver} K {K}: "
                                         f"fused off unfused {report}")
                del a, b
    del params
    torch.cuda.empty_cache()
    return report


def phase_paligemma(dev, bandwidth):
    """A main path: full-width paligemma_3b with its patch frontend, bf16,
    seeded weights, 8 requests of 256 patches and 128 text tokens.
    (1) ``make_prefill_step`` on a frontend batch: logits (B, 384, V),
    finite, flash once per dense block. (2) the continuous-depth scorer
    (``pali_cdepth``; its float32 check ``pali_fused_fp32``). (3)
    ``phase_decode_cli``: the serving CLI's cached decode, text-only as
    the reference's CLI serves it. (4) TRAIN_STEPS steps of
    ``make_train_step`` on frontend batches under a ``SyncedWatchdog``,
    with ``train_report``'s checks and numbers (384 positions a row).
    Returns the launches of the four paths."""
    cfg = get("paligemma_3b")
    settings = StepSettings(remat="none", zero_opt=False)
    launches = collections.Counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_lm(gen, cfg, device=dev)
    gp = lm_g_init(gen, cfg, rank=32, device=dev)
    gp["w_out"] = truncated_normal_init(gen, gp["w_out"].shape, 0.02,
                                        gp["w_out"].dtype, dev)
    batch = pali_batch(cfg, dev, 1)
    prefill = steps.make_prefill_step(cfg, settings)
    prefill_ms = []
    for _ in range(2):      # the first call also loads libraries
        LAUNCHES.clear()
        with count_blocks() as blocks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = prefill(params, batch)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
    counted, blocks = dict(LAUNCHES), dict(blocks)
    check_block_launches(counted, blocks, "paligemma prefill")
    launches.update({k: 2 * v for k, v in counted.items()})
    n_pos = cfg.n_frontend_tokens + PALI_TEXT
    if logits.shape != (B, n_pos, cfg.vocab) or blocks.get("dense") != \
            cfg.n_layers or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"paligemma prefill: logits {logits.shape}, "
                             f"blocks {blocks}")
    ref_top = logits.argmax(-1)
    del logits
    rows, cd_launches = pali_cdepth(params, cfg, batch, ref_top, gp)
    launches.update(cd_launches)
    fp32 = pali_fused_fp32(dev)
    emit(phase="paligemma", arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, batch=B,
         patches=cfg.n_frontend_tokens, text=PALI_TEXT,
         params=lm.count_params(params), prefill_ms=prefill_ms,
         prefill_launches=counted, cdepth=rows, fused_fp32=fp32,
         fused_tol=PALI_FUSED_TOL)
    del params, gp, ref_top, batch
    release_card()
    launches.update(phase_decode_cli(dev, bandwidth, "paligemma_3b"))
    release_card()
    step_fn, opt = make_train_step(cfg, settings)
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                     device=dev)
    opt_state = opt.init(params)
    dog = SyncedWatchdog()
    hist = []
    torch.cuda.reset_peak_memory_stats(dev)
    LAUNCHES.clear()
    with count_blocks() as blocks, timed_step_parts() as bwd:
        for step in range(TRAIN_STEPS):
            params, opt_state, met = dog.run(
                step_fn, params, opt_state, step, pali_batch(cfg, dev,
                                                             100 + step),
                loss_of=lambda out: out[2]["loss"])
            hist.append({"step": step, "loss": float(met["loss"]),
                         "grad_norm": float(met["grad_norm"])})
    del opt_state
    counted, blocks = dict(LAUNCHES), dict(blocks)
    launches.update(counted)
    report = train_report("paligemma train", cfg, params, hist, dog, bwd,
                          counted, blocks, dev, seq=n_pos)
    emit(phase="paligemma_train", **report)
    del params
    release_card()
    return launches


@contextlib.contextmanager
def foreign_cross_kv():
    """A planted fault for Whisper's teacher-forced decode check: each
    request's cross K/V is the next request's (``init_dec_cache``'s cross
    tensors rolled by one along the batch). The check must read it above
    its limit."""
    orig = encdec.init_dec_cache

    def faulty(*args, **kwargs):
        caches = orig(*args, **kwargs)
        caches["cross"] = {k: torch.roll(v, 1, dims=1)
                           for k, v in caches["cross"].items()}
        return caches

    encdec.init_dec_cache = faulty
    try:
        yield
    finally:
        encdec.init_dec_cache = orig


def whisper_inputs(cfg, dev, seed):
    """Frames (B, WHISPER_FRAMES, d) float32, tokens and targets (B,
    WHISPER_TOKENS), from a numpy RandomState."""
    rs = np.random.RandomState(seed)
    frames = rs.standard_normal((B, WHISPER_FRAMES, cfg.d_model)
                                ).astype(np.float32)
    return {"frames": torch.as_tensor(frames, device=dev),
            **{k: torch.as_tensor(rs.randint(0, cfg.vocab,
                                             (B, WHISPER_TOKENS)), device=dev)
               for k in ("tokens", "targets")}}


def whisper_decode_logits(params, cfg, enc, toks):
    """GEN teacher-forced decode steps through ``make_serve_step`` from
    ``init_dec_cache``: their logits (B, GEN, V) and ms per step (host
    clock around synchronised work)."""
    serve_step = steps.make_serve_step(cfg)
    caches = encdec.init_dec_cache(params, cfg, enc, toks.shape[0], GEN)
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(GEN):
        logits, caches = serve_step(params, toks[:, t], caches, t)
        out.append(logits)
    torch.cuda.synchronize()
    return torch.stack(out, 1), (time.perf_counter() - t0) * 1e3 / GEN


def whisper_decode_err(params, cfg, enc, toks, fault=False):
    """The teacher-forced decode error, a share of the largest |logit| of
    ``decode_train`` over the same tokens (under ``foreign_cross_kv`` with
    ``fault``), and the decode's ms per step."""
    with torch.no_grad():
        tf = encdec.decode_train(params, cfg, enc, toks[:, :GEN])
        with foreign_cross_kv() if fault else contextlib.nullcontext():
            dec, ms = whisper_decode_logits(params, cfg, enc, toks)
        return logits_rel_diff(dec, tf), ms


def phase_whisper(dev, bandwidth):
    """A main path: full-width whisper_base, bf16, seeded weights, frames
    (8, 1500, 512) and 128 decoder tokens. (1) ``make_prefill_step``
    (``encode`` + ``decode_train``): logits (B, 128, V) finite, flash once
    per encoder layer and twice per decoder layer (self and cross). (2)
    the cached decode: ``init_dec_cache`` and GEN teacher-forced
    ``encdec_decode_step``s (``make_serve_step``) within
    WHISPER_DECODE_TOL of ``decode_train``'s logits, the planted fault
    (``foreign_cross_kv``) above it; ms per token beside the bytes a step
    reads. (3) TRAIN_STEPS steps of ``train_loop`` on frames, tokens and
    targets. (4) ``train_fp32_step`` at WHISPER_FP32_LAYERS layers each.
    (5) The serving CLI on ``whisper_base``, which (as the reference's)
    builds the decoder-only LM with learned positions (``init_lm``):
    its continuous-depth drain (``serve_counted``: euler, multi-rate,
    fused, K mixed; the depth path without the learned positions, as
    the reference's) and its cached decode (``phase_decode_cli``).
    Returns the launches."""
    cfg = get("whisper_base")
    settings = StepSettings(remat="none", zero_opt=False)
    launches = collections.Counter()
    per_forward = cfg.enc_layers + 2 * cfg.dec_layers
    params = init_encdec(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    batch = whisper_inputs(cfg, dev, 11)
    prefill = steps.make_prefill_step(cfg, settings)
    prefill_ms = []
    for _ in range(2):      # the first call also warms up
        LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    counted = dict(LAUNCHES)
    launches.update(flash_attention=2 * counted.get("flash_attention", 0))
    if counted.get("flash_attention") != per_forward or logits.shape != (
            B, WHISPER_TOKENS, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"whisper prefill: launches {counted}, logits "
                             f"{logits.shape}")
    del logits
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = encdec.encode(params, cfg, batch["frames"])
        torch.cuda.synchronize()
        encode_ms = (time.perf_counter() - t0) * 1e3
    LAUNCHES.clear()
    err, step_ms = whisper_decode_err(params, cfg, enc, batch["tokens"])
    decode_launches = LAUNCHES["flash_attention"]
    fault, _ = whisper_decode_err(params, cfg, enc, batch["tokens"],
                                  fault=True)
    if decode_launches != 2 * cfg.dec_layers or not \
            err <= WHISPER_DECODE_TOL < fault:
        raise AssertionError(f"whisper decode: teacher-forced error {err}, "
                             f"planted fault {fault}, limit "
                             f"{WHISPER_DECODE_TOL}; {decode_launches} flash "
                             "launches (decode_train's self and cross "
                             "attention; the decode steps' are plain)")
    step_bytes = sum(l.numel() * l.element_size() for l in
                     pytree.tree_leaves([params["dec_blocks"],
                                         params["embed"]]))
    cross_bytes = 2 * cfg.dec_layers * enc.numel() * enc.element_size()
    MEASURED["decode_encdec"][cfg.name] = dict(
        ms=step_ms,
        weight_bytes_bound_ms=(step_bytes + cross_bytes) / bandwidth * 1e3)
    emit(phase="whisper", arch=cfg.name, layers=[cfg.enc_layers,
                                                 cfg.dec_layers],
         d_model=cfg.d_model, dtype=cfg.dtype, batch=B,
         frames=WHISPER_FRAMES, tokens=WHISPER_TOKENS, gen=GEN,
         params=lm.count_params(params), prefill_ms=prefill_ms,
         prefill_launches=counted, encode_ms=encode_ms,
         decode_ms_per_token=step_ms, teacher_forced_rel_err=err,
         planted_fault_rel_err=fault, limit=WHISPER_DECODE_TOL,
         step_bytes=step_bytes + cross_bytes,
         bytes_bound_ms_per_token=(step_bytes + cross_bytes) / bandwidth
         * 1e3)
    del params, enc
    release_card()
    host = [whisper_inputs(cfg, dev, 200 + i) for i in range(TRAIN_STEPS)]
    dog = SyncedWatchdog()
    torch.cuda.reset_peak_memory_stats(dev)
    LAUNCHES.clear()
    with timed_step_parts() as bwd:
        params, opt_state, hist = train.train_loop(
            cfg, settings, TRAIN_STEPS, host, watchdog=dog, device=dev)
    del opt_state
    counted = dict(LAUNCHES)
    launches.update(counted)
    vals = [h[k] for h in hist for k in ("loss", "grad_norm")]
    moved = moved_share(params, cfg, dev)
    if not np.isfinite(vals).all() or not moved > 0 or counted.get(
            "flash_attention") != per_forward * TRAIN_STEPS:
        raise AssertionError(f"whisper train: {hist}, moved {moved}, "
                             f"launches {counted}")
    n = lm.count_params(params)
    step_s = float(np.median(dog.synced[1:]))
    parts = {k: float(np.median(v[1:]))
             for k, v in step_part_ms(bwd, TRAIN_STEPS).items()}
    tokens = B * (WHISPER_FRAMES + WHISPER_TOKENS)
    MEASURED["train"][cfg.name] = step_s * 1e3
    emit(phase="whisper_train", arch=cfg.name, steps=TRAIN_STEPS,
         losses=[h["loss"] for h in hist],
         grad_norms=[h["grad_norm"] for h in hist], params=n,
         moved_share=moved, ms_per_step_synced=step_s * 1e3,
         synced_ms=[t * 1e3 for t in dog.synced],
         positions_per_s=tokens / step_s,
         peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         reckoning_at_rest_gb=n * TRAIN_BYTES_PER_PARAM / 1e9,
         forward_backward_ms_per_step=parts.pop("forward_backward"),
         backward_ms_per_step=parts, launches=counted)
    del params, host
    release_card()
    fp32 = train_fp32_step(dev, "whisper_base", WHISPER_FP32_LAYERS,
                           whisper_inputs(cfg, "cpu", 12))
    emit(phase="whisper_train_fp32", tol=TRAIN_FP32_TOL["whisper_base"],
         **fp32)
    check_train_fp32("whisper_base", fp32)
    report, served, blocks, params, _ = serve_counted(dev, "whisper_base")
    if set(blocks) != {"dense"} or not served.get("hyper_step"):
        raise AssertionError(f"whisper_base serve: blocks {blocks}, "
                             f"launches {served}")
    emit(**report)
    launches.update(served)
    del params
    release_card()
    launches.update(phase_decode_cli(dev, bandwidth, "whisper_base"))
    release_card()
    return launches


# The sharded train step on one card: full-width
# Qwen3-4B cut to 4 layers (width 2560, GQA 32/8), 2 steps of 8 x 128
# tokens through make_train_step(mesh=) over a (1, 1) mesh of a world-1
# nccl group, held to make_train_step() on the same weights and batches:
# the loss and grad norm to a relative TRAIN_MESH_RTOL (a bf16 ulp is
# 3.9e-3; the first runs' gaps were below one), each leaf's step-0
# gradient to a relative L2 error of TRAIN_MESH_GRAD_RTOL.
TRAIN_MESH_LAYERS, TRAIN_MESH_STEPS = 4, 2
TRAIN_MESH_RTOL, TRAIN_MESH_GRAD_RTOL = 1e-3, 1e-2


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, in float32."""
    b = b.float()
    return float(torch.linalg.vector_norm(a.float() - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


@contextlib.contextmanager
def one_card_mesh():
    """A (data 1, model 1) ``DeviceMesh`` over a world-1 nccl group
    (``tcp://127.0.0.1`` and a free port) on the current card; the group
    is destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1,
                            device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    try:
        yield init_device_mesh("cuda", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def phase_train_mesh(dev):
    """``make_train_step(mesh=)`` on the card, over a (data 1, model 1)
    ``DeviceMesh`` of a world-1 nccl group (``tcp://127.0.0.1`` and a free
    port): full-width Qwen3-4B cut to TRAIN_MESH_LAYERS layers, its params
    and moments DTensors (``shard_state``, ``zero_opt``), two steps on the
    same seeded weights and batches as ``make_train_step()`` without a
    mesh. The loss, grad norm and every param are expected
    ``torch.equal``: on one device every placement is the whole tensor
    and every collective an identity, so the sharded step runs the same
    ops on the same tensors (the kernels under ``local_map`` on their
    local blocks, here the whole). Where one is not equal it is held to
    the bounds above and the phase says so: the metrics to
    TRAIN_MESH_RTOL, and step 0's gradients (``make_value_and_grad``,
    the step's own gradient half, with and without the mesh) leaf by
    leaf to TRAIN_MESH_GRAD_RTOL. Each param is held within one bf16
    ulp plus 4x the summed learning rates; the first steps' rates
    (lr/200, lr/100) are below half a bf16 ulp of almost every weight,
    so that check sees little and the gradients' does the work. Flash
    launches inside the sharded
    step are counted (the kernel ran on its shards), and
    ``compressed_allreduce_mean`` over the one-rank 'data' group equals
    dequantize(quantize(x)). The group is destroyed at the end. Returns
    the sharded step's launches."""
    from repro_torch.launch.steps import make_value_and_grad
    from repro_torch.optim import linear_warmup_cosine
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get("qwen3_4b"), n_layers=TRAIN_MESH_LAYERS)
    settings = StepSettings(remat="none", zero_opt=True)
    batches = [{"tokens": t, "targets": y} for t, y in itertools.islice(
        token_batches(cfg.vocab, B, S, seed=0, device=dev),
        TRAIN_MESH_STEPS)]
    params0 = init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                      device=dev)
    _, _, g1 = make_value_and_grad(cfg, settings)(params0, batches[0])
    step1, opt = make_train_step(cfg, settings)
    p1 = pytree.tree_map(torch.clone, params0)
    s1 = opt.init(p1)
    want = []
    for i, b in enumerate(batches):
        p1, s1, m = step1(p1, s1, i, b)
        want.append({k: m[k].clone() for k in ("loss", "grad_norm")})
    del s1
    with one_card_mesh() as mesh:
        stepn, _ = make_train_step(cfg, settings, mesh=mesh)
        pn, sn = shard_state(mesh, settings, params0, opt)
        del params0
        _, _, gn = make_value_and_grad(cfg, settings, mesh=mesh)(
            pn, batches[0])
        grad_err = {name: rel_l2(b.full_tensor(), a) for name, a, b in
                    zip(leaf_names(p1), g1, gn)}
        del g1, gn
        LAUNCHES.clear()
        got = []
        for i, b in enumerate(batches):
            pn, sn, m = stepn(pn, sn, i, b)
            got.append({k: m[k].clone() for k in ("loss", "grad_norm")})
        torch.cuda.synchronize(dev)
        counted = dict(LAUNCHES)
        if counted.get("flash_attention", 0) != \
                TRAIN_MESH_STEPS * TRAIN_MESH_LAYERS:
            raise AssertionError(f"train_mesh: flash launches {counted} in "
                                 f"{TRAIN_MESH_STEPS} steps of "
                                 f"{TRAIN_MESH_LAYERS} layers")
        unequal, off = {}, {}
        for i, (w, g) in enumerate(zip(want, got)):
            for k in w:
                if not torch.equal(w[k], g[k]):
                    unequal[f"step{i}/{k}"] = r = float(
                        (g[k] - w[k]).abs() / w[k].abs())
                    if r > TRAIN_MESH_RTOL:
                        off[f"step{i}/{k}"] = r
        worst_grad = max(grad_err, key=grad_err.get)
        if grad_err[worst_grad] > TRAIN_MESH_GRAD_RTOL:
            off[f"grad/{worst_grad}"] = grad_err[worst_grad]
        # AdamW moves a weight by at most ~2 lr_t a step (the normalised
        # step of its first updates), in its gradient's direction; where
        # a reordered sum flips a near-zero gradient the two runs part by
        # at most twice that
        lr_sum = sum(float(linear_warmup_cosine(
            settings.lr, settings.lr * 0.1, 200, 10_000)(
                torch.tensor(i + 1.0))) for i in range(TRAIN_MESH_STEPS))
        equal = total = 0
        for name, a, b in zip(leaf_names(p1), pytree.tree_leaves(p1),
                              pytree.tree_leaves(pn)):
            b = b.full_tensor()
            same = a == b
            equal, total = equal + int(same.sum()), total + a.numel()
            if not bool(same.all()):
                d = (a.float() - b.float()).abs()
                ulp = torch.maximum(a.float().abs(), b.float().abs()) \
                    * 2.0 ** -7
                unequal[name] = float(d.max())
                if bool((d > 4 * lr_sum + ulp).any()):
                    off[name] = float(d.max())
        if off:
            raise AssertionError(f"train_mesh: sharded step off the "
                                 f"unsharded one: {off}")
        x = torch.randn(4096, 256, generator=torch.Generator(
            device=dev).manual_seed(3), device=dev)
        red = compressed_allreduce_mean(x, mesh, axis="data")
        if not torch.equal(red, dequantize_blockwise(quantize_blockwise(x),
                                                     x.shape)):
            raise AssertionError("train_mesh: compressed_allreduce_mean over "
                                 "one rank is not x's own int8 round trip")
    emit(phase="train_mesh", layers=TRAIN_MESH_LAYERS,
         steps=TRAIN_MESH_STEPS, batch=[B, S], mesh=[1, 1],
         loss=[float(g["loss"]) for g in got],
         grad_norm=[float(g["grad_norm"]) for g in got],
         bit_equal=not unequal, params_equal_share=equal / total,
         unequal=unequal or None,
         grad_max_rel_l2=grad_err[worst_grad], grad_worst_leaf=worst_grad,
         grads_bit_equal=not any(grad_err.values()),
         why_unequal=None if not unequal else (
             "the sharded path sums some gradients in another order (its "
             "kernels' blocks and their gradients are made contiguous, so "
             "a GEMM may take another layout); metrics (relative gap "
             "shown) held to TRAIN_MESH_RTOL, step 0's gradients leaf by "
             "leaf to TRAIN_MESH_GRAD_RTOL, params (max abs diff shown) "
             "to one bf16 ulp plus 4x the summed learning rates"),
         launches=counted, seconds=time.perf_counter() - t0)
    del p1, pn, sn
    release_card()
    return counted



# The tensor-parallel serve steps on one card: full-width Nemotron-4-340B
# cut to SERVE_TP_LAYERS layers (32.7 GB of bf16 weights), drawn by the
# sharded draw on a (1, 1) mesh of a world-1 nccl group, the sharded
# prefill step and SERVE_TP_STEPS sharded decode steps held to the
# unsharded steps on the same tensors. Where they are not bit for bit
# equal, the worst relative L2 error of their logits is held to
# SERVE_TP_TOL, tools/serve_tp_smoke.py's PARITY_TOL["nemotron_4_340b"]
# (four cards against one: sound 8.1e-3, planted fault 0.126; PERF.md
# section 6).
SERVE_TP_LAYERS, SERVE_TP_STEPS, SERVE_TP_TOL = 2, 8, 5e-2


def phase_serve_tp(dev):
    """A main path: ``make_prefill_step(mesh=)``, ``lm_prefill`` into
    DTensor caches (``place_caches``) under ``sharded_context``, and
    ``make_serve_step(mesh=)`` over ``one_card_mesh()``, on weights from
    ``init_params_sharded`` (seed 0), the serve phases' 8 x 128 prompt
    (``RandomState(1)``), the decode fed the unsharded run's greedy
    tokens. The unsharded steps (``make_prefill_step(cfg, settings)``,
    ``lm_prefill``, ``make_serve_step(cfg)``) run first on the same
    tensors (``to_local()``: on one device a block is the whole leaf).
    Raises unless the flash launches of the sharded run are one per
    layer in each of its two prefills, the logits are finite, and each
    logits pair is equal or within SERVE_TP_TOL by relative L2. Prints
    the draw's ms, both decode loops' ms a step and whether the two runs
    are equal bit for bit. Returns the sharded run's launches."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get("nemotron_4_340b"),
                              n_layers=SERVE_TP_LAYERS)
    settings = StepSettings()
    n = SERVE_TP_STEPS
    prompt = torch.as_tensor(np.random.RandomState(1).randint(
        0, cfg.vocab, size=(B, S)).astype(np.int32), device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with one_card_mesh() as mesh, torch.no_grad():
        params, draw_ms = synced_ms(lambda: steps.init_params_sharded(
            0, cfg, mesh, settings))
        plain = pytree.tree_map(lambda t: t.to_local(), params)
        want = [steps.make_prefill_step(cfg, settings)(
            plain, {"tokens": prompt})]
        caches = lm.init_lm_cache(cfg, B, S + n + 1, device=dev)
        last, caches = lm.lm_prefill(plain, cfg, prompt, caches)
        want.append(last)
        toks = [last.argmax(-1)]
        serve1 = steps.make_serve_step(cfg)

        def plain_decode():
            for i in range(n):
                logits, _ = serve1(plain, toks[i], caches, S + i)
                want.append(logits)
                toks.append(logits.argmax(-1))
        _, plain_ms = synced_ms(plain_decode)
        del caches, plain
        release_card()
        LAUNCHES.clear()
        got = [steps.make_prefill_step(cfg, settings, mesh=mesh)(
            params, {"tokens": prompt})]
        caches = steps.place_caches(mesh, cfg, lm.init_lm_cache(
            cfg, B, S + n + 1, device=dev))
        with steps.sharded_context(mesh, settings, "prefill"):
            last, caches = lm.lm_prefill(
                params, cfg, steps.place_batch(mesh, prompt), caches)
        got.append(last)
        serve = steps.make_serve_step(cfg, mesh=mesh)

        def sharded_decode():
            for i in range(n):
                logits, _ = serve(params, toks[i], caches, S + i)
                got.append(logits)
        _, sharded_ms = synced_ms(sharded_decode)
        counted = dict(LAUNCHES)
        got = [g.to_local() for g in got]
        del caches, params
    names = ["prefill_step", "prefill_last"] + [f"decode{i}"
                                                for i in range(n)]
    equal = {k: torch.equal(a, b) for k, a, b in zip(names, got, want)}
    errs = {k: rel_l2(a, b) for k, a, b in zip(names, got, want)
            if not equal[k]}
    agree = min(float((a.argmax(-1) == b.argmax(-1)).float().mean())
                for a, b in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    del got, want
    release_card()
    expected = 2 * lm.group_layout(cfg)[1]
    if counted.get("flash_attention", 0) != expected or not finite or \
            any(e > SERVE_TP_TOL for e in errs.values()):
        raise AssertionError(f"serve_tp: launches {counted} (flash "
                             f"{expected} expected), finite {finite}, "
                             f"gaps {errs} against {SERVE_TP_TOL}")
    emit(phase="serve_tp", arch=cfg.name, layers=cfg.n_layers, mesh=[1, 1],
         batch=[B, S], decode_steps=n, draw_ms=draw_ms,
         plain_decode_ms_per_step=plain_ms / n,
         sharded_decode_ms_per_step=sharded_ms / n,
         bit_equal=not errs, unequal_rel_l2=errs or None,
         limit=SERVE_TP_TOL, min_argmax_agree=agree, launches=counted,
         peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         seconds=time.perf_counter() - t0)
    return counted


def release_card():
    """Frees what the dropped models held: a collector pass, then the
    allocator's cache. Some serving objects form reference cycles, which
    ``del`` leaves to the collector: without the pass ~17 GB of the three
    dense models' weights stayed allocated into the OLMoE phases."""
    gc.collect()
    torch.cuda.empty_cache()


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
    rglru_bwd_rows = phase_rglru_backward(dev, bandwidth)
    rwkv6_bwd_rows = phase_rwkv6_backward(dev, bandwidth)
    launches = phase_image(dev)
    launches.update(phase_cnf(dev))
    launches.update(phase_tracking(dev))
    served, params, prompt, tol = phase_serve(dev)
    launches.update(served)
    launches.update(phase_inflight(dev, get("qwen3_4b"), params, prompt, tol,
                                   via_cli=True, keep_records=True))
    launches.update(phase_mesh(dev, get("qwen3_4b"), params, prompt, tol))
    t_roof = time.perf_counter()
    roof_launches, roof_segment = phase_roofline(dev, params, prompt, tol)
    launches.update(roof_launches)
    emit(phase="roofline_total", seconds=time.perf_counter() - t_roof)
    refined, ledger = phase_refinery(dev, get("qwen3_4b"), params, prompt,
                                     tol)
    launches.update(refined)
    launches.update(phase_flow(dev, get("qwen3_4b"), params, prompt, tol,
                               ledger, via_cli=True))
    del ledger
    release_card()
    launches.update(phase_kv_int8(dev, bandwidth, params))
    launches.update(phase_chunking(dev, params))
    del params
    release_card()
    launches.update(phase_refinery_cli(dev))
    release_card()
    launches.update(phase_decode_cli(dev, bandwidth, "qwen3_4b"))
    release_card()
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
        release_card()
    served, params, prompt, tol = phase_serve_olmoe(dev)
    launches.update(served)
    launches.update(phase_inflight(dev, get("olmoe_1b_7b"), params, prompt,
                                   tol))
    launches.update(phase_moe_int8(dev, params, prompt))
    release_card()
    launches.update(phase_train_8bit(dev, params))
    del params
    release_card()
    launches.update(phase_decode_cli(dev, bandwidth, "olmoe_1b_7b"))
    release_card()
    t_cut = time.perf_counter()
    launches.update(phase_nemotron(dev, bandwidth))
    launches.update(phase_llama4(dev, bandwidth))
    emit(phase="nemotron_llama4_total", seconds=time.perf_counter() - t_cut)
    t_dense = time.perf_counter()
    launches.update(phase_mistral_nemo(dev, bandwidth))
    launches.update(phase_qwen3_8b(dev, bandwidth))
    emit(phase="dense_whole_total", seconds=time.perf_counter() - t_dense)
    launches.update(phase_cdepth_lm(dev))
    phase_fused_vs_unfused(dev)
    phase_decode_fp32(dev)
    phase_refinery_fp32(dev)
    release_card()
    t_new = time.perf_counter()
    launches.update(phase_paligemma(dev, bandwidth))
    launches.update(phase_whisper(dev, bandwidth))
    emit(phase="paligemma_whisper_total", seconds=time.perf_counter() - t_new)
    t_train = time.perf_counter()
    phase_train_kernels(dev)
    launches.update(phase_train_cli(dev))
    launches.update(phase_train(dev))
    launches.update(phase_train_faults(dev))
    launches.update(phase_train_mesh(dev))
    emit(phase="train_total", seconds=time.perf_counter() - t_train)
    launches.update(phase_serve_tp(dev))
    report_roofline(roof_segment)

    head = next(r for r in rows if r["case"] == "euler+g"
                and r["dtype"] == "bfloat16")
    flash = next(r for r in flash_rows if r["case"] == "griffin")
    rglru = next(r for r in rglru_rows if r["case"] == "serve")
    rwkv6 = next(r for r in rwkv6_rows if r["case"] == "serve")
    rglru_bwd = next(r for r in rglru_bwd_rows if r["case"] == "train")
    rwkv6_bwd = next(r for r in rwkv6_bwd_rows if r["case"] == "train")
    src = "src/repro_torch/kernels/{0}/csrc/{0}.cu"
    bwd_src = "src/repro_torch/kernels/{0}/csrc/{0}_backward.cu"
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
             library_ms=None),
        # no TPU kernel: the reference's XLA differentiates a plain lax.scan
        dict(name="rglru_scan_backward", route="cuda",
             source=bwd_src.format("rglru_scan"),
             replaces="src/repro/nn/rglru.py:80",
             launches=launches["rglru_scan_backward"],
             max_abs_err=max(r["max_abs_err"] for r in rglru_bwd_rows),
             ms=rglru_bwd["ms"], plain_ms=rglru_bwd["plain_ms"],
             bound_ms=rglru_bwd["bound_ms"], bound_by=rglru_bwd["bound_by"],
             library_ms=None),
        dict(name="rwkv6_scan_backward", route="cuda",
             source=bwd_src.format("rwkv6_scan"),
             replaces="src/repro/nn/rwkv6.py:158",
             launches=launches["rwkv6_scan_backward"],
             max_abs_err=max(r["max_abs_err"] for r in rwkv6_bwd_rows),
             ms=rwkv6_bwd["ms"], plain_ms=rwkv6_bwd["plain_ms"],
             bound_ms=rwkv6_bwd["bound_ms"], bound_by=rwkv6_bwd["bound_by"],
             library_ms=None)])
    emit(ok=True, device=dict(platform="gpu", kind=name,
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
