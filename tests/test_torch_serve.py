"""The port's serving CLI (repro_torch/launch/serve.py): it serves the
continuous-depth drain path and the in-flight scheduler (``--inflight``,
sync and ``--overlap``, on a Poisson trace) of ``qwen3_4b``,
``recurrentgemma_2b``, ``rwkv6_1p6b``, ``olmoe_1b_7b`` and
``llama4_maverick_400b_a17b`` on the CPU when asked (the
default discrete decode path is tested in tests/test_torch_decode.py),
its flag set is the reference parser's plus ``--device``, the in-flight
flags, the refinery's and the flow tier's are checked with the
reference's own messages, ``--inflight --refine`` fits, gates and
checkpoints a correction that ``--g-ckpt`` then serves, ``--flow-ckpt``
with ``--flow-threshold`` serves part of the traffic at K=0 from a head
the port fitted and saved itself, ``--profile-dir`` writes a trace in
every mode, it never falls back to the CPU silently (no CUDA and no
``--device cpu`` exits non-zero), ``--cost-oracle roofline`` serves
what the sequential clock serves with latencies in ``device_us``
(``--mesh`` is tested in tests/test_torch_mesh.py)."""
import ast
import json
import os
import re
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from port_isolation import port_module_isolation  # noqa: F401
from repro.launch import serve as jax_serve
from repro_torch.launch import serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_RUN = ["--device", "cpu", "--reduced", "--batch", "3", "--prompt-len",
           "8"]
# arch -> prompt length: Griffin's prompts outrun its reduced local window
# of 8, so the window binds; RWKV6's run its recurrence over 16 tokens
ARCHS = {"qwen3_4b": 8, "recurrentgemma_2b": 16, "rwkv6_1p6b": 16,
         "olmoe_1b_7b": 8, "llama4_maverick_400b_a17b": 8}


def _cpu_run(arch):
    return ["--arch", arch, "--device", "cpu", "--reduced", "--batch", "3",
            "--prompt-len", str(ARCHS[arch])]


def _flags(path):
    with open(path) as fh:
        return set(re.findall(r'add_argument\(\s*"(--[a-z][a-z0-9-]*)"',
                              fh.read()))


def test_flag_set_is_reference_plus_device():
    ref = _flags(os.path.join(REPO, "src", "repro", "launch", "serve.py"))
    port = {a for act in serve.build_parser()._actions
            for a in act.option_strings if a.startswith("--")}
    assert ref and port == ref | {"--device", "--help"}


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("solver", ["euler", "heun"])
def test_serves_multirate_fused_on_cpu(capsys, arch, solver):
    out = serve.main(_cpu_run(arch) + ["--solver", solver, "--multirate",
                                       "--fused", "--buckets", "2,4,8"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(
        f"[{solver} multirate cpu] scored 3x{ARCHS[arch]}")
    reqs = [l for l in lines if l.strip().startswith("req ")]
    assert len(reqs) == 3
    assert all("fused=True status=ok" in l for l in reqs)
    assert all(r.K in (2, 4, 8) and r.status == "ok" for r in out["results"])
    assert out["cfg"].name == arch


@pytest.mark.parametrize("arch", list(ARCHS))
def test_serves_fixed_k_on_cpu(capsys, arch):
    out = serve.main(_cpu_run(arch) + ["--solver", "euler", "--nfe", "2"])
    assert "[euler K=2 cpu]" in capsys.readouterr().out
    assert [r.K for r in out["results"]] == [2, 2, 2]


@pytest.mark.parametrize("mode", ["drain", "inflight"])
def test_cost_oracle_roofline_serves_as_the_sequential_clock(capsys, mode):
    """``--cost-oracle roofline`` serves what the sequential clock serves
    (per request K, nfe, status and logits, bit for bit) and stamps the
    in-flight latency line in ``device_us``, its Poisson rate per
    device-us (the reference's conversion: the sequential rate over one
    field evaluation of the pool)."""
    from repro_torch.launch.oracle import RooflineOracle
    argv = CPU_RUN + ["--solver", "euler", "--multirate", "--fused"]
    if mode == "inflight":
        argv += ["--inflight", "--arrival-trace", "poisson"]
    seq = serve.main(argv)
    step = RooflineOracle(seq["cfg"], ctx=8).step_time(4)
    roof = serve.main(argv + ["--cost-oracle", "roofline"]
                      + (["--arrival-rate", repr(0.25 / step)]
                         if mode == "inflight" else []))
    key = lambda r: (r.uid, r.K, r.nfe, r.status)
    assert [key(r) for r in roof["results"]] == \
        [key(r) for r in seq["results"]]
    for a, b in zip(roof["results"], seq["results"]):
        assert np.array_equal(a.outputs, b.outputs)
    out = capsys.readouterr().out
    if mode == "inflight":
        stats = [ast.literal_eval(l.split("] ", 1)[1])
                 for l in out.splitlines()
                 if l.startswith("[inflight poisson] ")]
        assert [s["cost_unit"] for s in stats] == ["sequential_evals",
                                                   "device_us"]
        assert roof["sched"].oracle.unit == "device_us"
    else:
        assert roof["engine"].oracle.unit == "device_us"
        assert seq["engine"].oracle.unit == "sequential_evals"


@pytest.mark.parametrize("extra", [
    ["--overlap"],
    ["--deadline", "5"],
    ["--inflight", "--overload-policy", "block"],
    ["--progress-every", "2"],
    ["--refine"],
    ["--flow-threshold", "0.2"],
    ["--inflight", "--ledger-cap", "16"],
    ["--flow-ckpt", "ckpt"],
])
def test_inflight_flag_checks_match_reference(monkeypatch, extra):
    """A knob of the in-flight scheduler, the refinery or the flow tier
    without what it needs exits non-zero before any weight is drawn,
    with the reference CLI's own message."""
    argv = ["--solver", "euler", "--multirate"] + extra
    with pytest.raises(SystemExit) as e:
        serve.main(CPU_RUN + argv)
    monkeypatch.setattr(sys, "argv", ["serve", "--reduced"] + argv)
    with pytest.raises(SystemExit) as ref:
        jax_serve.main()
    assert isinstance(e.value.code, str) and e.value.code == ref.value.code


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_serves_inflight_poisson_on_cpu(capsys, arch, overlap):
    """``--inflight --arrival-trace poisson`` serves every request ``ok``
    and prints the ``[inflight poisson]`` latency line (the reference's
    ``latency_stats`` keys) and a progress line per tick asked for."""
    extra = ["--solver", "euler", "--multirate", "--fused", "--inflight",
             "--arrival-trace", "poisson", "--progress-every", "1"]
    out = serve.main(_cpu_run(arch) + extra
                     + (["--overlap"] if overlap else []))
    lines = capsys.readouterr().out.splitlines()
    stats = [l for l in lines if l.startswith("[inflight poisson] ")]
    assert len(stats) == 1
    summary = ast.literal_eval(stats[0][len("[inflight poisson] "):])
    assert summary["requests"] == 3
    assert summary["cost_unit"] == "sequential_evals"
    assert any(l.startswith(f"[euler multirate inflight slots=4 seg=2 cpu]"
                            f" scored 3/3 of 3x{ARCHS[arch]}") for l in lines)
    reqs = [l for l in lines if l.strip().startswith("req ")]
    assert len(reqs) == 3 and all("status=ok" in l for l in reqs)
    assert sum(l.startswith("[progress] t=") for l in lines) \
        == out["sched"].ticks
    assert [r.uid for r in out["results"]] == [1, 2, 3]
    assert all(r.status == "ok" and r.K in (2, 4, 8) for r in out["results"])
    assert out["sched"].overlap is overlap


@pytest.mark.parametrize("mode", [
    [],
    ["--solver", "euler", "--multirate", "--fused"],
    ["--solver", "euler", "--multirate", "--fused", "--inflight"],
], ids=["discrete", "drain", "inflight"])
def test_profile_dir_writes_a_trace(tmp_path, mode):
    """``--profile-dir`` wraps the serving loop of every mode in
    ``torch.profiler`` and writes a Chrome trace into the directory."""
    serve.main(CPU_RUN + ["--gen", "2", "--profile-dir", str(tmp_path)]
               + mode)
    with open(tmp_path / "serve.pt.trace.json") as fh:
        trace = json.load(fh)
    assert trace["traceEvents"]


def test_first_signal_drains_second_interrupts():
    """The serving loop's drain latch: a first SIGTERM sets the flag, a
    second raises KeyboardInterrupt, and the previous handler comes back
    when the loop ends."""
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers install only on the main thread")
    before = signal.getsignal(signal.SIGTERM)
    with serve._graceful_drain() as draining:
        assert draining == [False]
        signal.raise_signal(signal.SIGTERM)
        assert draining == [True]
        with pytest.raises(KeyboardInterrupt):
            signal.raise_signal(signal.SIGTERM)
    assert signal.getsignal(signal.SIGTERM) is before


def test_hyper_solver_without_g_exits():
    with pytest.raises(SystemExit):
        serve.main(CPU_RUN + ["--solver", "hyper_euler"])


@pytest.mark.parametrize("arch", list(ARCHS))
def test_no_cpu_fallback(arch):
    """Without ``--device cpu`` the CLI asks for CUDA; with no card its
    default (discrete decode) and a solver both exit non-zero instead of
    serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    for extra in ([], ["--solver", "euler", "--multirate", "--fused"],
                  ["--solver", "euler", "--multirate", "--fused",
                   "--inflight", "--arrival-trace", "poisson"]):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             arch, "--reduced", *extra],
            capture_output=True, text=True, env=env, timeout=120)
        assert proc.returncode != 0
        assert "torch.cuda.is_available() is False" in proc.stderr
        assert "scored" not in proc.stdout
        assert "[discrete]" not in proc.stdout


def _progress(lines):
    return [dict(kv.split("=", 1) for kv in l.split()[1:])
            for l in lines if l.startswith("[progress] ")]


def test_inflight_refine_fits_gates_and_checkpoints(tmp_path, capsys):
    """``--inflight --refine`` on a reduced qwen3_4b: the ledger fills
    from live traffic, the candidate trains, the shadow gate runs, the
    progress lines carry the refinery's fields, the ledger flushes to an
    .npz, a candidate checkpoint lands under ``--refine-dir`` — and a
    second run serves it through ``--g-ckpt`` as hyper_euler."""
    ckpt, ledger = tmp_path / "refine", tmp_path / "ledger.npz"
    out = serve.main(
        ["--arch", "qwen3_4b", "--device", "cpu", "--reduced", "--batch",
         "16", "--prompt-len", "8", "--solver", "euler", "--multirate",
         "--fused", "--buckets", "4,8", "--seg", "1", "--inflight",
         "--arrival-trace", "poisson", "--refine", "--refine-dir",
         str(ckpt), "--refine-steps", "8", "--shadow-every", "32",
         "--max-batch", "2", "--ledger-cap", "64", "--ledger-out",
         str(ledger), "--progress-every", "4"])
    lines = capsys.readouterr().out.splitlines()
    prog = _progress(lines)
    assert prog and all({"ledger", "cand_step", "promotions",
                         "last_promotion"} <= set(p) for p in prog)
    assert prog[-1]["ledger"].endswith("/64")
    st = out["refinery"].status()
    assert st["candidate_step"] >= 50 and st["ledger_fill"] >= 32
    assert st["promotions"] + st["rejections"] >= 1
    assert any(l.startswith("[refinery] {") for l in lines)
    assert any(l.startswith("[ledger] flushed ") for l in lines)
    data = np.load(ledger)
    assert data["z_0"].shape[0] == st["ledger_fill"] \
        + out["ledger"].holdout_fill
    reqs = [l for l in lines if l.strip().startswith("req ")]
    assert len(reqs) == 16 and all("status=ok" in l for l in reqs)
    assert os.path.isdir(ckpt / "step_50")
    again = serve.main(CPU_RUN + ["--solver", "hyper_euler", "--g-ckpt",
                                  str(ckpt), "--multirate", "--fused"])
    assert all(r.status == "ok" for r in again["results"])
    assert "[hyper_euler multirate cpu] scored 3x8" in \
        capsys.readouterr().out


@pytest.mark.parametrize("inflight", [False, True], ids=["drain", "inflight"])
def test_flow_ckpt_serves_k0_tier(tmp_path, capsys, inflight):
    """A flow head fitted by the port (``train_flowhead`` on residual rows
    the port's ledger captured from the CLI's own model and prompts) and
    saved by the port's ``CheckpointManager`` serves through
    ``--flow-ckpt``/``--flow-threshold``: part of the traffic at K=0
    (nfe = probe + 1, ``status=ok``), the rest on the ladder; in flight
    the progress line counts the flow tier."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import FlowTrainConfig, train_flowhead
    from repro_torch.launch.engine import (EngineConfig, MultiRateEngine,
                                           lm_depth_model)
    from repro_torch.launch.refinery import ResidualLedger
    from repro_torch.models.cdepth import lm_flow_init

    base = serve.main(CPU_RUN + ["--batch", "8", "--solver", "euler",
                                 "--multirate", "--fused"])
    errs = np.sort([r.err_probe for r in base["results"]])
    tol = float(errs[-1]) * 1.25            # every request at K=1 -> 2
    thr = float(np.median(errs)) / tol      # half of them below thr*tol
    cfg, params = base["cfg"], base["params"]
    fp = lm_flow_init(torch.Generator().manual_seed(3), cfg, rank=8,
                      param_dtype=torch.float32)
    model = lm_depth_model(params, cfg, flow_params=fp, fused=True)
    led = ResidualLedger(model, capacity=32)
    MultiRateEngine(model, EngineConfig(buckets=(4,), controller="fixed",
                                        fixed_K=4, fused=True),
                    ledger=led).run(base["prompt"])
    fp, losses = train_flowhead(model.flow_apply, fp, led,
                                FlowTrainConfig(iters=10, batch_size=4))
    assert all(np.isfinite(losses))
    CheckpointManager(str(tmp_path)).save(10, fp, wait=True)
    capsys.readouterr()
    extra = ["--inflight", "--arrival-trace", "poisson",
             "--progress-every", "1"] if inflight else []
    out = serve.main(CPU_RUN + ["--batch", "8", "--solver", "euler",
                                "--multirate", "--fused", "--tol",
                                repr(tol), "--flow-ckpt", str(tmp_path),
                                "--flow-rank", "8", "--flow-threshold",
                                repr(thr)] + extra)
    lines = capsys.readouterr().out.splitlines()
    results = out["results"]
    flow = [r for r in results if r.K == 0]
    assert 0 < len(flow) < len(results)
    assert all(r.status == "ok" for r in results)
    probe = (out["sched"] if inflight else out["engine"]).probe_nfe
    assert all(r.nfe == probe + 1 for r in flow)
    reqs = [l for l in lines if l.strip().startswith("req ")]
    assert len(reqs) == 8 and all("status=ok" in l for l in reqs)
    assert sum(" K=0 " in l for l in reqs) == len(flow)
    if inflight:
        last = _progress(lines)[-1]
        assert int(last["flow"]) == len(flow) == \
            out["sched"].total_flow_served
        assert last["escalated"] == "0"
