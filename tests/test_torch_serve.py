"""The port's serving CLI (repro_torch/launch/serve.py): it serves the
continuous-depth drain path of ``qwen3_4b``, ``recurrentgemma_2b`` and
``rwkv6_1p6b`` on the CPU when asked (the default discrete decode path
is tested in tests/test_torch_decode.py), its flag set is the reference
parser's plus ``--device``, it never falls back to the CPU silently (no
CUDA and no ``--device cpu`` exits non-zero), and flags of slices not
ported yet exit non-zero naming their ROADMAP.md item."""
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_RUN = ["--device", "cpu", "--reduced", "--batch", "3", "--prompt-len",
           "8"]
# arch -> prompt length: Griffin's prompts outrun its reduced local window
# of 8, so the window binds; RWKV6's run its recurrence over 16 tokens
ARCHS = {"qwen3_4b": 8, "recurrentgemma_2b": 16, "rwkv6_1p6b": 16}


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


@pytest.mark.parametrize("extra", [
    ["--solver", "euler", "--inflight"],
    ["--solver", "euler", "--slots", "8"],
    ["--solver", "euler", "--mesh", "2"],
    ["--solver", "euler", "--overlap"],
    ["--solver", "euler", "--refine"],
    ["--solver", "euler", "--flow-threshold", "0.2"],
    ["--solver", "euler", "--cost-oracle", "roofline"],
    ["--solver", "euler", "--profile-dir", "prof"],
])
def test_unported_flags_exit_naming_roadmap_item(extra):
    with pytest.raises(SystemExit) as e:
        serve.main(CPU_RUN + extra)
    assert "ROADMAP.md queue 1 item" in str(e.value.code)


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
    for extra in ([], ["--solver", "euler", "--multirate", "--fused"]):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             arch, "--reduced", *extra],
            capture_output=True, text=True, env=env, timeout=120)
        assert proc.returncode != 0
        assert "torch.cuda.is_available() is False" in proc.stderr
        assert "scored" not in proc.stdout
        assert "[discrete]" not in proc.stdout
