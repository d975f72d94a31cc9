"""The port imports neither JAX nor anything of the JAX package
(``repro.*``): every ``repro_torch`` module and ``chip_smoke.py`` import in
a subprocess where ``import jax`` fails, and a static scan finds no such
import in their sources or in the measurement scripts under ``tools/``.
A subprocess because tests/conftest.py has already imported jax into
this one."""
import os
import re
import subprocess
import sys

from port_isolation import port_module_isolation  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _tool_sources():
    """The port's measurement scripts under tools/ (run on the card)."""
    tools = os.path.join(REPO, "tools")
    return sorted(os.path.join(tools, f) for f in os.listdir(tools)
                  if f.endswith(".py"))


def _port_modules():
    mods = []
    for path in _port_sources()[1:]:
        rel = os.path.relpath(path, os.path.join(REPO, "src"))[:-3]
        mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


SCRIPT = """
import importlib, sys
sys.modules["jax"] = None          # any 'import jax' now raises
sys.path[:0] = [{src!r}, {repo!r}]
for m in {mods!r} + ["chip_smoke"]:
    importlib.import_module(m)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "repro" or m.startswith("repro.") or m.split(".")[0] == "jax"))
print("LOADED", len({mods!r}) + 1)
assert not bad, bad
"""


def test_port_imports_with_jax_blocked():
    mods = _port_modules()
    assert "repro_torch.launch.serve" in mods and \
        "repro_torch.kernels.hyper_step.ops" in mods
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(
            src=os.path.join(REPO, "src"), repo=REPO, mods=mods)],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert f"LOADED {len(mods) + 1}" in proc.stdout


def test_no_jax_or_reference_imports_in_sources():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\.|"
                     r"from\s+repro\.|from\s+repro\s+import|import\s+repro\s*$)",
                     re.MULTILINE)
    offenders = {}
    for path in _port_sources() + _tool_sources():
        with open(path) as fh:
            hits = pat.findall(fh.read())
        if hits:
            offenders[os.path.relpath(path, REPO)] = hits
    assert not offenders, offenders
