"""The port's dry run (``repro_torch/launch/dryrun.py``) on the production
meshes, (16, 16) and (2, 16, 16), over a fake process group of 256 and
512 ranks with reduced configs: the counterpart of the reference's
compile-only dry run (``repro/launch/dryrun.py``).

The fake group is process-global, so each mesh runs in a subprocess of
its own (the two side by side). Checked:
  * each cell's record has the reference's keys (``compile_s`` becomes
    ``trace_s``, with a ``timing`` note and the ``mesh``);
  * ``argument_bytes`` equals the local blocks' bytes that the sharding
    rules give the params, moments and inputs (a cross-check of the
    placements the DTensors really have);
  * ``flops`` on a pure data-parallel (256, 1) mesh equals the unsharded
    step's FLOPs / 256 to 1 %; on (16, 16) it lies between the unsharded
    FLOPs / 256 and / 16 (tensor parallelism splits only what divides
    the model axis); with every width dividing the model axis, it is the
    formula's count of one sequence exactly (the unsharded FLOPs / 256);
  * Griffin's and RWKV6's train and prefill cells trace on both meshes
    (each scan one operator, ``torch.ops.repro_torch.*``, where its plain
    loop would take hours at 4,096 tokens);
  * the collectives a train step needs are there: all-reduce or
    reduce-scatter for the tensor-parallel sums and the ZeRO gradients,
    all-gather under ``fsdp``;
  * a ``long_500k`` cell of a quadratic arch is ``SKIP`` with the
    reference's reason;
  * ``bytes_accessed`` counts what ops move as data, by hand on a tiny
    step.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from port_isolation import port_module_isolation  # noqa: F401
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import cell_is_applicable as jax_applicable
from repro.configs import get as jget

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the keys of a reference cell (repro/launch/dryrun.py, run_cell's ``res``)
REF_KEYS = {"arch", "shape", "multi_pod", "status", "compile_s", "settings",
            "n_devices", "flops", "bytes_accessed", "memory",
            "collective_bytes", "collective_counts"}
REF_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes",
              "generated_code_bytes", "alias_bytes"}
REF_COLLECTIVES = {"all-gather", "all-reduce", "reduce-scatter",
                   "all-to-all", "collective-permute"}

_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    from torch.utils import _pytree as pytree
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import SHAPES, get
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun, steps

    MP = sys.argv[1] == "mp"
    FAST = dict(microbatches=1, remat="none")
    # reduced Qwen3-4B with 16 heads of 16 and 16 KV heads: every width
    # (d_model 64, heads, d_ff 128, vocab 256) divides the model axis
    WIDE = dataclasses.replace(get("qwen3_4b").reduced(), n_heads=16,
                               n_kv=16)

    def rule_bytes(mesh, cfg, shape, settings):
        # the local bytes the rules give params, moments and inputs
        sizes = shd.axis_sizes(mesh)
        def local(spec, t):
            n = 1
            for ax in spec:
                for a in ((ax,) if isinstance(ax, str) else (ax or ())):
                    n *= sizes[a]
            return t.numel() * t.element_size() // n
        a = steps.abstract_params(cfg)
        specs = steps.input_specs(cfg, shape)
        p_specs = (shd.grad_specs(mesh, a) if settings.fsdp
                   else shd.param_specs(mesh, a))
        trees = [(p_specs, a), (steps.data_specs(mesh, cfg, specs), specs)]
        if shape.kind == "train":
            st = steps.make_optimizer(settings).init(a)
            trees.append((shd.opt_state_specs(mesh, st,
                                              zero=settings.zero_opt), st))
        total = 0
        for sp, tree in trees:
            leaves = pytree.tree_leaves(tree)
            sps = pytree.tree_leaves(sp, is_leaf=shd.is_layout)
            if shape.kind == "decode" and tree is specs:
                leaves = [l for l in leaves if l.ndim]   # cur_index: not
                sps = [s for s in sps if len(s)]         # an argument
            total += sum(local(s, t) for s, t in zip(sps, leaves))
        return total

    def cell(arch, shape, settings=None, mesh=None, cfg=None):
        cfg = cfg or get(arch).reduced()
        s = settings or dataclasses.replace(dryrun.TRAIN_SETTINGS.get(
            arch, dryrun.TRAIN_SETTINGS["_default"]), **FAST)
        res = dryrun.run_cell(arch, shape, MP, s, verbose=False, cfg=cfg,
                              mesh=mesh)
        if res["status"] == "OK":
            m = mesh or dryrun.make_production_mesh(multi_pod=MP,
                                                    device_type="cpu")
            res["rule_bytes"] = rule_bytes(m, cfg, SHAPES[shape], s)
        return res

    out = {}
    with dryrun.fake_world(512 if MP else 256):
        if MP:   # (a 3-D mesh's first cell pays most of its tracing)
            fsdp = dataclasses.replace(dryrun.TRAIN_SETTINGS["_default"],
                                       fsdp=True, **FAST)
            out["qwen3_4b/train_4k/fsdp"] = cell("qwen3_4b", "train_4k",
                                                 fsdp)
            shapes = ("decode_32k", "long_500k")
        else:
            shapes = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
            out["olmoe_1b_7b/train_4k"] = cell("olmoe_1b_7b", "train_4k")
        for shape in shapes:
            out["qwen3_4b/" + shape] = cell("qwen3_4b", shape)
        # the scans' train and prefill cells: one operator a scan
        for arch in ("recurrentgemma_2b", "rwkv6_1p6b"):
            for shape in ("train_4k", "prefill_32k"):
                out[arch + "/" + shape] = cell(arch, shape)
        if not MP:
            dp = init_device_mesh("cpu", (256, 1),
                                  mesh_dim_names=("data", "model"))
            out["qwen3_4b/train_4k/dp"] = cell("qwen3_4b", "train_4k",
                                               mesh=dp)
            out["qwen3_4b/train_4k/tp"] = cell("qwen3_4b", "train_4k",
                                               cfg=WIDE)
    if not MP:   # the unsharded step's FLOPs, on fake tensors
        cfg = get("qwen3_4b").reduced()
        s = dataclasses.replace(dryrun.TRAIN_SETTINGS["_default"], **FAST)
        meter = dryrun._meter_mode()
        dryrun.set_attention_chunking(512)
        with meter:
            fake = lambda tree: pytree.tree_map(
                lambda t: torch.empty(t.shape, dtype=t.dtype), tree)
            params = fake(steps.abstract_params(cfg))
            step, opt = steps.make_train_step(cfg, s)
            state = opt.init(params)
            batch = fake(steps.input_specs(cfg, SHAPES["train_4k"]))
            meter.metering = True
            step(params, state, 0, batch)
        out["unsharded_flops"] = meter.flops
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def both():
    """The two meshes' subprocesses, run once for the module's tests."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = {m: subprocess.Popen(
        [sys.executable, "-c", _SCRIPT, m], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for m in ("sp", "mp")}
    out = {}
    for m, p in procs.items():
        so, se = p.communicate(timeout=240)
        assert p.returncode == 0, se[-6000:]
        line = [l for l in so.splitlines() if l.startswith("RESULT ")][-1]
        out[m] = json.loads(line[len("RESULT "):])
    return out


def test_dry_run_cells_on_the_production_meshes(both):
    res = both
    for m, n_dev in (("sp", 256), ("mp", 512)):
        for key, r in res[m].items():
            if key == "unsharded_flops" or r["status"] == "SKIP":
                continue
            assert r["status"] == "OK", (m, key, r.get("error"))
            assert set(r) - {"rule_bytes"} == \
                REF_KEYS - {"compile_s"} | {"trace_s", "timing", "mesh"}, r
            assert set(r["memory"]) == REF_MEMORY
            assert set(r["collective_bytes"]) == REF_COLLECTIVES
            assert set(r["collective_counts"]) == REF_COLLECTIVES
            assert r["n_devices"] == n_dev and r["flops"] > 0
            assert r["memory"]["argument_bytes"] == r["rule_bytes"], key
            if "train" in key:
                # the in-place params and moments: output = alias
                assert r["memory"]["alias_bytes"] == \
                    r["memory"]["output_bytes"] > 0
                c = r["collective_counts"]
                assert c["all-reduce"] + c["reduce-scatter"] > 0, c
        # a quadratic arch's 500k-token decode is the reference's SKIP
        skip = res[m]["qwen3_4b/long_500k"]
        ok, reason = jax_applicable(jget("qwen3_4b").reduced(),
                                    JAX_SHAPES["long_500k"])
        assert not ok and skip["status"] == "SKIP" \
            and skip["reason"] == reason
    assert res["mp"]["qwen3_4b/train_4k/fsdp"]["collective_counts"][
        "all-gather"] > 0
    total = res["sp"]["unsharded_flops"]
    dp = res["sp"]["qwen3_4b/train_4k/dp"]["flops"]
    assert abs(dp - total / 256) <= 0.01 * total / 256, (dp, total)
    tp = res["sp"]["qwen3_4b/train_4k"]["flops"]
    assert total / 256 <= tp <= total / 16, (tp, total)


def _train_flops(L, T, d, H, dh, ff, V):
    """A dense train step's matrix-product FLOPs for one sequence of T
    tokens: three times the forward's (the backward's two products for
    each of its one), the forward per layer the q, k, v and o projections,
    the scores and their product with v over all T keys (the plain,
    chunked attention computes every score), and the gated MLP's three
    products; then the logits."""
    layer = 2 * T * d * 3 * H * dh + 2 * T * H * dh * d \
        + 2 * 2 * T * T * H * dh + 3 * 2 * T * d * ff
    return 3 * (L * layer + 2 * T * d * V)


def test_tensor_parallel_cell_flops_are_pinned(both):
    """On (16, 16), with every width dividing the model axis (16 heads of
    16 and 16 KV heads on reduced Qwen3-4B), no matrix product stays
    replicated: the cell's FLOPs are the unsharded step's / 256 exactly,
    which is one sequence's by the formula (256 sequences over 16 data
    shards, each product's width over 16 model shards)."""
    tp = both["sp"]["qwen3_4b/train_4k/tp"]
    assert tp["status"] == "OK" and tp["mesh"] == {"data": 16, "model": 16}
    assert tp["flops"] == _train_flops(L=2, T=4096, d=64, H=16, dh=16,
                                       ff=128, V=256) == 107_911_053_312


def test_meter_counts_only_the_bytes_ops_move():
    """``bytes_accessed`` by hand: under the dry run's meter on a fake
    4-rank group, a step that queries a tensor's device, allocates with
    ``empty_like``, waits on a tensor (``wait_tensor`` returns its input),
    multiplies and adds meters exactly the product's bytes (its two
    operands read, its output written) and the sum's (two reads, one
    write), in fp32: (8 x 16 + 16 x 4 + 8 x 4) + 3 (8 x 4) elements."""
    import torch
    from repro_torch.launch import dryrun
    with dryrun.fake_world(4):
        meter = dryrun._meter_mode()
        with meter:
            x, w = torch.empty(8, 16), torch.empty(16, 4)
            meter.metering = True
            torch.ops.prim.device.default(x)
            torch.empty_like(x)
            y = torch.ops._c10d_functional.wait_tensor.default(x) @ w
            y + y
            meter.metering = False
    assert meter.bytes == 4 * ((8 * 16 + 16 * 4 + 8 * 4) + 3 * 8 * 4)


def test_cli_runs_each_cell_in_a_process_of_its_own(monkeypatch, tmp_path):
    """torch keeps process-wide state across cells (the fake-tensor
    dispatch cache, DTensor's sharding caches), and a cell traced after
    another meters other bytes (Mistral-NeMo's decode cell 0.035 % fewer
    after its prefill cell). So more than one cell runs one
    ``python -m repro_torch.launch.dryrun --arch A --shape S`` process per
    cell, the options passed on, and the records come from the cells'
    files; a process that writes none is a FAIL."""
    from repro_torch.launch import dryrun
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    calls = []

    class Done:
        returncode, stdout, stderr = 1, "[OK] a cell\n", "boom\nlast line"

    def fake_run(cmd, **kwargs):
        calls.append(cmd)
        arch, shape = cmd[cmd.index("--arch") + 1], cmd[cmd.index("--shape")
                                                      + 1]
        mp = "--multi-pod" in cmd
        if arch != "whisper_base" or shape != "decode_32k" or not mp:
            with open(dryrun._cell_path(arch, shape, mp, "t"), "w") as f:
                json.dump({"arch": arch, "shape": shape, "multi_pod": mp,
                           "status": "OK"}, f)
        return Done()

    monkeypatch.setattr(subprocess, "run", fake_run)
    out = tmp_path / "summary.json"
    rc = dryrun.main(["--arch", "whisper_base", "--both-meshes", "--remat",
                      "full", "--kv-int8", "--tag", "t", "--out", str(out)])
    assert rc == 1 and len(calls) == 8   # 4 shapes x 2 meshes
    for cmd in calls:
        assert cmd[1:3] == ["-m", "repro_torch.launch.dryrun"]
        assert cmd[cmd.index("--remat") + 1] == "full" and "--kv-int8" in cmd
        assert cmd[cmd.index("--tag") + 1] == "t"
    recs = json.loads(out.read_text())
    assert [r["status"] for r in recs].count("FAIL") == 1
    fail = next(r for r in recs if r["status"] == "FAIL")
    assert (fail["shape"], fail["multi_pod"]) == ("decode_32k", True)
    assert "last line" in fail["error"]
