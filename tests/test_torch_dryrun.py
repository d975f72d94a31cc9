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
    the model axis);
  * the collectives a train step needs are there: all-reduce or
    reduce-scatter for the tensor-parallel sums and the ZeRO gradients,
    all-gather under ``fsdp``;
  * a ``long_500k`` cell of a quadratic arch is ``SKIP`` with the
    reference's reason.
"""
import json
import os
import subprocess
import sys
import textwrap

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

    def cell(arch, shape, settings=None, mesh=None):
        cfg = get(arch).reduced()
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
        if not MP:
            dp = init_device_mesh("cpu", (256, 1),
                                  mesh_dim_names=("data", "model"))
            out["qwen3_4b/train_4k/dp"] = cell("qwen3_4b", "train_4k",
                                               mesh=dp)
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


def _run_both():
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


def test_dry_run_cells_on_the_production_meshes():
    res = _run_both()
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
