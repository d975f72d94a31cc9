"""Multi-pod dry run — the port of ``repro/launch/dryrun.py``: trace one
step of every (arch x shape) cell on the production meshes without a
device, and record its per-device memory, FLOPs and collectives for the
roofline (``roofline/report.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_8b \\
        --shape train_4k [--multi-pod] [--seq-shard] [--remat full] \\
        [--microbatches 4]

One cell runs in this process; more than one (``--all``, ``--both-meshes``,
an arch or a shape left open) run one process per cell, as many side by
side as the host has cores, so a cell's figures do not depend on what
ran before it.

The reference lowers and compiles each cell with XLA for 256 (or 512)
forced host devices and reads the compiled module's memory and cost
analyses and its HLO collectives. The port has no compiler to ask, so it
runs the step itself, in one process, on a *fake* process group of 256
or 512 ranks (``torch.distributed`` backend ``"fake"``, its store from
``torch.testing._internal.distributed.fake_pg``): the ``DeviceMesh`` is
the production mesh, the params, moments and inputs are DTensors placed
by ``distributed/sharding.py``'s rules whose local blocks are fake
tensors (``FakeTensorMode``: shapes and dtypes, no storage), and one
step runs under ``CommDebugMode``. Nothing is computed and no
accelerator is needed. On the (CPU) fake tensors flash attention takes
its plain, chunked version, so its FLOPs are the model's, not the
kernel's; each of the two scans is one operator (``torch.ops.repro_torch.
rglru_scan`` and ``.wkv6``, their backwards ``rglru_scan_backward`` and
``wkv6_backward``), whose fake implementation gives the output shapes
alone and whose FLOP formula is the plain loop's count. Rank 0's view
is measured, below DTensor's dispatch (a fake mode that sees every op
on a local block):
  * ``flops``: the matrix products' FLOPs (``torch.utils.flop_counter``'s
    formulas, the scan operators' included) on this device's blocks,
    backward and recomputation included;
  * ``bytes_accessed``: the bytes each op reads or writes as data
    (``_op_bytes``): its input and output bytes, collectives included,
    as XLA's cost analysis counts every instruction's operands and
    outputs; for a scan operator that is its inputs and outputs once,
    what the kernel moves. A view, a query that returns no tensor and
    mutates nothing (``prim.device``, sizes, strides), ``wait_tensor``
    (it returns its input) and an allocation (``empty`` and its kin)
    count 0; a factory that fills (``zeros``, ``full``, ``*_like``)
    counts its output;
  * ``memory``: ``argument_bytes`` (the local blocks of params, moments
    and inputs), ``output_bytes`` (what the step returns: for a train
    step the params and moments it updates in place, for prefill the
    logits, for decode the logits and the caches), ``temp_bytes`` (the
    peak of the bytes the step allocates and holds at once, beyond the
    arguments; at an operator with a workspace, ``kernels.WORKSPACE``,
    the live bytes after its outputs plus the workspace's: the
    checkpoints a scan's backward holds), ``generated_code_bytes`` (0: no
    code is generated) and
    ``alias_bytes`` (the arguments updated in place: params and moments,
    or the caches);
  * ``collective_bytes`` / ``collective_counts`` per kind: each
    collective's output bytes on this device, and the count
    ``CommDebugMode`` records.
The reference's ``compile_s`` becomes ``trace_s`` (the seconds the step
took to trace), and each artifact says so under ``"timing"``. Cells go
to ``artifacts/torch/dryrun/<arch>__<shape>__{sp,mp}.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import ARCH_IDS, SHAPES, cell_is_applicable, get
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (StepSettings, abstract_params,
                                      data_shardings, input_specs,
                                      make_prefill_step, make_serve_step,
                                      make_train_step, param_placements,
                                      place_batch)
from repro_torch.models.lm import set_perf_options
from repro_torch.nn.attention import set_attention_chunking

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "torch", "dryrun")
TIMING_NOTE = ("trace_s: seconds to trace the step on fake tensors over a "
               "fake process group (the reference's compile_s is XLA's "
               "lower + compile)")

# Per-arch training-step settings (microbatching + remat sized for HBM).
TRAIN_SETTINGS = {
    "nemotron_4_340b": StepSettings(microbatches=16, remat="full",
                                    seq_shard=True, fsdp=True,
                                    moment_dtype="bfloat16",
                                    acc_dtype="bfloat16"),
    "llama4_maverick_400b_a17b": StepSettings(microbatches=8, remat="full",
                                              seq_shard=True, fsdp=True,
                                              moment_dtype="bfloat16",
                                              acc_dtype="bfloat16"),
    "mistral_nemo_12b": StepSettings(microbatches=4, remat="full"),
    "qwen3_8b": StepSettings(microbatches=4, remat="full"),
    "whisper_base": StepSettings(microbatches=1, remat="dots"),
    "_default": StepSettings(microbatches=4, remat="full"),
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLL_OPS = {"all_gather_into_tensor": "all-gather",
             "all_reduce": "all-reduce",
             "reduce_scatter_tensor": "reduce-scatter",
             "all_to_all_single": "all-to-all"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


# ops whose tensor arguments give only a shape, dtype and device: an
# allocation writes nothing, a fill writes its output
_ALLOCATES = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided"}
_FILLS = {"zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
          "new_zeros", "new_ones", "new_full"}


def _op_bytes(func, args, kwargs, outs) -> int:
    """The bytes op ``func`` reads and writes as data on these arguments
    and tensor outputs (``bytes_accessed``'s rule, in the module's
    docstring)."""
    name = func.__name__.split(".")[0]
    if func.is_view or func is torch.ops._c10d_functional.wait_tensor.default:
        return 0
    if func.namespace == "aten" and name in _ALLOCATES:
        return 0
    if not outs and not func._schema.is_mutable:
        return 0
    written = sum(_nbytes(t) for t in outs)
    if func.namespace == "aten" and name in _FILLS:
        return written
    return written + sum(_nbytes(t) for t in pytree.tree_leaves(
        (args, kwargs)) if isinstance(t, torch.Tensor))


def local_bytes(tree) -> int:
    """Bytes of the local blocks of a tree's tensors (a DTensor's
    ``to_local()``)."""
    return sum(_nbytes(t.to_local() if shd.is_dtensor(t) else t)
               for t in pytree.tree_leaves(tree))


def _meter_mode():
    """A ``FakeTensorMode`` that meters every op it runs on local fake
    blocks (DTensor ops reach it unwrapped): FLOPs, bytes, collectives
    and the live bytes of what the ops allocate."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import flop_registry

    from repro_torch.kernels import WORKSPACE

    class Meter(FakeTensorMode):
        def __init__(self):
            super().__init__(allow_non_fake_inputs=True)
            self.flops = 0
            self.bytes = 0
            self.coll = dict.fromkeys(COLLECTIVES, 0)
            self.live = 0
            self.peak = 0
            self._refs: Dict[int, list] = {}
            self.metering = False

        def _hold(self, t):
            key = t.untyped_storage()._cdata
            ent = self._refs.get(key)
            if ent is None:
                n = t.untyped_storage().nbytes()
                ent = self._refs[key] = [n, 0]
                self.live += n
                self.peak = max(self.peak, self.live)
            ent[1] += 1
            weakref.finalize(t, self._drop, key)

        def _drop(self, key):
            ent = self._refs.get(key)
            if ent is None:
                return
            ent[1] -= 1
            if ent[1] == 0:
                self.live -= ent[0]
                del self._refs[key]

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented or not self.metering:
                return out
            kwargs = kwargs or {}
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            name = func.__name__.split(".")[0]
            if func.namespace == "_c10d_functional" and name in _COLL_OPS:
                self.coll[_COLL_OPS[name]] += sum(
                    _nbytes(t) for t in pytree.tree_leaves(out))
            outs = [t for t in pytree.tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            self.bytes += _op_bytes(func, args, kwargs, outs)
            args_keys = {a.untyped_storage()._cdata for a in
                         pytree.tree_leaves((args, kwargs))
                         if isinstance(a, torch.Tensor)}
            for t in outs:     # a new block, or another view of one
                key = t.untyped_storage()._cdata
                if key not in args_keys or key in self._refs:
                    self._hold(t)
            if packet in WORKSPACE:
                self.peak = max(self.peak, self.live
                                + WORKSPACE[packet](*args, **kwargs))
            return out

    return Meter()


@contextlib.contextmanager
def _metering(meter):
    """``meter`` on for the block, but off while DTensor's sharding
    propagation runs ops on fake tensors of its own (a global-shaped op
    to learn an output's shape, an op's decomposition to find its
    strategy; it finds the active fake mode, which is the meter): only
    the ops on local blocks are a device's work."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    names = ("_propagate_tensor_meta_non_cached",
             "propagate_op_sharding_non_cached")
    origs = {n: getattr(ShardingPropagator, n) for n in names}

    def unmetered(orig):
        def call(self, *args, **kwargs):
            was, meter.metering = meter.metering, False
            try:
                return orig(self, *args, **kwargs)
            finally:
                meter.metering = was
        return call

    for n in names:
        setattr(ShardingPropagator, n, unmetered(origs[n]))
    meter.metering = True
    try:
        with meter:
            yield
    finally:
        meter.metering = False
        for n in names:
            setattr(ShardingPropagator, n, origs[n])


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks (this process is rank 0) for
    the block; any live default group is replaced for its duration."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_dtensors(meter, tree, placements, mesh):
    """A DTensor of fake local blocks for every leaf of ``tree`` (meta or
    fake tensors), placed by ``placements``."""
    from torch.distributed.tensor import empty as dempty
    with meter:
        return pytree.tree_map(
            lambda t, p: dempty(tuple(t.shape), dtype=t.dtype,
                                device_mesh=mesh, placements=p),
            tree, placements, is_leaf=lambda x: isinstance(x, torch.Tensor))


def _fake_batch(meter, mesh, tree):
    """Fake global-batch tensors for ``tree``'s meta leaves, placed over
    the batch axes (``place_batch``)."""
    with meter:
        return place_batch(mesh, pytree.tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype), tree))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             settings: Optional[StepSettings] = None, verbose: bool = True,
             mesh=None, cfg=None, shape=None) -> Dict[str, Any]:
    """One cell on the production mesh (or ``mesh``) of the live fake
    process group (``fake_world``); ``cfg`` overrides ``get(arch)`` (the
    tests pass a reduced config) and ``shape`` (a ``ShapeSpec``)
    ``SHAPES[shape_name]`` (a cell of a run's own size). Returns the
    artifact's dict."""
    from torch.distributed.tensor.debug import CommDebugMode
    cfg = cfg or get(arch)
    shape = shape or SHAPES[shape_name]
    shape_name = shape.name
    ok, reason = cell_is_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "SKIP", "reason": reason}
    settings = settings or TRAIN_SETTINGS.get(arch, TRAIN_SETTINGS["_default"])
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod, device_type="cpu")
    t0 = time.time()
    # q-chunked exact attention for long sequences: bounds the plain
    # version's score buffer to (B, H, 512, S), as the reference does
    if shape.kind != "decode" and shape.seq_len >= 4096:
        set_attention_chunking(512)
    meter = _meter_mode()
    try:
        specs = input_specs(cfg, shape)
        a_params = abstract_params(cfg)
        params = _fake_dtensors(meter, a_params, param_placements(
            mesh, settings, a_params), mesh)
        alias = 0
        if shape.kind == "train":
            step, opt = make_train_step(cfg, settings, mesh=mesh)
            state = opt.init(a_params)
            opt_state = _fake_dtensors(meter, state, shd.opt_state_shardings(
                mesh, state, zero=settings.zero_opt), mesh)
            batch = _fake_batch(meter, mesh, specs)
            args = (params, opt_state, batch)
            alias = local_bytes((params, opt_state))
            run = lambda: step(params, opt_state, 0, batch)[:2]
        elif shape.kind == "prefill":
            step = make_prefill_step(cfg, settings, mesh=mesh)
            batch = _fake_batch(meter, mesh, specs)
            args = (params, batch)
            run = lambda: step(params, batch)
        else:
            step = make_serve_step(cfg, mesh=mesh, settings=settings)
            caches = _fake_dtensors(meter, specs["caches"], data_shardings(
                mesh, cfg, specs)["caches"], mesh)
            token = _fake_batch(meter, mesh, specs["token"])
            args = (params, token, caches)
            alias = local_bytes(caches)
            run = lambda: step(params, token, caches, 0)
        comm = CommDebugMode()
        with _metering(meter), comm:
            out = run()
        res = {
            "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "status": "OK",
            "trace_s": round(time.time() - t0, 1),
            "timing": TIMING_NOTE,
            "settings": dataclasses.asdict(settings),
            "n_devices": int(mesh.size()),
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "flops": float(meter.flops),
            "bytes_accessed": float(meter.bytes),
            "memory": {
                "argument_bytes": int(local_bytes(args)),
                "output_bytes": int(local_bytes(out)),
                "temp_bytes": int(meter.peak),
                "generated_code_bytes": 0,
                "alias_bytes": int(alias),
            },
            "collective_bytes": dict(meter.coll),
            "collective_counts": _comm_counts(comm),
        }
        if verbose:
            print(f"[OK] {arch} x {shape_name} "
                  f"({'2x16x16' if multi_pod else '16x16'}) "
                  f"trace={res['trace_s']}s flops={res['flops']:.3e} "
                  f"temp/dev={meter.peak / 2**30:.2f}GiB "
                  f"coll={sum(meter.coll.values()) / 2**30:.2f}GiB")
        return res
    except Exception as e:
        traceback.print_exc()
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "FAIL", "error": f"{type(e).__name__}: {e}"}
    finally:
        set_attention_chunking(None)


def _comm_counts(comm) -> Dict[str, int]:
    """``CommDebugMode``'s counts by the reference's collective kinds."""
    out = dict.fromkeys(COLLECTIVES, 0)
    for op, n in comm.get_comm_counts().items():
        name = getattr(op, "__name__", str(op)).split(".")[0]
        kind = _COLL_OPS.get(name)
        if kind is not None:
            out[kind] += int(n)
    return out


def _cell_path(arch: str, shape: str, multi_pod: bool, tag: str) -> str:
    name = f"{arch}__{shape}__{'mp' if multi_pod else 'sp'}" + \
        (f"__{tag}" if tag else "")
    return os.path.join(ARTIFACT_DIR, name + ".json")


def _run_apart(cells, passthrough, tag) -> list:
    """Each cell in a process of its own, ``os.cpu_count()`` side by side:
    torch keeps process-wide state across cells (the fake-tensor dispatch
    cache, DTensor's sharding caches) that moves a later cell's metered
    bytes, so one process per cell gives every cell the same count
    whatever ran before it. Returns the cells' records, from their
    files."""
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    def one(cell):
        mp, arch, shape = cell
        path = _cell_path(arch, shape, mp, tag)
        if os.path.exists(path):
            os.remove(path)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", os.devnull,
               *(["--multi-pod"] if mp else []), *passthrough]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        print("".join(l + "\n" for l in proc.stdout.splitlines()
                      if l.startswith("[OK]")), end="", flush=True)
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        print(proc.stderr[-4000:], file=sys.stderr, flush=True)
        return {"arch": arch, "shape": shape, "multi_pod": mp,
                "status": "FAIL", "error": f"exit {proc.returncode}: "
                f"{proc.stderr.strip().splitlines()[-1:]}"}

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        return list(pool.map(one, cells))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--seq-shard", action="store_true", default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--int8-dispatch", action="store_true")
    ap.add_argument("--ep-data", action="store_true")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.all or args.both_meshes) \
        else [args.multi_pod]
    cells = [(mp, arch, shape) for mp in meshes for arch in archs
             for shape in shapes]

    if len(cells) > 1:
        passthrough = [f for f, on in (
            ("--seq-shard", args.seq_shard), ("--int8-dispatch",
                                              args.int8_dispatch),
            ("--ep-data", args.ep_data), ("--kv-int8", args.kv_int8)) if on]
        for f, v in (("--remat", args.remat),
                     ("--microbatches", args.microbatches),
                     ("--tag", args.tag)):
            if v:
                passthrough += [f, str(v)]
        results = _run_apart(cells, passthrough, args.tag)
    else:
        if args.int8_dispatch:
            set_perf_options(int8_dispatch=True)
        if args.kv_int8:
            set_perf_options(kv_int8=True)
        if args.ep_data:
            shd.set_ep_axis("data")
        (mp, arch, shape), = cells
        settings = TRAIN_SETTINGS.get(arch, TRAIN_SETTINGS["_default"])
        overrides = {}
        if args.seq_shard is not None:
            overrides["seq_shard"] = args.seq_shard
        if args.remat:
            overrides["remat"] = args.remat
        if args.microbatches:
            overrides["microbatches"] = args.microbatches
        if overrides:
            settings = dataclasses.replace(settings, **overrides)
        with fake_world(512 if mp else 256):
            mesh = make_production_mesh(multi_pod=mp, device_type="cpu")
            res = run_cell(arch, shape, mp, settings, mesh=mesh)
        with open(_cell_path(arch, shape, mp, args.tag), "w") as f:
            json.dump(res, f, indent=1)
        results = [res]

    # only --all owns summary.json (single-cell reruns must not clobber)
    default_name = "summary.json" if args.all else "summary_partial.json"
    out = args.out or os.path.join(ARTIFACT_DIR, default_name)
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "OK" for r in results)
    n_skip = sum(r["status"] == "SKIP" for r in results)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\n== dry-run: {n_ok} OK, {n_skip} SKIP (documented), "
          f"{n_fail} FAIL ==")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
