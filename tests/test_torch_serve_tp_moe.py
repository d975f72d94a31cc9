"""The port's expert-parallel serving over process groups: the sharded
weight draw of a MoE LM (``launch/steps.py::init_params_sharded``, the
expert stacks drawn one expert a tile), the sharded prefill step and a
greedy decode over a device mesh with the experts over ``"model"``
(``nn/moe.py::_dispatch_sharded``), held against the JAX package's
unsharded functions.

The test process computes the reference once: reduced
``llama4_maverick_400b_a17b`` (4 layers in two (dense, moe) groups, 4
experts at top-1 with a shared expert, 4 query heads over 2 KV heads,
float32) drawn by JAX (``PRNGKey(0)``), its ``lm_forward`` logits of an
8 x 16 prompt, and a greedy decode (``lm_prefill`` of the prompt, then
``lm_decode_step`` for GEN tokens) with every step's logits. Two
subprocesses, one after the other, each spawn 4 ``gloo`` ranks
(rendezvous in a file of the test's temporary directory, so no port is
shared with another test): the draw's checks (i)-(iii), then the steps'
(iv)-(v). Rank 0 prints a marker per check, and each test below reads
its own:
  * MOE_DRAW_EQUAL (i): the sharded draw's full tensors on a (1, 1),
    (1, 2), (2, 2) and (1, 4) mesh are equal bit for bit, at 4 experts
    and at 8 (where one tile an expert and DRAW_TILES tiles a stack
    differ);
  * MOE_DRAW_STATS (ii): each expert stack's (and every other leaf's)
    mean and standard deviation within STATS_TOL of ``init_lm``'s at the
    same shape, in the scale of the leaf's truncated normal (widened by
    sqrt(4,096 / n) for a leaf of n < 4,096 samples: the same four
    standard errors), every draw inside +-2 scale;
  * MOE_DRAW_TILE_BOUND (iii): a ``TorchDispatchMode`` over the (1, 4)
    draw sees, while an expert stack is drawn, no tensor larger than one
    expert's matrix but the device block the draw returns (meta tensors
    hold no data and are not counted, nor are views of the block), at 4
    and at 8 experts;
  * MOE_PREFILL_1X4, MOE_PREFILL_2X2, MOE_GREEDY_1X4, MOE_GREEDY_2X2
    (iv): ``make_prefill_step(mesh=)`` with the JAX weights
    (``params_from_jax``, scattered from rank 0) equals the reference's
    ``lm_forward`` to TOL; ``lm_prefill`` into DTensor caches, then GEN - 1
    sharded serve steps, each token the argmax of the gathered logits,
    give the reference's greedy tokens and every step's logits to TOL;
    MOE_ROUTING_SAME: every rank routes every token of every dispatch to
    the same expert (or drops it), the top-1 indices gathered from the
    four ranks (``chip_smoke.routed_experts``), and each routed token's
    first router probability clears its second by more than MARGIN, so no
    rounding difference between the packages can flip it;
  * MOE_FAULT_SEEN (v): under ``chip_smoke.dropped_combine`` (the
    combine's all-reduce skipped: each device keeps its own experts'
    share) the (1, 4) prefill step and greedy logits both fail (iv)'s
    comparison, so the checks above can see an expert-parallel fault.
Each spawn has its own timeout, so a hang fails its own checks and
nothing else; a collective that waits GLOO_TIMEOUT_S raises, naming
itself, and a rank still running 45 s before the spawn's timeout prints
its Python stack.
``init_params_sharded``'s refusals (the families without draw rules,
fsdp, experts over ``"data"``) are checked in this process.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_isolation import port_module_isolation  # noqa: F401
from repro.configs import get as jget
from repro.models.lm import (init_lm as jax_init_lm,
                             init_lm_cache as jax_init_cache,
                             lm_decode_step as jax_decode,
                             lm_forward as jax_forward,
                             lm_prefill as jax_prefill)
from repro_torch.configs import get as tget
from repro_torch.convert import params_from_jax
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
from test_torch_moe import MARGIN
from test_torch_serve_tp import STATS_TOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "llama4_maverick_400b_a17b"
B, P, GEN = 8, 16, 8
# float32 through matmuls (XLA and PyTorch sum in different orders)
TOL = dict(rtol=1e-4, atol=1e-4)
SPAWN_TIMEOUT_S, GLOO_TIMEOUT_S = 240, 150
# each marker's spawn
MARKERS = {"MOE_DRAW_EQUAL": "draw", "MOE_DRAW_STATS": "draw",
           "MOE_DRAW_TILE_BOUND": "draw", "MOE_PREFILL_1X4": "serve",
           "MOE_PREFILL_2X2": "serve", "MOE_GREEDY_1X4": "serve",
           "MOE_GREEDY_2X2": "serve", "MOE_ROUTING_SAME": "serve",
           "MOE_FAULT_SEEN": "serve"}


def _reference(path: str) -> None:
    """The reference's forward and greedy decode, saved for the ranks."""
    cfg = jget(ARCH).reduced()
    params = jax_init_lm(jax.random.PRNGKey(0), cfg)
    prompt = np.random.RandomState(1).randint(
        0, cfg.vocab, (B, P)).astype(np.int32)
    fwd, _ = jax_forward(params, cfg, jnp.asarray(prompt))
    logits, caches = jax_prefill(params, cfg, jnp.asarray(prompt),
                                 jax_init_cache(cfg, B, P + GEN))
    out, toks = [logits], [jnp.argmax(logits, -1).astype(jnp.int32)]
    for t in range(P, P + GEN - 1):
        logits, caches = jax_decode(params, cfg, toks[-1], caches,
                                    jnp.asarray(t))
        out.append(logits)
        toks.append(jnp.argmax(logits, -1).astype(jnp.int32))
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    torch.save({"params": params_from_jax(host(params)),
                "prompt": torch.from_numpy(prompt),
                "forward": torch.from_numpy(np.array(fwd)),
                "logits": torch.from_numpy(np.stack(host(out), 1)),
                "tokens": torch.from_numpy(np.stack(host(toks), 1))}, path)


_SCRIPT = textwrap.dedent("""
    import dataclasses
    import datetime
    import faulthandler
    import sys
    import time
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.utils import _pytree as pytree

    PART, REF, STORE, REPO = sys.argv[1:5]
    TOL = dict(rtol=float(sys.argv[5]), atol=float(sys.argv[6]))
    MEAN_TOL, STD_TOL = float(sys.argv[7]), float(sys.argv[8])
    MARGIN = float(sys.argv[9])
    STACKS_AFTER_S, GLOO_TIMEOUT_S = float(sys.argv[10]), float(sys.argv[11])

    def close(a, b):
        a = a.full_tensor() if hasattr(a, "full_tensor") else a
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)

    def rank_main(rank):
        # a rank still running near the spawn's timeout prints its stack
        faulthandler.dump_traceback_later(STACKS_AFTER_S)
        torch.set_num_threads(1)
        sys.path.insert(0, REPO)
        dist.init_process_group(
            "gloo", init_method=f"file://{STORE}", rank=rank, world_size=4,
            timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
        from torch.distributed.device_mesh import (DeviceMesh,
                                                   init_device_mesh)
        from repro_torch.configs import get
        from repro_torch.distributed import sharding as shd
        from repro_torch.launch import steps
        say = print if rank == 0 else (lambda *a: None)
        t0 = time.perf_counter()

        def stage(what):
            # every rank's progress on stderr, shown when a check fails
            print(f"rank {rank} {time.perf_counter() - t0:.1f}s {what}",
                  file=sys.stderr, flush=True)
        stage("imported")
        axes = ("data", "model")
        meshes = {}
        if PART == "draw":
            # every rank builds every sub-mesh (group creation is collective)
            m11 = [DeviceMesh("cpu", [[r]], mesh_dim_names=axes)
                   for r in range(4)]
            m12 = [DeviceMesh("cpu", [[0, 1]], mesh_dim_names=axes),
                   DeviceMesh("cpu", [[2, 3]], mesh_dim_names=axes)]
            meshes.update({"1x1": m11[rank], "1x2": m12[rank // 2]})
        meshes["2x2"] = init_device_mesh("cpu", (2, 2), mesh_dim_names=axes)
        meshes["1x4"] = init_device_mesh("cpu", (1, 4), mesh_dim_names=axes)
        cfg = get("llama4_maverick_400b_a17b").reduced()
        abstract = steps.abstract_params(cfg)
        names = [shd.path_str(p) for p, _ in
                 pytree.tree_leaves_with_path(abstract)]
        stacks = [n for n in names if steps._EXPERT_STACK.search(n)]
        assert len(stacks) == 3, names
        if PART == "draw":
            draw_checks(rank, cfg, meshes, names, stacks, say, stage)
        else:
            serve_checks(rank, cfg, meshes, say, stage)
        dist.destroy_process_group()

    def draw_checks(rank, cfg, meshes, names, stacks, say, stage):
        from torch.utils._python_dispatch import TorchDispatchMode
        from repro_torch.launch import steps
        from repro_torch.models import lm
        from repro_torch.distributed import sharding as shd

        # the draw checks at 8 experts too: two a device on (1, 4), where
        # a tile an expert differs from DRAW_TILES tiles a stack
        wide = dataclasses.replace(cfg, n_experts=8)

        # (i) the draw: the same full tensors on every mesh
        for c in (wide, cfg):
            full = {name: [t.full_tensor() for t in pytree.tree_leaves(
                steps.init_params_sharded(0, c, mesh))]
                for name, mesh in meshes.items()}
            for name, leaves in full.items():
                for n, a, b in zip(names, leaves, full["1x1"]):
                    assert torch.equal(a, b), (c.n_experts, name, n)
            stage(f"drawn at {c.n_experts} experts on every mesh")
        say("MOE_DRAW_EQUAL")

        # (ii) init_lm's distributions
        if rank == 0:
            want = lm.init_lm(torch.Generator().manual_seed(0), cfg)
            for n, a, b in zip(names, full["1x4"], pytree.tree_leaves(want)):
                if n.endswith("/scale"):
                    assert torch.equal(a, b), n
                    continue
                scale = (1.0 if n == "embed/table"
                         else float(a.shape[-2]) ** -0.5)
                assert float(a.abs().max()) <= 2 * scale, n
                widen = max(1.0, (4096 / a.numel()) ** 0.5)
                dm = abs(float(a.mean()) - float(b.mean())) / scale
                ds = abs(float(a.std()) / float(b.std()) - 1)
                assert dm <= MEAN_TOL * widen and ds <= STD_TOL * widen, \\
                    (n, dm, ds)
        say("MOE_DRAW_STATS")
        stage("stats")

        # (iii) while an expert stack is drawn, no tensor larger than one
        # expert's matrix but the block itself
        current = [None]
        drawn_block = steps._drawn_block

        def tagged(seed, idx, path, *rest):
            current[0] = path
            try:
                return drawn_block(seed, idx, path, *rest)
            finally:
                current[0] = None

        class Sizes(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.made = []

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in pytree.tree_leaves(out):
                    # meta tensors (the tree's shapes) hold no data
                    if isinstance(t, torch.Tensor) and not t.is_meta:
                        self.made.append((current[0], t.numel(),
                                          t.untyped_storage().data_ptr(),
                                          func))
                return out

        expert = cfg.d_model * cfg.d_ff_expert
        for c in (cfg, wide):
            steps._drawn_block = tagged
            try:
                with Sizes() as sizes:
                    drawn = steps.init_params_sharded(0, c, meshes["1x4"])
            finally:
                steps._drawn_block = drawn_block
            blocks = {shd.path_str(p): t.to_local() for p, t in
                      pytree.tree_leaves_with_path(drawn)}
            seen = set()
            for path, numel, ptr, func in sizes.made:
                if path not in stacks:
                    continue
                seen.add(path)
                block = blocks[path]
                assert block.shape[1] * 4 == c.n_experts, block.shape
                # the block, or a view of it (a group slice): no new data
                in_block = ptr == block.untyped_storage().data_ptr()
                assert numel <= expert or in_block, (c.n_experts, path,
                                                     numel, expert, func)
            assert seen == set(stacks), seen
        say("MOE_DRAW_TILE_BOUND")
        stage("tile bound")

    def serve_checks(rank, cfg, meshes, say, stage):
        from torch.distributed.tensor import distribute_tensor
        import chip_smoke as cs
        from repro_torch.launch import steps
        from repro_torch.models import lm

        # (iv) the sharded prefill step and greedy decode on the
        # reference's weights, each dispatch's routing recorded
        ref = torch.load(REF)
        s = steps.StepSettings()
        P, GEN = ref["prompt"].shape[1], ref["tokens"].shape[1]

        def run(mesh):
            stage(f"placing the weights on {tuple(mesh.shape)}")
            params = pytree.tree_map(
                lambda t, pl: distribute_tensor(t, mesh, pl, src_data_rank=0),
                ref["params"], steps.param_placements(mesh, s, ref["params"]),
                is_leaf=lambda t: isinstance(t, torch.Tensor))
            stage("placed")
            wi = params["groups"]["b1"]["moe"]["wi"]
            assert wi.to_local().shape[1] * mesh.size(1) == cfg.n_experts
            with cs.routed_experts() as routes:
                fwd = steps.make_prefill_step(cfg, s, mesh=mesh)(
                    params, {"tokens": ref["prompt"]}).full_tensor()
                caches = steps.place_caches(mesh, cfg, lm.init_lm_cache(
                    cfg, ref["prompt"].shape[0], P + GEN))
                with steps.sharded_context(mesh, s, "prefill"):
                    logits, caches = lm.lm_prefill(
                        params, cfg, steps.place_batch(mesh, ref["prompt"]),
                        caches)
                serve = steps.make_serve_step(cfg, mesh=mesh)
                out = [logits.full_tensor()]
                toks = [out[-1].argmax(-1)]
                stage("prefilled")
                for t in range(P, P + GEN - 1):
                    logits, caches = serve(params, toks[-1], caches, t)
                    out.append(logits.full_tensor())
                    toks.append(out[-1].argmax(-1))
                stage("decoded")
            return fwd, torch.stack(toks, 1), torch.stack(out, 1), routes

        for name in ("1x4", "2x2"):
            fwd, toks, logits, routes = run(meshes[name])
            close(fwd, ref["forward"])
            say(f"MOE_PREFILL_{name.upper()}")
            assert torch.equal(toks.int(), ref["tokens"]), name
            close(logits, ref["logits"])
            say(f"MOE_GREEDY_{name.upper()}")
            # every rank's routing, gathered: the same on all four
            mine = torch.cat([r["routed"].flatten() for r in routes])
            assert len(routes) == 2 * (2 + GEN - 1), len(routes)
            every = [torch.empty_like(mine) for _ in range(4)]
            dist.all_gather(every, mine)
            assert all(torch.equal(e, every[0]) for e in every), name
            margin = min(float(r["margin"]) for r in routes)
            assert margin > MARGIN, (name, margin)
        say("MOE_ROUTING_SAME")

        # (v) the combine without its all-reduce fails (iv)
        with cs.dropped_combine():
            fwd, toks, logits, _ = run(meshes["1x4"])
        failed = []
        for got, want in ((fwd, ref["forward"]), (logits, ref["logits"])):
            try:
                close(got, want)
            except AssertionError:
                failed.append(True)
        if len(failed) == 2:
            say("MOE_FAULT_SEEN")

    if __name__ == "__main__":
        mp.spawn(rank_main, nprocs=4)
""")


def _spawn(part: str, tmp) -> tuple:
    """One spawn's four ranks: (stdout, stdout + stderr, exit code)."""
    ref = str(tmp / "ref.pt")
    if part == "serve":
        _reference(ref)
    script = tmp / "ranks.py"
    script.write_text(_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    try:
        proc = subprocess.run(
            [sys.executable, str(script), part, ref, str(tmp / "store"),
             REPO, str(TOL["rtol"]), str(TOL["atol"]),
             str(STATS_TOL["mean"]), str(STATS_TOL["std"]), str(MARGIN),
             str(SPAWN_TIMEOUT_S - 45), str(GLOO_TIMEOUT_S)],
            env=env, capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S,
            cwd=REPO)
    except subprocess.TimeoutExpired as e:
        # each check then fails showing how far every rank got, and where
        # each was stuck
        text = lambda b: b.decode() if isinstance(b, bytes) else (b or "")
        return (text(e.stdout), text(e.stdout) + text(e.stderr),
                f"timed out after {SPAWN_TIMEOUT_S} s")
    return proc.stdout, proc.stdout + proc.stderr, proc.returncode


@pytest.fixture(scope="module")
def ranks_output(tmp_path_factory):
    """Each spawn's output, run on first use: ``ranks_output(part)``."""
    runs = {}

    def get(part):
        if part not in runs:
            runs[part] = _spawn(part, tmp_path_factory.mktemp(
                f"serve_tp_moe_{part}"))
        return runs[part]
    return get


@pytest.mark.parametrize("marker", MARKERS)
def test_serve_tp_moe_over_four_gloo_ranks(ranks_output, marker):
    stdout, out, rc = ranks_output(MARKERS[marker])
    assert marker in stdout.split(), (marker, rc, out[-6000:])


@pytest.mark.parametrize("part", ("draw", "serve"))
def test_serve_tp_moe_ranks_exit_clean(ranks_output, part):
    stdout, out, rc = ranks_output(part)
    assert rc == 0, out[-6000:]


class _Mesh:
    """A stand-in mesh: ``axis_sizes`` reads its ``shape``; the draw's
    refusals come before any use of a real mesh."""
    shape = {"data": 1, "model": 4}


@pytest.mark.parametrize("arch, settings, match", [
    ("recurrentgemma_2b", {}, "item 32"),
    ("rwkv6_1p6b", {}, "item 32"),
    ("whisper_base", {}, "item 32"),
    (ARCH, {"fsdp": True}, "fsdp"),
])
def test_sharded_draw_refuses_what_it_has_no_rule_for(arch, settings,
                                                      match):
    cfg = tget(arch).reduced()
    with pytest.raises(ValueError, match=match):
        steps.init_params_sharded(0, cfg, _Mesh(),
                                  steps.StepSettings(**settings))


def test_sharded_draw_refuses_experts_over_data():
    shd.set_ep_axis("data")
    try:
        with pytest.raises(ValueError, match="experts over 'data'"):
            steps.init_params_sharded(0, tget(ARCH).reduced(), _Mesh())
    finally:
        shd.set_ep_axis("model")


def test_sharded_draw_refuses_a_model_axis_the_experts_do_not_divide():
    cfg = tget("olmoe_1b_7b").reduced()

    class Mesh:
        shape = {"data": 1, "model": 2}

    with pytest.raises(ValueError, match="expert count"):
        steps.init_params_sharded(0, dataclasses.replace(cfg, n_experts=3),
                                  Mesh())
