"""The port's tensor-parallel serving over process groups: the sharded
weight draw (``launch/steps.py::init_params_sharded``), the sharded
prefill step and a greedy decode over a device mesh, held against the
JAX package's unsharded functions (the reference's own sharded tests do
not run in this container).

The test process computes the reference once: reduced
``nemotron_4_340b`` (dense blocks, 4 query heads over 2 KV heads, float32)
drawn by JAX (``PRNGKey(0)``), its ``lm_forward`` logits of an 8 x 16
prompt, and a greedy decode (``lm_prefill`` of the prompt, then
``lm_decode_step`` for GEN tokens) with every step's logits. One
subprocess then spawns 4 ``gloo`` ranks (``tcp://127.0.0.1``, a free
port); each prints a marker per check, and each test below reads its
own:
  * DRAW_EQUAL: the sharded draw's full tensors on a (1, 1), (1, 2),
    (2, 2) and (1, 4) mesh are equal bit for bit (the (1, 1) and (1, 2)
    meshes are sub-meshes of the four ranks);
  * DRAW_TILE_BOUND: a ``TorchDispatchMode`` over the (1, 4) draw sees no
    tensor larger than the largest tile (a group slice of a leaf over
    ``DRAW_TILES``) but the device blocks the draw returns, each a
    quarter of its leaf where the leaf is sharded (meta tensors, the
    tree's shapes, hold no data and are not counted);
  * DRAW_STATS: each leaf's mean and standard deviation within
    STATS_TOL (about four standard errors of a sample of the smallest
    leaf) of ``init_lm``'s at the same shape, in the scale of the leaf's
    truncated normal, every draw inside +-2 scale, and the norms' ones
    equal;
  * PREFILL_2X2: ``make_prefill_step(mesh=)`` on (2, 2) with the JAX
    weights (``params_from_jax``, scattered from rank 0) equals the
    reference's ``lm_forward`` to TOL;
  * GREEDY_2X2 and GREEDY_1X4: ``lm_prefill`` into DTensor caches
    (``place_caches``) under ``sharded_context``, then GEN - 1 sharded
    serve steps, each token the argmax of the gathered logits: the
    tokens equal the reference's greedy tokens and every step's logits
    its logits to TOL. On (1, 4) the 2 KV heads do not divide the model
    axis, so ``cache_pspec`` shards the cache by head width (asserted).
The spawn has its own timeout, so a hang fails these tests and nothing
else.
"""
import os
import socket
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
from repro_torch.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "nemotron_4_340b"
B, P, GEN = 8, 16, 8
# float32 through matmuls (XLA and PyTorch sum in different orders)
TOL = dict(rtol=1e-4, atol=1e-4)
# the draw against init_lm, in units of the leaf's scale: the smallest
# drawn leaf (a (2, 64, 32) key projection) has 4,096 samples, whose mean
# and standard deviation of a +-2 truncated normal (sd 0.88) have standard
# errors of ~0.014 and ~0.010 each, ~0.019 and ~0.014 for a difference
STATS_TOL = dict(mean=0.08, std=0.06)
MARKERS = ("DRAW_EQUAL", "DRAW_TILE_BOUND", "DRAW_STATS", "PREFILL_2X2",
           "GREEDY_2X2", "GREEDY_1X4")


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
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.utils import _pytree as pytree

    REF, PORT = sys.argv[1], int(sys.argv[2])
    TOL = dict(rtol=float(sys.argv[3]), atol=float(sys.argv[4]))
    MEAN_TOL, STD_TOL = float(sys.argv[5]), float(sys.argv[6])

    def close(a, b):
        a = a.full_tensor() if hasattr(a, "full_tensor") else a
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)

    def rank_main(rank):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{PORT}",
                                rank=rank, world_size=4)
        from torch.distributed.device_mesh import (DeviceMesh,
                                                   init_device_mesh)
        from torch.distributed.tensor import Shard, distribute_tensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from repro_torch.configs import get
        from repro_torch.distributed import sharding as shd
        from repro_torch.launch import steps
        from repro_torch.models import lm
        say = print if rank == 0 else (lambda *a: None)
        axes = ("data", "model")
        # every rank builds every sub-mesh (group creation is collective)
        m11 = [DeviceMesh("cpu", [[r]], mesh_dim_names=axes)
               for r in range(4)]
        m12 = [DeviceMesh("cpu", [[0, 1]], mesh_dim_names=axes),
               DeviceMesh("cpu", [[2, 3]], mesh_dim_names=axes)]
        meshes = {"1x1": m11[rank], "1x2": m12[rank // 2],
                  "2x2": init_device_mesh("cpu", (2, 2), mesh_dim_names=axes),
                  "1x4": init_device_mesh("cpu", (1, 4), mesh_dim_names=axes)}
        ref = torch.load(REF)
        cfg = get("nemotron_4_340b").reduced()
        abstract = steps.abstract_params(cfg)
        names = [shd.path_str(p) for p, _ in
                 pytree.tree_leaves_with_path(abstract)]

        # the draw: the same full tensors on every mesh
        full = {}
        for name, mesh in meshes.items():
            drawn = steps.init_params_sharded(0, cfg, mesh)
            full[name] = [t.full_tensor() for t in pytree.tree_leaves(drawn)]
        for name, leaves in full.items():
            for n, a, b in zip(names, leaves, full["1x1"]):
                assert torch.equal(a, b), (name, n)
        say("DRAW_EQUAL")

        # no tensor larger than a tile but the blocks themselves
        class Sizes(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.made = []

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in pytree.tree_leaves(out):
                    # meta tensors (the tree's shapes) hold no data
                    if isinstance(t, torch.Tensor) and not t.is_meta:
                        self.made.append((t.numel(), t.data_ptr(), func))
                return out

        with Sizes() as sizes:
            drawn = steps.init_params_sharded(0, cfg, meshes["1x4"])
        blocks = {t.to_local().data_ptr(): t for t in
                  pytree.tree_leaves(drawn)}
        tile = 0
        for n, leaf, t in zip(names, pytree.tree_leaves(abstract),
                              pytree.tree_leaves(drawn)):
            slices = leaf.shape[0] if n.startswith("groups/") else 1
            split = any(isinstance(p, Shard) for p in t.placements)
            per = leaf.numel() // slices // (steps.DRAW_TILES if split else 1)
            tile = max(tile, per)
            assert t.to_local().numel() * (4 if split else 1) == \\
                leaf.numel(), n
        for numel, ptr, func in sizes.made:
            is_block = ptr in blocks and numel == \\
                blocks[ptr].to_local().numel()
            assert numel <= tile or is_block, (numel, tile, func)
        say("DRAW_TILE_BOUND")

        # init_lm's distributions
        if rank == 0:
            want = lm.init_lm(torch.Generator().manual_seed(0), cfg)
            for n, a, b in zip(names, full["1x4"], pytree.tree_leaves(want)):
                if n.endswith("/scale"):
                    assert torch.equal(a, b), n
                    continue
                scale = (1.0 if n == "embed/table"
                         else float(a.shape[-2]) ** -0.5)
                assert float(a.abs().max()) <= 2 * scale, n
                dm = abs(float(a.mean()) - float(b.mean())) / scale
                ds = abs(float(a.std()) / float(b.std()) - 1)
                assert dm <= MEAN_TOL and ds <= STD_TOL, (n, dm, ds)
        say("DRAW_STATS")

        # the sharded prefill step on the reference's weights
        s = steps.StepSettings()
        mesh = meshes["2x2"]
        place = lambda mesh: pytree.tree_map(
            lambda t, pl: distribute_tensor(t, mesh, pl, src_data_rank=0),
            ref["params"], steps.param_placements(mesh, s, ref["params"]),
            is_leaf=lambda t: isinstance(t, torch.Tensor))
        prefill = steps.make_prefill_step(cfg, s, mesh=mesh)
        close(prefill(place(mesh), {"tokens": ref["prompt"]}), ref["forward"])
        say("PREFILL_2X2")

        # greedy over the mesh: the prefill into DTensor caches, then
        # sharded serve steps
        P, GEN = ref["prompt"].shape[1], ref["tokens"].shape[1]
        for name in ("2x2", "1x4"):
            mesh = meshes[name]
            params = place(mesh)
            caches = steps.place_caches(mesh, cfg, lm.init_lm_cache(
                cfg, ref["prompt"].shape[0], P + GEN))
            k = caches["groups"]["b0"]["k"]
            if name == "1x4":       # 2 KV heads over 4: the head width
                assert k.placements[1] == Shard(4), k.placements
            with steps.sharded_context(mesh, s, "prefill"):
                logits, caches = lm.lm_prefill(
                    params, cfg, steps.place_batch(mesh, ref["prompt"]),
                    caches)
            serve = steps.make_serve_step(cfg, mesh=mesh)
            out, toks = [logits.full_tensor()], []
            toks.append(out[-1].argmax(-1))
            for t in range(P, P + GEN - 1):
                logits, caches = serve(params, toks[-1], caches, t)
                out.append(logits.full_tensor())
                toks.append(out[-1].argmax(-1))
            assert torch.equal(torch.stack(toks, 1).int(), ref["tokens"]), \\
                name
            close(torch.stack(out, 1), ref["logits"])
            say(f"GREEDY_{name.upper()}")
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(rank_main, nprocs=4)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks_output(tmp_path_factory):
    """The four ranks' output (stdout, stdout + stderr) and exit code."""
    tmp = tmp_path_factory.mktemp("serve_tp")
    ref = str(tmp / "ref.pt")
    _reference(ref)
    script = tmp / "ranks.py"
    script.write_text(_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(script), ref, str(_free_port()),
         str(TOL["rtol"]), str(TOL["atol"]), str(STATS_TOL["mean"]),
         str(STATS_TOL["std"])],
        env=env, capture_output=True, text=True, timeout=240, cwd=REPO)
    return proc.stdout, proc.stdout + proc.stderr, proc.returncode


@pytest.mark.parametrize("marker", MARKERS)
def test_serve_tp_over_four_gloo_ranks(ranks_output, marker):
    stdout, out, rc = ranks_output
    assert marker in stdout.split(), (marker, rc, out[-6000:])


def test_serve_tp_ranks_exit_clean(ranks_output):
    stdout, out, rc = ranks_output
    assert rc == 0, out[-6000:]
