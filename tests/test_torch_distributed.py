"""The port's sharded train step over process groups — the mirror of
tests/test_distributed.py (which runs the reference on a forced 8-device
CPU mesh, and is marked slow there).

The test process computes the reference on one device and saves it: the
reduced ``qwen3_4b`` train step with 2 microbatches from the reference's
own pure parts (as tests/test_distributed.py's ``ref_step`` does),
weights drawn by JAX and carried by ``params_from_jax``, and one
``lm_decode_step``. One subprocess then spawns 4 ``gloo`` ranks on the
CPU as a (data 2, model 2) ``DeviceMesh`` (``tcp://127.0.0.1`` and a free
port), and each rank checks:
  1. the sharded train step equals the reference's single-device step,
     once under ``zero_opt`` and once under ``fsdp`` with ``seq_shard``:
     its gradients (``make_value_and_grad``, the step's own gradient
     half: the microbatch accumulator and the ZeRO placements, or FSDP's
     per-group reshard) leaf by leaf to rtol 1e-4 / atol 2e-5 (the worst
     seen on the CPU 3.6e-6), its grad norm before clipping to rtol
     1e-4, its loss to rtol 2e-4 and its params to rtol 3e-3 / atol 3e-4
     (the reference test's tolerances). The step runs at index STEP, past
     the warmup, where AdamW moves a weight by about the learning rate
     (1e-3): at step 0 (lr/200) every update would lie inside the params'
     tolerance;
  2. under ``fsdp`` the embedding table's local shard is a quarter of its
     bytes;
  3. ``compressed_allreduce_mean`` is within 0.03 of x;
  4. a sharded decode step equals the reference's ``lm_decode_step`` to
     3e-3;
  5. reduced ``olmoe_1b_7b`` (experts over ``"model"``),
     ``recurrentgemma_2b`` and ``rwkv6_1p6b`` (the scans on local
     shards): one sharded step each equals the port's unsharded step to
     1e-5 in float32;
  6. a checkpoint saved on (2, 2) restores on (4, 1) and on one device,
     equal: the counterpart of tests/test_fault_tolerance.py::
     test_elastic_restore_across_mesh_shapes.
The parent checks a marker per check, as the reference test does. The
spawn has its own timeout, so a hang fails this test and nothing else.
"""
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import torch

from port_isolation import port_module_isolation  # noqa: F401
from repro.configs import get as jget
from repro.data import token_batches as jax_token_batches
from repro.launch.steps import StepSettings as JaxSettings
from repro.launch.steps import make_optimizer as jax_make_optimizer
from repro.models.lm import (init_lm as jax_init_lm,
                             init_lm_cache as jax_init_cache,
                             lm_decode_step as jax_decode, lm_loss as jax_loss)
from repro.optim import apply_updates, clip_by_global_norm
from repro_torch.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARKERS = ("TRAIN_ZERO_OK", "TRAIN_FSDP_SP_OK", "EMBED_SHARD_OK",
           "COMPRESSED_ALLREDUCE_OK", "DECODE_PARITY_OK", "EP_MOE_OK",
           "RGLRU_SHARDS_OK", "WKV6_SHARDS_OK", "ELASTIC_RESTORE_OK")


# past the warmup (200 steps): the update's scale is the learning rate
STEP = 200


def _reference(path: str) -> None:
    """The reference's single-device step and decode, saved for the
    ranks (tests/test_distributed.py's ``ref_step``)."""
    cfg = jget("qwen3_4b").reduced()
    settings = JaxSettings(microbatches=2, remat="none", zero_opt=True,
                           lr=1e-3)
    params = jax_init_lm(jax.random.PRNGKey(0), cfg)
    toks, tgts = next(jax_token_batches(cfg.vocab, 8, 32, seed=3))
    batch = {"tokens": toks, "targets": tgts}
    opt = jax_make_optimizer(settings)
    mbs = jax.tree_util.tree_map(
        lambda x: x.reshape((2, x.shape[0] // 2) + x.shape[1:]), batch)
    g_acc = jax.tree_util.tree_map(
        lambda p: jnp.zeros(p.shape, jnp.float32), params)
    loss_acc = 0.0
    for i in range(2):
        mb = jax.tree_util.tree_map(lambda x: x[i], mbs)
        (l, _), g = jax.value_and_grad(
            lambda p: jax_loss(p, cfg, mb["tokens"], mb["targets"]),
            has_aux=True)(params)
        g_acc = jax.tree_util.tree_map(jnp.add, g_acc, g)
        loss_acc += l
    grads = jax.tree_util.tree_map(lambda g: g / 2, g_acc)
    clipped, gnorm = clip_by_global_norm(grads, settings.grad_clip)
    upd, _ = opt.update(clipped, opt.init(params), params, STEP)
    p_ref = apply_updates(params, upd)
    lg_ref, _ = jax_decode(params, cfg, toks[:, 0],
                           jax_init_cache(cfg, 8, 16), jnp.asarray(0))
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    torch.save({"params": params_from_jax(host(params)),
                "p_ref": params_from_jax(host(p_ref)),
                "grads": params_from_jax(host(grads)),
                "grad_norm": float(gnorm),
                "tokens": torch.from_numpy(np.array(toks)),
                "targets": torch.from_numpy(np.array(tgts)),
                "loss_ref": float(loss_acc / 2),
                "decode_ref": torch.from_numpy(np.asarray(lg_ref))}, path)


_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.utils import _pytree as pytree

    REF, PORT, CKPT = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    STEP = int(sys.argv[4])

    def close(a, b, **tol):
        a = a.full_tensor() if hasattr(a, "full_tensor") else a
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.detach().float().numpy(), **tol)

    def rank_main(rank):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{PORT}",
                                rank=rank, world_size=4)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.configs import get
        from repro_torch.data import token_batches
        from repro_torch.distributed import sharding as shd
        from repro_torch.launch import steps
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.models.lm import init_lm, init_lm_cache
        from repro_torch.optim.grad_compress import compressed_allreduce_mean
        say = print if rank == 0 else (lambda *a: None)
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        ref = torch.load(REF)
        cfg = get("qwen3_4b").reduced()
        batch = {"tokens": ref["tokens"], "targets": ref["targets"]}

        # 1-2. the sharded step against the reference's single-device step
        for name, extra in (("TRAIN_ZERO_OK", {}),
                            ("TRAIN_FSDP_SP_OK",
                             dict(fsdp=True, seq_shard=True))):
            s = steps.StepSettings(microbatches=2, remat="none",
                                   zero_opt=True, lr=1e-3, **extra)
            step, opt = steps.make_train_step(cfg, s, mesh=mesh)
            # a copy: the placed params may share the caller's storage,
            # and the step updates them in place
            p, o = steps.shard_state(
                mesh, s, pytree.tree_map(torch.clone, ref["params"]), opt)
            loss, _, grads = steps.make_value_and_grad(cfg, s, mesh=mesh)(
                p, batch)
            np.testing.assert_allclose(float(loss), ref["loss_ref"],
                                       rtol=2e-4)
            for a, b in zip(grads, pytree.tree_leaves(ref["grads"])):
                close(a, b, rtol=1e-4, atol=2e-5)
            del grads
            p, o, met = step(p, o, STEP, batch)
            np.testing.assert_allclose(float(met["loss"]), ref["loss_ref"],
                                       rtol=2e-4)
            np.testing.assert_allclose(float(met["grad_norm"]),
                                       ref["grad_norm"], rtol=1e-4)
            for a, b in zip(pytree.tree_leaves(p),
                            pytree.tree_leaves(ref["p_ref"])):
                close(a, b, rtol=3e-3, atol=3e-4)
            say(name)
        emb = p["embed"]["table"]
        assert emb.to_local().nbytes * 4 == emb.numel() * emb.element_size()
        say("EMBED_SHARD_OK")
        trained = p

        # 3. int8 all-reduce over 'data'
        x = torch.from_numpy(np.random.RandomState(5).randn(64, 32)
                             .astype(np.float32))
        got = compressed_allreduce_mean(x, mesh, axis="data")
        np.testing.assert_allclose(got.numpy(), x.numpy(), rtol=0.03,
                                   atol=0.03)
        say("COMPRESSED_ALLREDUCE_OK")

        # 4. a sharded decode step
        s = steps.StepSettings()
        specs = {"caches": init_lm_cache(cfg, 8, 16)}
        c_pl = steps.data_shardings(mesh, cfg, specs)
        caches = pytree.tree_map(
            lambda t, pl: distribute_tensor(t, mesh, pl, src_data_rank=0),
            specs, c_pl, is_leaf=lambda t: isinstance(t, torch.Tensor))
        params = pytree.tree_map(
            lambda t, pl: distribute_tensor(t, mesh, pl, src_data_rank=0),
            ref["params"], steps.param_placements(mesh, s, ref["params"]),
            is_leaf=lambda t: isinstance(t, torch.Tensor))
        serve = steps.make_serve_step(cfg, mesh=mesh)
        lg, _ = serve(params, ref["tokens"][:, 0], caches["caches"], 0)
        close(lg, ref["decode_ref"], rtol=3e-3, atol=3e-3)
        say("DECODE_PARITY_OK")

        # 5. experts over 'model' and the scans' local shards
        for arch, name in (("olmoe_1b_7b", "EP_MOE_OK"),
                           ("recurrentgemma_2b", "RGLRU_SHARDS_OK"),
                           ("rwkv6_1p6b", "WKV6_SHARDS_OK")):
            c = get(arch).reduced()
            s = steps.StepSettings(remat="none", zero_opt=True, lr=1e-3)
            p0 = init_lm(torch.Generator().manual_seed(0), c)
            t, y = next(token_batches(c.vocab, 8, 16, seed=3, device="cpu"))
            b = {"tokens": t, "targets": y}
            step1, opt = steps.make_train_step(c, s)
            want = pytree.tree_map(torch.clone, p0)
            want, _, m1 = step1(want, opt.init(want), 0, b)
            stepn, _ = steps.make_train_step(c, s, mesh=mesh)
            p, o = steps.shard_state(mesh, s, p0, opt)
            p, o, mn = stepn(p, o, 0, b)
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(float(mn[k]), float(m1[k]),
                                           rtol=1e-5, atol=1e-5)
            for a, w in zip(pytree.tree_leaves(p), pytree.tree_leaves(want)):
                close(a, w, rtol=1e-5, atol=1e-5)
            say(name)

        # 6. saved on (2, 2), restored on (4, 1) and on one device
        ck = CheckpointManager(CKPT, keep=2)
        ck.save(1, trained)
        mesh41 = init_device_mesh("cpu", (4, 1),
                                  mesh_dim_names=("data", "model"))
        like = pytree.tree_map(
            lambda t, pl: distribute_tensor(torch.zeros_like(t), mesh41, pl),
            ref["params"], shd.grad_shardings(mesh41, ref["params"]),
            is_leaf=lambda t: isinstance(t, torch.Tensor))
        back = ck.restore(1, like)
        whole = ck.restore(1, ref["params"])
        for a, b, c in zip(pytree.tree_leaves(back),
                           pytree.tree_leaves(trained),
                           pytree.tree_leaves(whole)):
            assert a.device_mesh is mesh41
            assert torch.equal(a.full_tensor(), b.full_tensor())
            assert torch.equal(c, b.full_tensor())
        say("ELASTIC_RESTORE_OK")
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(rank_main, nprocs=4)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sharded_train_step_over_four_gloo_ranks(tmp_path):
    ref = str(tmp_path / "ref.pt")
    _reference(ref)
    script = tmp_path / "ranks.py"
    script.write_text(_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(script), ref, str(_free_port()),
         str(tmp_path / "ckpt"), str(STEP)],
        env=env, capture_output=True, text=True, timeout=240, cwd=REPO)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-6000:]
    for marker in MARKERS:
        assert marker in proc.stdout, (marker, out[-6000:])
