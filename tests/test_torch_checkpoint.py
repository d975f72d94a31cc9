"""The port's checkpoint manager (repro_torch/checkpoint/manager.py):
roundtrip, atomicity (partial writes invisible), keep-N GC, async save,
the save-while-restore race, shape checks — the counterparts of
tests/test_checkpoint.py — and the wire format held against the JAX
package's both ways: a port-written checkpoint restores in the reference
bit for bit under both codecs, a reference-written one through the
port's ``restore_latest``; and the async save's host snapshot (the
caller may change its tensors the moment ``save`` returns)."""
import os
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from port_isolation import port_module_isolation  # noqa: F401
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as tman
from repro_torch.checkpoint.manager import flatten_sorted
from repro_torch.optim import AdamState


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((16, 8), generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": torch.randn((3,), generator=g).to(
                           torch.bfloat16)}}


def _bits(t):
    t = torch.as_tensor(t)
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _equal(a, b):
    la, lb = flatten_sorted(a)[0], flatten_sorted(b)[0]
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


def test_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    cm.save(3, t)
    assert cm.latest_step() == 3
    assert _equal(cm.restore(3, t), t)


def test_keep_n_gc(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, _tree(s))
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps == [3, 4]


def test_partial_write_is_invisible(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=3)
    cm.save(1, _tree())
    staging = tmp_path / ".tmp_step_2"
    staging.mkdir()
    (staging / "0.npy.zst").write_bytes(b"garbage")
    torn = tmp_path / "step_5"
    torn.mkdir()
    assert cm.latest_step() == 1


def test_async_save_then_restore(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    t = _tree(7)
    cm.save(10, t)
    cm.wait()
    np.testing.assert_allclose(cm.restore(10, t)["a"].numpy(),
                               t["a"].numpy())


def test_restore_latest_none(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    step, state = cm.restore_latest(None)
    assert step is None and state is None


def test_save_while_restore_latest_race(tmp_path):
    """keep=1 with an async writer publishing and collecting steps while
    a second manager over the same directory restores the latest: the
    shared directory lock keeps every read whole and monotone."""
    cm_w = CheckpointManager(str(tmp_path), keep=1, async_save=True)
    cm_r = CheckpointManager(str(tmp_path), keep=1)
    t = _tree()
    cm_w.save(0, t)
    cm_w.wait()
    errors, seen_steps = [], []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            try:
                step, state = cm_r.restore_latest(t)
                assert step is not None and state is not None
                seen_steps.append(step)
            except Exception as e:      # noqa: BLE001 — the regression
                errors.append(e)
                return

    th = threading.Thread(target=reader)
    th.start()
    for s in range(1, 40):
        cm_w.save(s, _tree(s))
    cm_w.wait()
    stop.set()
    th.join(timeout=60)
    assert not th.is_alive()
    assert not errors, errors
    assert seen_steps and seen_steps == sorted(seen_steps)


def test_shape_mismatch_rejected(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"a": torch.ones(4)})
    with pytest.raises(ValueError, match="shape"):
        cm.restore(1, {"a": torch.empty(5)})


def test_unknown_codec_rejected(tmp_path):
    with pytest.raises(ValueError, match="codec"):
        CheckpointManager(str(tmp_path), codec="lz4")


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_port_save_restores_in_reference_bit_for_bit(tmp_path, codec):
    """The reference restores a port-written checkpoint bit for bit
    (float32, int32 and bfloat16 leaves, nested keys in sorted order, a
    NamedTuple) and reads the codec tag the port wrote."""
    t = dict(_tree(3), opt=AdamState(mu={"m": torch.ones(2)},
                                     nu={"m": torch.full((2,), 3.0)}))
    CheckpointManager(str(tmp_path), codec=codec).save(5, t)
    with open(tmp_path / "step_5" / "manifest.json") as fh:
        assert f'"codec": "{codec}"' in fh.read()
    like = {"a": jax.ShapeDtypeStruct((16, 8), jnp.float32),
            "nested": {"b": jax.ShapeDtypeStruct((10,), jnp.int32),
                       "c": jax.ShapeDtypeStruct((3,), jnp.bfloat16)},
            "opt": [{"m": jax.ShapeDtypeStruct((2,), jnp.float32)},
                    {"m": jax.ShapeDtypeStruct((2,), jnp.float32)}]}
    step, out = JaxCheckpointManager(str(tmp_path)).restore_latest(like)
    assert step == 5
    assert np.array_equal(np.asarray(out["a"]), t["a"].numpy())
    assert np.array_equal(np.asarray(out["nested"]["b"]),
                          t["nested"]["b"].numpy())
    c = np.asarray(out["nested"]["c"])
    assert c.dtype == ml_dtypes.bfloat16
    assert np.array_equal(c.view(np.int16),
                          t["nested"]["c"].view(torch.int16).numpy())
    assert np.array_equal(np.asarray(out["opt"][1]["m"]), [3.0, 3.0])


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_reference_save_restores_in_port(tmp_path, codec):
    """The port's ``restore_latest`` reads the reference's newest step."""
    jt = {"w": jax.random.normal(jax.random.PRNGKey(0), (4, 3)),
          "h": jnp.ones((2,), jnp.bfloat16)}
    jcm = JaxCheckpointManager(str(tmp_path), keep=2, codec=codec)
    jcm.save(1, jax.tree_util.tree_map(lambda l: l * 0, jt))
    jcm.save(2, jt)
    step, out = CheckpointManager(str(tmp_path)).restore_latest(
        {"w": torch.empty(4, 3), "h": torch.empty(2)})
    assert step == 2
    assert np.array_equal(out["w"].numpy(), np.asarray(jt["w"]))
    assert out["h"].dtype == torch.bfloat16
    assert np.array_equal(out["h"].view(torch.int16).numpy(),
                          np.asarray(jt["h"]).view(np.int16))


def test_async_save_writes_the_snapshot_taken_at_save(tmp_path,
                                                      monkeypatch):
    """``save(wait=False)`` copies every leaf to the host before it
    returns: the caller mutates its tensors in place at once (while the
    writer thread is held back), and the checkpoint still holds the
    values of the moment of ``save``."""
    gate = threading.Event()
    real = tman._COMPRESS["zlib"]
    monkeypatch.setitem(tman._COMPRESS, "zlib",
                        lambda raw: (gate.wait(30), real(raw))[1])
    cm = CheckpointManager(str(tmp_path), async_save=True, codec="zlib")
    t = _tree(1)
    want = {k: (v.clone() if isinstance(v, torch.Tensor) else
                {kk: vv.clone() for kk, vv in v.items()})
            for k, v in t.items()}
    cm.save(1, t)
    t["a"].add_(100.0)
    t["nested"]["c"].mul_(-2)
    gate.set()
    cm.wait()
    assert _equal(cm.restore(1, want), want)
    assert not _equal(cm.restore(1, want), t)
