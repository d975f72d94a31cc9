"""Checkpointing — the port of ``repro/checkpoint/manager.py``: atomic
writes, keep-N garbage collection, an async saver thread, and restore.

Layout: ``<dir>/step_<N>/{manifest.json, <i>.npy.zst}``, one raw
little-endian buffer per leaf, compressed with the codec the manifest
names: "zstd" when the ``zstandard`` package imports, else "zlib" (or
"raw"). The manifest records the codec, the leaf count, dtypes and
shapes, so the JAX package restores what this one writes and the other
way round (``--g-ckpt`` and ``--flow-ckpt`` read either). Leaves are
numbered in JAX's ``tree_flatten`` order, which sorts dict keys: an LM
correction is stored as ``w_dh, w_h, w_out, w_s``.

A step becomes visible only when its ``.tmp_step_<N>`` staging directory
is renamed to ``step_<N>`` (a crash mid-write leaves nothing that
``latest_step`` picks). ``save`` copies every leaf to the host on the
caller's thread before the write starts, so the saver thread never
touches a CUDA tensor and a caller may change its tensors the moment
``save`` returns. One re-entrant lock per directory (``_dir_lock``)
makes publish + GC and pick + read atomic against each other across
manager instances of one process; ``restore_latest`` rescans when a
writer in another process deletes the step it picked.

Elastic restore (the reference's re-shard to whatever mesh is live):
a tree of DTensors (a train step over a device mesh) is saved as whole
tensors, each leaf gathered (``full_tensor()``, a collective every rank
of the mesh joins) and written by rank 0 alone, synchronously, the ranks
then meeting at a barrier, so no rank can pick a step another has not
finished. ``restore`` distributes each leaf onto the placements of the
``like`` tree's DTensor at the same position, so a checkpoint written on
a (2, 2) mesh restores onto (4, 1), or as plain tensors onto one device,
unchanged.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

try:  # optional dependency, as in the reference
    import zstandard
except ImportError:
    zstandard = None

DEFAULT_CODEC = "zstd" if zstandard is not None else "zlib"

_COMPRESS = {
    "zstd": (lambda raw: zstandard.ZstdCompressor(level=3).compress(raw)),
    "zlib": (lambda raw: zlib.compress(raw, 3)),
    "raw": (lambda raw: raw),
}


def _decompress(codec: str, buf: bytes) -> bytes:
    if codec == "zstd":
        if zstandard is None:
            raise RuntimeError(
                "checkpoint was written with codec='zstd' but the zstandard "
                "package is not installed")
        return zstandard.ZstdDecompressor().decompress(buf)
    if codec == "zlib":
        return zlib.decompress(buf)
    if codec == "raw":
        return buf
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _to_tensor(raw: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(dtype))
                            .reshape(shape).copy())


def _host_leaf(t) -> Tuple[bytes, str, List[int]]:
    """A leaf's raw little-endian bytes, dtype name (the reference's
    numpy name: "bfloat16" for bf16) and shape, copied off the leaf."""
    t = torch.as_tensor(t).detach()
    shape = list(t.shape)
    if t.dtype == torch.bfloat16:
        arr, name = t.cpu().view(torch.int16).numpy(), "bfloat16"
    else:
        arr = t.cpu().numpy()
        name = str(arr.dtype)
    return np.ascontiguousarray(arr).tobytes(), name, shape


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def flatten_sorted(tree: Any) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """Leaves in JAX's ``tree_flatten`` order (dict keys sorted; lists,
    tuples and NamedTuples in order; None is an empty subtree) and a
    function rebuilding the tree from such a list."""
    leaves: List[Any] = []

    def walk(t):
        if isinstance(t, dict):
            keys = sorted(t)
            subs = [walk(t[k]) for k in keys]
            return lambda it: {k: s(it) for k, s in zip(keys, subs)}
        if isinstance(t, (list, tuple)):
            subs = [walk(x) for x in t]
            if hasattr(t, "_fields"):        # a NamedTuple takes fields
                return lambda it: type(t)(*[s(it) for s in subs])
            return lambda it: type(t)(s(it) for s in subs)
        if t is None:
            return lambda it: None
        leaves.append(t)
        return lambda it: next(it)

    build = walk(tree)
    return leaves, lambda new: build(iter(new))


def treedef_str(tree: Any) -> str:
    """The tree's structure in the reference's ``PyTreeDef`` notation
    (informational: restore reads the leaf count, not this)."""
    def walk(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, (list, tuple)):
            inner = ", ".join(walk(x) for x in t)
            if hasattr(t, "_fields"):
                return f"{type(t).__name__}(" + ", ".join(
                    f"{f}={walk(x)}" for f, x in zip(t._fields, t)) + ")"
            return f"[{inner}]" if isinstance(t, list) else f"({inner},)"
        return "None" if t is None else "*"
    return f"PyTreeDef({walk(tree)})"


# One re-entrant lock per checkpoint DIRECTORY, shared by every manager
# of this process over it (a refinery's async candidate saver and a
# reader restoring the latest step): publish + GC and pick + read each
# run under it.
_DIR_LOCKS: Dict[str, threading.RLock] = {}
_DIR_LOCKS_GUARD = threading.Lock()


def _dir_lock(directory: str) -> threading.RLock:
    key = os.path.realpath(directory)
    with _DIR_LOCKS_GUARD:
        return _DIR_LOCKS.setdefault(key, threading.RLock())


class CheckpointManager:
    """Save and restore trees of tensors under ``directory``; ``keep``
    newest steps survive each save; ``async_save`` writes on a thread
    (one in flight: the next save first waits for it)."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False, codec: str = DEFAULT_CODEC):
        if codec not in _COMPRESS:
            raise ValueError(f"unknown codec {codec!r}; have {sorted(_COMPRESS)}")
        if codec == "zstd" and zstandard is None:
            raise RuntimeError("codec='zstd' requires the zstandard package")
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self.codec = codec
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)
        self._lock = _dir_lock(directory)

    # ------------------------------------------------------------- save ----
    def save(self, step: int, tree: Any, wait: bool = False) -> None:
        """Write ``tree`` as step ``step``. The leaves are copied to the
        host here, on the caller's thread; with ``async_save`` (and not
        ``wait``) the write then runs on the saver thread."""
        flat, _ = flatten_sorted(tree)
        sharded = any(_is_dtensor(l) for l in flat)
        if sharded:     # every rank gathers; rank 0 writes, synchronously
            flat = [l.full_tensor() if _is_dtensor(l) else l for l in flat]
            if _rank() != 0:
                _barrier()
                return
            wait = True
        host = [_host_leaf(l) for l in flat]
        structure = treedef_str(tree)

        def write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for i, (raw, _, _) in enumerate(host):
                with open(os.path.join(tmp, f"{i}.npy.zst"), "wb") as fh:
                    fh.write(_COMPRESS[self.codec](raw))
            manifest = {
                "step": step,
                "codec": self.codec,
                "n_leaves": len(host),
                "treedef": structure,
                "dtypes": [d for _, d, _ in host],
                "shapes": [s for _, _, s in host],
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as fh:
                json.dump(manifest, fh)
                fh.flush()
                os.fsync(fh.fileno())
            with self._lock:   # publish + GC atomic w.r.t. pick + read
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()

        if self.async_save and not wait:
            self.wait()
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            self.wait()
            write()
        if sharded:
            _barrier()

    def wait(self) -> None:
        """Block until the pending async save, if any, is on disk."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ---------------------------------------------------------- restore ----
    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def restore(self, step: int, like: Any, device=None) -> Any:
        """``like``: a tree with the target structure whose leaves have
        ``.shape`` (tensors). Returns the same tree of tensors on
        ``device``, each in the dtype the checkpoint stored; where a
        ``like`` leaf is a DTensor, a DTensor on its mesh and placements
        (each rank reads the whole leaf and keeps its block)."""
        d = os.path.join(self.dir, f"step_{step}")
        with self._lock:   # hold off a concurrent publish/GC over the reads
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            flat_like, unflatten = flatten_sorted(like)
            if manifest["n_leaves"] != len(flat_like):
                raise ValueError(f"checkpoint {d} holds "
                                 f"{manifest['n_leaves']} leaves, the target "
                                 f"tree {len(flat_like)}")
            codec = manifest.get("codec", "zstd")  # pre-tag ckpts: zstd
            out = []
            for i, l in enumerate(flat_like):
                with open(os.path.join(d, f"{i}.npy.zst"), "rb") as fh:
                    raw = _decompress(codec, fh.read())
                t = _to_tensor(raw, manifest["dtypes"][i],
                               manifest["shapes"][i])
                if tuple(t.shape) != tuple(l.shape):
                    raise ValueError(f"leaf {i}: checkpoint shape "
                                     f"{tuple(t.shape)}, target "
                                     f"{tuple(l.shape)}")
                if _is_dtensor(l):
                    from torch.distributed.tensor import distribute_tensor
                    t = distribute_tensor(t.to(l.device), l.device_mesh,
                                          l.placements, src_data_rank=None)
                elif device is not None:
                    t = t.to(device)
                out.append(t)
        return unflatten(out)

    def restore_latest(self, like: Any, device=None, retries: int = 3):
        """(step, tree) of the newest visible step, or (None, None) when
        there is none; pick and read hold the directory lock, and a step
        deleted by another process between them triggers a rescan."""
        last_err: Optional[FileNotFoundError] = None
        for _ in range(max(int(retries), 1)):
            with self._lock:
                step = self.latest_step()
                if step is None:
                    return None, None
                try:
                    return step, self.restore(step, like, device)
                except FileNotFoundError as e:
                    last_err = e   # cross-process GC: rescan for newer
        raise last_err

    # --------------------------------------------------------------- gc ----
    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1)) for m in
            (re.fullmatch(r"step_(\d+)", n) for n in os.listdir(self.dir)) if m
        )
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
