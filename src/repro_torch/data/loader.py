"""Prefetching data loader — the port of ``repro/data/loader.py``.

A background thread pulls batches from a host iterator and keeps up to
``prefetch`` of them in a bounded queue, so host data preparation
overlaps device compute; an error raised in the thread surfaces on the
next ``__next__``. On one card the reference's global-batch sharding
becomes a target ``device``: a CPU tensor is pinned and copied with
``non_blocking=True`` (the counterpart of ``jax.device_put``), a tensor
already on the device passes through untouched (``token_batches`` places
its batches itself), and ``device=None`` hands batches on as they come.
With ``mesh`` (a ``DeviceMesh``; every rank iterating the same global
batches) each tensor becomes a DTensor over the mesh's batch axes
(``"data"``, and ``"pod"`` outside it) where they divide its first dim,
each rank keeping its own rows: the reference's global-batch sharding.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterator, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.distributed import sharding as shd


class ShardedLoader:
    def __init__(self, it: Iterator[Any], device=None, prefetch: int = 2,
                 mesh=None):
        self._it = it
        self._mesh = mesh
        self._device = None if device is None else torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _on_target(self, x: torch.Tensor) -> bool:
        dev = self._device
        return x.device.type == dev.type and dev.index in (None,
                                                             x.device.index)

    def _place_leaf(self, x):
        if not isinstance(x, torch.Tensor) or self._on_target(x):
            return x
        if self._device.type == "cuda" and x.device.type == "cpu":
            return x.pin_memory().to(self._device, non_blocking=True)
        return x.to(self._device)

    def _place(self, batch):
        if self._device is not None:
            batch = pytree.tree_map(self._place_leaf, batch)
        if self._mesh is not None:
            batch = pytree.tree_map(self._over_mesh, batch)
        return batch

    def _over_mesh(self, x):
        from torch.distributed.tensor import distribute_tensor
        if not isinstance(x, torch.Tensor) or shd.is_dtensor(x):
            return x
        return distribute_tensor(x, self._mesh, shd.shard_layout(
            self._mesh, x.shape, 0, None), src_data_rank=None)

    def _fill(self):
        try:
            for batch in self._it:
                self._q.put(self._place(batch))
        except BaseException as e:  # surfaced on next __next__
            self._err = e
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
