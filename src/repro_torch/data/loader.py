"""Prefetching data loader — the port of ``repro/data/loader.py``.

A background thread pulls batches from a host iterator and keeps up to
``prefetch`` of them in a bounded queue, so host data preparation
overlaps device compute; an error raised in the thread surfaces on the
next ``__next__``. On one card the reference's global-batch sharding
becomes a target ``device``: a CPU tensor is pinned and copied with
``non_blocking=True`` (the counterpart of ``jax.device_put``), a tensor
already on the device passes through untouched (``token_batches`` places
its batches itself), and ``device=None`` hands batches on as they come.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterator, Optional

import torch
from torch.utils import _pytree as pytree


class ShardedLoader:
    def __init__(self, it: Iterator[Any], device=None, prefetch: int = 2):
        self._it = it
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
        if self._device is None:
            return batch
        return pytree.tree_map(self._place_leaf, batch)

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
