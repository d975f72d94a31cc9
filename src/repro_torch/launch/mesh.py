"""Serving and training meshes — the port of ``repro/launch/mesh.py``.

Serving: the reference's serving mesh is a jax ``Mesh`` of n devices on
one ``"data"`` axis, over which ``shard_map`` splits a solve's batch rows
or the in-flight slot pool row-wise, with no collective (the depth scan
is local to each row). Its PyTorch counterpart is a ``ServingMesh``: an
ordered tuple of ``torch.device`` entries on that axis. One host loop
drives one shard per entry, each launched on its own device's current
stream (``core/integrate.py``'s ``mesh=`` paths, the sub-pools of
``launch/scheduler.py``), and the results are gathered on the first
entry's device. An entry may repeat a device: the shards then share the
card and one replica of the weights, which runs the partition, the
per-shard launches and the gather at full width on one card.

Training: the reference's ``jax.make_mesh`` with axes ``("data",
"model")`` (and an outer ``"pod"``) becomes a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group, one process per device (``nccl`` on the cards, ``gloo`` on the
CPU, the *fake* group of ``launch/dryrun.py``). ``make_production_mesh``
is the reference's 256- or 512-device mesh, ``make_debug_mesh`` a small
one for the tests and the four-card tool; the step builders of
``launch/steps.py`` take the mesh as ``mesh=`` (the reference's ambient
``mesh_context`` has no counterpart: nothing here needs one). The caller
initialises the process group (``torch.distributed.init_process_group``
with an address, the world size and its rank).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """Devices on the one ``"data"`` axis, in shard order: shard i of a
    batch or slot pool (rows ``[i*B/n, (i+1)*B/n)``) lives on
    ``devices[i]``. A CUDA entry without an index is the current device."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        devs = []
        for d in self.devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a ServingMesh needs at least one device")
        object.__setattr__(self, "devices", tuple(devs))

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("data",)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    # The partition rule, the one place it is written: row block i of the
    # axis (rows ``[i*B/n, (i+1)*B/n)``) on ``devices[i]``, gathered in
    # entry order on ``devices[0]``.
    def split(self, tree: Any, copy: bool = False) -> List[Any]:
        """Row block i of every leaf of ``tree`` on entry i's device, one
        tree per entry (a view where the block already lives there, unless
        ``copy``); None gives None for every entry."""
        if tree is None:
            return [None] * self.size

        def block(leaf, i, d):
            per = leaf.shape[0] // self.size
            return leaf[i * per:(i + 1) * per].to(
                d, non_blocking=d.type == "cuda", copy=copy)

        return [pytree.tree_map(lambda leaf: block(leaf, i, d), tree)
                for i, d in enumerate(self.devices)]

    def gather(self, parts: Sequence[Any], dim: int = 0) -> Any:
        """Concatenate trees along ``dim`` on the first entry's device, in
        the order given (entry order is global row order); a single tree
        is moved, not copied."""
        dev = self.devices[0]
        if len(parts) == 1:
            return moved(parts[0], dev)
        return pytree.tree_map(
            lambda *ls: torch.cat([
                leaf.to(dev, non_blocking=dev.type == "cuda") for leaf in ls],
                dim=dim), *parts)

    def owners(self, rows: np.ndarray, width: int) -> List[Tuple[
            int, np.ndarray, np.ndarray]]:
        """Where the global rows ``rows`` of a ``width``-row axis live:
        ``(entry, positions in rows, rows local to the entry)`` for each
        entry that owns any of them, in entry order."""
        per = width // self.size
        owner = rows // per
        return [(int(i), np.flatnonzero(owner == i),
                 rows[owner == i] - i * per) for i in np.unique(owner)]

    def replicas(self, tree: Any) -> Tuple[Any, ...]:
        """``tree`` once per entry, its leaves on that entry's device: one
        copy per distinct device, shared by repeated entries, and no copy
        on the device the leaves already live on."""
        by_dev: Dict[torch.device, Any] = {}
        for d in self.devices:
            if d not in by_dev:
                by_dev[d] = moved(tree, d)
        return tuple(by_dev[d] for d in self.devices)


def moved(tree: Any, device: torch.device) -> Any:
    """``tree`` with every leaf on ``device`` (a leaf already there is
    itself; None stays None). A copy to a card does not wait for the host;
    a copy to the host waits for the card."""
    return None if tree is None else pytree.tree_map(
        lambda leaf: leaf.to(device, non_blocking=device.type == "cuda"),
        tree)


def make_serving_mesh(n_devices: int, device=None) -> ServingMesh:
    """Pure data-parallel serving mesh: ``n_devices`` entries on one
    ``"data"`` axis, the axis the in-flight slot pool shards over. On
    CUDA (the default, ``repro_torch.resolve_device``) the entries are
    ``cuda:0 .. cuda:n-1``; with ``device="cpu"`` they are ``n_devices``
    CPU entries (the counterpart of the reference's forced host device
    count, so the partition is testable without a card). This is what
    ``launch/serve.py --mesh N`` builds."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    dev = resolve_device(device)
    if dev.type != "cuda":
        return ServingMesh((dev,) * n_devices)
    visible = torch.cuda.device_count()
    if n_devices > visible:
        raise ValueError(
            f"--mesh {n_devices} asks for more devices than visible "
            f"({visible}); on a machine with fewer cards split the pool "
            "over CPU entries with --device cpu")
    return ServingMesh(tuple(torch.device("cuda", i)
                             for i in range(n_devices)))


def axis_names(mesh) -> Tuple[str, ...]:
    """A mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names``, or the
    ``axis_names`` of a ``ServingMesh`` (or a stand-in)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch dimension shards over."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def _device_type() -> str:
    """The device type of the default process group's backend: ``cuda``
    under nccl, else ``cpu`` (gloo, the fake group)."""
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """Single pod: (data=16, model=16) = 256 devices.
    Multi-pod: (pod=2, data=16, model=16) = 512 devices; the 'pod' axis is
    an outer data-parallel axis (only gradient all-reduce). The default
    process group must hold exactly that many ranks (the dry run's fake
    group does)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type or _device_type(), shape,
                            mesh_dim_names=axes)


def make_debug_mesh(n_data: int = 2, n_model: int = 4, device_type=None):
    """A (data, model) mesh over the live default group (gloo on the CPU
    in the tests, nccl on the cards); its world size must be
    ``n_data * n_model``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs "
                         f"{n_data * n_model} ranks; the process group "
                         f"has {world}")
    return init_device_mesh(device_type or _device_type(),
                            (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def sharded_solve(integ, f, z0, grid, *, mesh, **solve_kwargs):
    """Run ``Integrator.solve`` data-parallel over ``mesh``: the leading
    batch axis of the state (and of a batched ``grid.eps``) splits over
    the mesh's ``"data"`` axis and the depth loop runs per shard on its
    own device; batch rows share nothing, so nothing crosses between
    shards until the gather. ``f`` must accept a shard on any entry's
    device.

    Thin policy layer over ``integ.solve(mesh=...)``, which checks
    divisibility before any device work: this checks the rank of
    ``eps`` first."""
    if torch.as_tensor(grid.eps).ndim not in (0, 1):
        raise ValueError(f"grid.eps must be scalar or (B,), got "
                         f"ndim={torch.as_tensor(grid.eps).ndim}")
    return integ.solve(f, z0, grid, mesh=mesh, **solve_kwargs)


def sharded_segment(integ, field_of, xs, carry, seg, *, mesh, s0=0.0):
    """Slot-axis-sharded segment advance WITH per-slot conditioning: the
    multi-device twin of ``Integrator.solve_segment(mesh=)`` for fields
    that condition on the request input (``field_of(x)`` closures, the
    ``DepthModel`` adapters of launch/engine.py). The conditioning rows
    ``xs`` split with the carry, so each shard's field is rebuilt as
    ``field_of(xs_shard)`` from exactly its slots' rows. Returns
    ``(carry', finished)`` like ``solve_segment``, gathered on the first
    entry's device."""
    return integ._solve_segment_sharded(
        None, carry, seg, s0, mesh, field_of=field_of, cond=xs)


def sharded_segment_cell(integ, field_of, seg, *, mesh, s0=0.0,
                         g_apply=None):
    """The serving loop's sharded segment call: ``Integrator.segment_cell``
    over ``mesh``, one per ``(shape, seg, mesh)``. Sharding changes which
    device owns which slot rows, never the in-place write of each
    shard's ``z`` or the stacked ``[k'; finished; nonfinite]`` meta."""
    return integ.segment_cell(field_of, seg, s0=s0, mesh=mesh,
                              g_apply=g_apply)
