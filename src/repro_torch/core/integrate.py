"""Unified batched integration engine — the port of
``repro/core/integrate.py`` (see its docstring for the full design).

``Integrator`` walks a mesh of explicit Runge-Kutta steps over arbitrary
pytree states (leaf algebra over ``torch.utils._pytree``), with batched
per-sample step sizes, an optional hypersolver correction ``g`` (paper
Eq. 3 + Eq. 5, Poli et al. 2020)

    z_{k+1} = z_k + eps * sum_j b_j r_j + eps^{p+1} * g(eps, s_k, z_k, r_0)

and, with ``fused=True``, the whole per-step update — stage combination,
correction and multi-rate freeze mask — in one pass of the hand-written
CUDA kernel (``kernels/hyper_step``). Where JAX scans, the port loops in
Python: PyTorch runs eagerly, and each step's update is one kernel launch.

Type promotion follows the reference, not PyTorch: a coefficient that is
a tensor (0-d or ``(B,)``) promotes the leaf to the wider of the two
float types, as a JAX array does (a 0-d float32 tensor times a bf16 leaf
is float32 in JAX, bf16 in PyTorch); a Python float keeps the leaf's
type. As in ``lax.scan``, a solve whose step changes the state's dtype
raises instead of carrying on in another precision.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Any, Callable, NamedTuple, Optional, Sequence, Union

import torch
import torch.utils.checkpoint
from torch.utils import _pytree as pytree

from repro_torch.core.tableaus import Tableau, get as get_tableau

Pytree = Any
VectorField = Callable[[Any, Pytree], Pytree]
# g(eps, s, z, dz) -> correction pytree shaped like z; dz = f(s, z) is the
# first RK stage, passed for free reuse (paper feeds g the concat [z, dz, s]).
Correction = Callable[[Any, Any, Pytree, Pytree], Pytree]


# ------------------------------------------------------ leaf-wise algebra ----

def _bcast(a, leaf: torch.Tensor):
    """Right-pad a batched coefficient with singleton axes so it broadcasts
    against ``leaf`` from the leading (batch) axis."""
    if isinstance(a, (int, float)):
        return a
    if a.ndim == 0:
        return a
    return a.reshape(tuple(a.shape) + (1,) * (leaf.ndim - a.ndim))


def _scale(a, x: torch.Tensor):
    """``a * x`` with the reference's promotion: a tensor coefficient
    (0-d included) promotes like a JAX array, a Python number stays weak."""
    a = _bcast(a, x)
    if isinstance(a, torch.Tensor):
        dt = torch.promote_types(a.dtype, x.dtype)
        return a.to(dt) * x.to(dt)
    return a * x


def tree_axpy(a, x: Pytree, y: Pytree) -> Pytree:
    """y + a * x, leaf-wise; ``a`` may be scalar or batched (leading axis)."""
    return pytree.tree_map(lambda xi, yi: yi + _scale(a, xi), x, y)


def tree_lincomb(coeffs: Sequence[float], trees: Sequence[Pytree]) -> Pytree:
    """sum_j coeffs[j] * trees[j], leaf-wise (skips exact-zero coeffs)."""
    terms = [(c, t) for c, t in zip(coeffs, trees) if c != 0.0]
    if not terms:
        return pytree.tree_map(torch.zeros_like, trees[0])
    out = pytree.tree_map(lambda l: terms[0][0] * l, terms[0][1])
    for c, t in terms[1:]:
        out = tree_axpy(c, t, out)
    return out


def depth_like(s, z: torch.Tensor) -> torch.Tensor:
    """Broadcast a depth coordinate ``s`` — scalar, or per-sample (B,) when
    integrating with batched step sizes — to ``z[..., :1]``'s shape, the
    layout dense fields use to concatenate depth as an extra feature. A
    Python number is filled on z's device (no host-to-device copy)."""
    if not isinstance(s, torch.Tensor):
        return torch.full(z[..., :1].shape, s, dtype=z.dtype, device=z.device)
    s = s.to(device=z.device, dtype=z.dtype)
    if s.ndim:
        s = s.reshape(tuple(s.shape) + (1,) * (z.ndim - s.ndim))
    return torch.broadcast_to(s, z[..., :1].shape)


def with_initial(z0: Pytree, traj: Pytree) -> Pytree:
    """Prepend the initial state to a stacked trajectory, leaf-wise."""
    return pytree.tree_map(lambda a, b: torch.cat([a[None], b], dim=0),
                           z0, traj)


def _stack(trees: Sequence[Pytree]) -> Pytree:
    return pytree.tree_map(lambda *ls: torch.stack(ls), *trees)


# ------------------------------------------------------------ mesh shards ----
# A mesh is a ``launch/mesh.py::ServingMesh``: its ``split``/``gather``
# hold the partition rule (row block i on entry i, gathered in entry
# order on entry 0); this module only drives the shards.

def _on(device: Optional[torch.device]):
    """Make ``device`` the current CUDA device while open (nothing on the
    CPU or for None), so a shard's launches go to its own device's current
    stream."""
    return torch.cuda.device(device) \
        if device is not None and device.type == "cuda" \
        else contextlib.nullcontext()


def _check_slots(B: int, mesh) -> None:
    """Refuse a ``B``-slot pool the mesh's ``"data"`` axis cannot split."""
    n = mesh.shape["data"]
    if B % n:
        raise ValueError(
            f"slot count {B} does not divide the 'data' mesh axis ({n}); "
            "size the pool as a multiple of the axis "
            "(launch/scheduler.py slots=)")


def _advance(runs: Sequence, seg: int, s0, devices: Sequence) -> list:
    """Advance each shard's ``(integrator, field, SegmentCarry)`` by
    ``seg`` steps on its device; returns the carries. Step j runs on every
    shard before step j+1 runs on any, so the host waits of one shard's
    step (a field that reads its rows' depth on the host,
    models/cdepth.py) overlap the steps already queued on the other
    devices. Slots never interact, so the order changes no value."""
    carries = [c for _, _, c in runs]
    for _ in range(int(seg)):
        for i, ((integ, f, _), d) in enumerate(zip(runs, devices)):
            with _on(d):
                carries[i], _ = integ.solve_segment(f, carries[i], 1, s0=s0)
    return carries


def _step_index(k: int, like) -> torch.Tensor:
    """The scan counter k as the reference traces it: an int32 scalar, so
    ``s0 + k * eps`` rounds in float32 exactly as the JAX mesh does.
    Filled on the device, so a step costs no host-to-device copy."""
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.full((), k, dtype=torch.int32, device=dev)


def _check_carry(z: Pytree, z_next: Pytree) -> None:
    """``lax.scan``'s carry contract: a step must keep every leaf's dtype."""
    for a, b in zip(pytree.tree_leaves(z), pytree.tree_leaves(z_next)):
        if a.dtype != b.dtype:
            raise TypeError(
                f"solver step changed a state leaf from {a.dtype} to "
                f"{b.dtype} (tensor step sizes promote a low-precision "
                "state on the unfused path); use fused=True or a float32 "
                "state")


def rk_stages(f: VectorField, tab: Tableau, s, eps, z: Pytree,
              first_stage: Optional[Pytree] = None):
    """All stage evaluations r_i of an explicit tableau (paper Eq. 3).
    ``stages[0] == f(s, z)``; a precomputed ``first_stage`` (a controller
    probe's dz) substitutes for it, saving one vector-field evaluation."""
    stages = []
    for i in range(tab.stages):
        if i == 0:
            if first_stage is not None:
                stages.append(first_stage)
                continue
            zi = z
        else:
            zi = tree_axpy(eps, tree_lincomb(tab.a[i], stages), z)
        stages.append(f(s + tab.c[i] * eps, zi))
    return stages


def rk_psi(f: VectorField, tab: Tableau, s, eps, z: Pytree):
    """(psi, stages) where psi = sum_j b_j r_j is the RK update map."""
    stages = rk_stages(f, tab, s, eps, z)
    return tree_lincomb(tab.b, stages), stages


# Storage dtypes the CUDA kernel takes. A CPU state of another dtype takes
# the leaf-wise update with a one-time warning; a CUDA state of another
# dtype raises, because on the card the fused path is the kernel or nothing.
_FUSED_DTYPES = frozenset((torch.float32, torch.bfloat16, torch.float16))


def _fusable(z: Pytree) -> bool:
    """True iff every state leaf is a tensor of a dtype the kernel stores."""
    return all(isinstance(l, torch.Tensor) and l.dtype in _FUSED_DTYPES
               for l in pytree.tree_leaves(z))


def _check_fusable_on_card(z: Pytree) -> None:
    """Raise if a CUDA state leaf has a dtype the kernel does not store."""
    for l in pytree.tree_leaves(z):
        if (isinstance(l, torch.Tensor) and l.device.type == "cuda"
                and l.dtype not in _FUSED_DTYPES):
            raise TypeError(
                f"Integrator(fused=True): a CUDA state leaf is {l.dtype}; "
                "the hyper_step kernel stores only "
                f"{sorted(map(str, _FUSED_DTYPES))}. Use one of those "
                "dtypes or fused=False")


class OneTimeWarning:
    """Resettable one-time RuntimeWarning latch (one per warn-once site).
    Each site exposes a ``reset_*`` function, so tests can re-arm it and
    a warning assertion does not depend on test order."""

    __slots__ = ("warned",)

    def __init__(self) -> None:
        self.warned = False

    def warn(self, message: str, stacklevel: int = 4) -> None:
        if not self.warned:
            warnings.warn(message, RuntimeWarning, stacklevel=stacklevel)
            self.warned = True

    def reset(self) -> None:
        self.warned = False


_fused_fallback = OneTimeWarning()


def reset_fused_fallback_warning() -> None:
    """Re-arm the one-time fused-fallback RuntimeWarning (test isolation)."""
    _fused_fallback.reset()


def _nonfinite_rows(z: Pytree, like: torch.Tensor) -> torch.Tensor:
    """Per-slot non-finite flag: True where any floating element of a
    slot's state row is NaN/Inf, reduced over every non-slot axis of
    every floating leaf (row-wise: a row's flag depends only on its own
    data). ``like`` supplies the (B,) shape and device for stateless
    pools."""
    flags = [~torch.isfinite(l).reshape(l.shape[0], -1).all(dim=1)
             for l in pytree.tree_leaves(z)
             if isinstance(l, torch.Tensor) and l.is_floating_point()]
    if not flags:
        return torch.zeros_like(like, dtype=torch.bool)
    bad = flags[0]
    for f in flags[1:]:
        bad = bad | f
    return bad


class SegmentCarry(NamedTuple):
    """Resumable per-slot state of a segmented multi-rate solve: one row
    per slot (leading axis B on every tensor and leaf). ``z`` is a
    slot's current state, ``k`` the next depth step it takes, ``Ks`` its
    target mesh length (0 = empty slot), ``eps`` its step size;
    ``first_stage`` optionally carries the admission probe's
    ``dz0 = f(s0, z0)`` rows, substituted as stage 0 exactly while a slot
    is still at ``k == 0``. Occupancy is data, never a shape: an empty
    slot has ``Ks == 0``, so ``k < Ks`` is always False and the freeze
    mask keeps its row inert."""

    z: Pytree
    k: torch.Tensor                 # (B,) int32 — next depth-step index
    Ks: torch.Tensor                # (B,) int32 — target mesh lengths
    eps: torch.Tensor               # (B,) float32 — per-slot step sizes
    first_stage: Optional[Pytree]   # probe dz0 rows, used only at k == 0


def make_segment_carry(z0: Pytree, Ks, span, *,
                       first_stage: Optional[Pytree] = None) -> SegmentCarry:
    """Fresh carry for a slot batch: every slot at ``k = 0`` with
    ``eps_i = (s1 - s0) / Ks[i]``, the arithmetic of ``solve_multirate``
    (float32), so a segment-driven solve walks the same mesh. An empty
    slot (``Ks[i] == 0``) gets eps 1.0, so no inf or NaN rides along in
    its frozen row."""
    s0, s1 = span
    dev = pytree.tree_leaves(z0)[0].device
    Ks = torch.as_tensor(Ks, dtype=torch.int32, device=dev)
    eps = torch.tensor(s1 - s0, dtype=torch.float32, device=dev) \
        / torch.clamp(Ks, min=1)
    eps = torch.where(Ks > 0, eps, torch.ones_like(eps))
    return SegmentCarry(z=z0, k=torch.zeros_like(Ks), Ks=Ks, eps=eps,
                        first_stage=first_stage)


@dataclasses.dataclass(frozen=True)
class SolveStats:
    """Per-sample accounting from a controller-driven solve. ``nfe``
    includes the probe cost; ``K`` is the selected mesh length; ``err_probe``
    the probe's local-error estimate (0 for FixedController)."""

    nfe: torch.Tensor        # (B,) int32 — vector-field evals incl. probe
    K: torch.Tensor          # (B,) int32 — selected mesh lengths
    err_probe: torch.Tensor  # (B,) float32 — probe local-error estimate
    probe_nfe: int           # per-sample probe cost included in ``nfe``


# ------------------------------------------------------------- the engine ----

@dataclasses.dataclass(frozen=True)
class Integrator:
    """A base explicit-RK tableau, optionally paired with a hypersolver
    correction ``g`` of matching order (paper Sec. 3), and the fused
    CUDA update path (``fused=True``: one kernel pass per leaf per step,
    for scalar and per-sample step sizes alike; a CPU state of a dtype
    outside ``_FUSED_DTYPES`` takes the leaf-wise path, a CUDA one raises)."""

    tableau: Tableau
    g: Optional[Correction] = None
    fused: bool = False

    @property
    def order(self) -> int:
        return self.tableau.order

    @property
    def name(self) -> str:
        base = self.tableau.name
        return f"hyper_{base}" if self.g is not None else base

    def with_tableau(self, tab: Union[str, Tableau]) -> "Integrator":
        """Swap the base tableau, keeping g (paper Sec. 4.1: an alpha-family
        hypersolver evaluated under sibling tableaus without finetuning)."""
        tab = get_tableau(tab) if isinstance(tab, str) else tab
        return dataclasses.replace(self, tableau=tab)

    def nfe(self, K: int) -> int:
        """Vector-field evaluations over K steps (g counted separately as
        overhead, paper Sec. 6)."""
        return self.tableau.stages * K

    def fused_available(self, eps=None, z: Optional[Pytree] = None) -> bool:
        """True iff the fused kernel path will run (``eps`` gates nothing;
        pass the state as ``z=`` to vet its dtypes)."""
        del eps
        return self.fused and (z is None or _fusable(z))

    # ------------------------------------------------------------- step ----
    def step(self, f: VectorField, s, eps, z: Pytree,
             first_stage: Optional[Pytree] = None,
             active: Optional[torch.Tensor] = None):
        """One (hyper)solved step. Returns (z_next, psi, dz).

        ``eps`` may be a Python float, a 0-d tensor, or a per-sample
        ``(B,)`` row. ``active`` is an optional ``(B,)`` mask row:
        inactive samples keep ``z`` (the multi-rate freeze) — inside the
        kernel on the fused path, a trailing ``where`` otherwise. ``psi``
        is None on the fused path (the kernel combined the stages)."""
        tab = self.tableau
        use_kernel = self.fused and _fusable(z)
        if self.fused and not use_kernel:
            _check_fusable_on_card(z)
            _fused_fallback.warn(
                "Integrator(fused=True): state dtypes outside the kernel "
                f"set {sorted(map(str, _FUSED_DTYPES))}; falling back to "
                "the leaf-wise update path for this solve.")
        stages = rk_stages(f, tab, s, eps, z, first_stage=first_stage)
        dz = stages[0]
        corr = self.g(eps, s, z, dz) if self.g is not None else None
        if use_kernel:
            from repro_torch.kernels.hyper_step.ops import fused_rk_update
            # zero-b stages never reach the kernel: each operand costs a
            # full memory read per step, the whole traffic the fusion saves
            live = tuple((bj, r) for bj, r in zip(tab.b, stages)
                         if bj != 0.0)
            b_live = tuple(bj for bj, _ in live)
            n_live = len(live)
            z_next = pytree.tree_map(
                lambda zl, *rest: fused_rk_update(
                    zl, rest[:n_live],
                    rest[n_live] if corr is not None else None,
                    eps, b_live, tab.order, active=active),
                z, *(r for _, r in live),
                *((corr,) if corr is not None else ()))
            psi = None
        else:
            psi = tree_lincomb(tab.b, stages)
            z_next = tree_axpy(eps, psi, z)
            if corr is not None:
                ceps = eps ** (self.order + 1)
                z_next = tree_axpy(ceps, corr, z_next)
            if active is not None:
                z_next = pytree.tree_map(
                    lambda a, b_: torch.where(_bcast(active, b_), a, b_),
                    z_next, z)
        return z_next, psi, dz

    # ------------------------------------------------------------ solve ----
    def solve(self, f: VectorField, z0: Pytree, grid, *,
              return_traj: bool = True, checkpoint: bool = False,
              controller=None, first_stage: Optional[Pytree] = None,
              mesh=None):
        """Integrate z' = f(s, z) over ``grid`` (a FixedGrid; ``grid.eps``
        may carry a leading batch axis, and then ``f`` receives a batched
        ``s``: lift it with ``depth_like``). Returns the trajectory
        stacked on a leading axis of length K+1 (z0 included) when
        ``return_traj``, else the terminal state. ``checkpoint=True``
        recomputes each step in the backward pass
        (``torch.utils.checkpoint``, non-reentrant) instead of keeping its
        stages, the reference's per-step ``jax.checkpoint``.

        With a ``controller`` (core/controllers.py) ``grid`` supplies only
        the span; the controller probes z0 and picks per-sample mesh
        lengths, and the solve runs the masked multi-rate loop. Returns
        ``(result, SolveStats)``. ``first_stage`` is a precomputed
        f(s0, z0) reused as stage 0 of the first step.

        ``mesh`` (a ``launch/mesh.py::ServingMesh``) solves data-parallel:
        the leading batch rows of every state leaf (and a ``(B,)``
        ``grid.eps``) split row-wise over the mesh's ``"data"`` axis, each
        shard is solved on its entry's device, one shard after another,
        and the result (stats too) is gathered on the first entry's
        device. Batch rows share nothing, so the shards never exchange
        data; ``f`` must accept a shard on any entry's device. The batch
        must divide the axis."""
        if mesh is not None:
            return self._solve_sharded(
                f, z0, grid, mesh, return_traj=return_traj,
                checkpoint=checkpoint, controller=controller,
                first_stage=first_stage)
        if controller is not None:
            return self._solve_controlled(f, z0, grid, controller,
                                          return_traj)
        eps = grid.eps
        ref = pytree.tree_leaves(z0)[0]

        def body(s, z):
            return self.step(f, s, eps, z)[0]

        z, traj = z0, []
        for k in range(grid.K):
            if k == 0 and first_stage is not None:
                z_next, _, _ = self.step(f, grid.s0, eps, z,
                                         first_stage=first_stage)
            else:
                s = grid.s0 + _step_index(k, ref) * eps
                z_next = torch.utils.checkpoint.checkpoint(
                    body, s, z, use_reentrant=False) if checkpoint \
                    else body(s, z)
            _check_carry(z, z_next)
            z = z_next
            if return_traj:
                traj.append(z)
        if not return_traj:
            return z
        return with_initial(z0, _stack(traj)) if traj else \
            pytree.tree_map(lambda a: a[None], z0)

    def solve_multirate(self, f, z0: Pytree, span, Ks, k_max: int, *,
                        first_stage: Optional[Pytree] = None,
                        return_traj: bool = False):
        """Masked multi-rate solve over per-sample mesh lengths: sample i
        integrates ``span`` in ``Ks[i]`` uniform steps (eps_i = (s1 - s0)
        / Ks[i]); the loop runs ``k_max`` steps and freezes sample i once
        ``k >= Ks[i]``. On the fused path each step's masked update is
        one kernel pass per leaf. This is the serving engine's entry
        point (launch/engine.py)."""
        s0, s1 = span
        ref = pytree.tree_leaves(z0)[0]
        Ks = torch.as_tensor(Ks, dtype=torch.int32, device=ref.device)
        ks_hi = int(Ks.max())
        if ks_hi > int(k_max):
            raise ValueError(
                f"k_max={int(k_max)} truncates samples with K up to "
                f"{ks_hi}: their scan would stop mid-span")
        # (B,) per-sample step sizes, float32 as the reference computes them
        eps = torch.tensor(s1 - s0, dtype=torch.float32,
                           device=ref.device) / Ks
        # step 0 is always active (K_i >= 1) and can reuse a probe's dz0
        z, _, _ = self.step(f, s0, eps, z0, first_stage=first_stage)
        _check_carry(z0, z)
        traj = [z]
        for k in range(1, int(k_max)):
            kt = _step_index(k, ref)
            z_next, _, _ = self.step(f, s0 + kt * eps, eps, z,
                                     active=(kt < Ks))
            _check_carry(z, z_next)
            z = z_next
            traj.append(z)
        if not return_traj:
            return z
        return with_initial(z0, _stack(traj))

    def _solve_controlled(self, f, z0, grid, controller, return_traj):
        """Probe, pick per-sample mesh lengths, run the masked multi-rate
        loop, and account per-sample NFE."""
        if torch.as_tensor(grid.eps).ndim != 0:
            raise ValueError("controller-driven solve derives per-sample eps "
                             "itself; pass a scalar-eps grid defining the span")
        s0 = grid.s0
        s1 = s0 + grid.eps * grid.K
        probe = controller.select(self, f, z0, (s0, s1))
        result = self.solve_multirate(
            f, z0, (s0, s1), probe.K, int(controller.k_max),
            first_stage=probe.dz0, return_traj=return_traj)
        reused = 1 if probe.dz0 is not None else 0
        stats = SolveStats(
            nfe=(probe.nfe - reused
                 + self.tableau.stages * probe.K).to(torch.int32),
            K=probe.K,
            err_probe=torch.as_tensor(probe.err, dtype=torch.float32),
            probe_nfe=int(probe.nfe),
        )
        return result, stats

    def _solve_sharded(self, f, z0, grid, mesh, *, return_traj,
                       checkpoint, controller, first_stage):
        """Data-parallel solve: each row block of the batch is solved on
        its mesh entry's device, then gathered on the first entry's (a
        trajectory along its batch axis, 1). No shard reads another's
        rows."""
        B = pytree.tree_leaves(z0)[0].shape[0]
        n = mesh.shape["data"]
        if B % n:
            raise ValueError(
                f"batch {B} does not divide the 'data' mesh axis ({n}); "
                "pad or re-bucket the request batch "
                "(launch/engine.py max_batch)")
        eps = grid.eps
        if isinstance(eps, torch.Tensor) and eps.ndim:
            eps_sh = mesh.split(eps)
        elif isinstance(eps, torch.Tensor):
            eps_sh = [eps.to(d) for d in mesh.devices]
        else:
            eps_sh = [eps] * n
        outs = []
        for d, z_i, e_i, fs_i in zip(mesh.devices, mesh.split(z0), eps_sh,
                                     mesh.split(first_stage)):
            with _on(d):
                outs.append(self.solve(
                    f, z_i, grid._replace(eps=e_i), return_traj=return_traj,
                    checkpoint=checkpoint, controller=controller,
                    first_stage=fs_i))
        dim = 1 if return_traj else 0
        if controller is None:
            return mesh.gather(outs, dim)
        stats = [st for _, st in outs]
        return mesh.gather([res for res, _ in outs], dim), SolveStats(
            nfe=mesh.gather([st.nfe for st in stats]),
            K=mesh.gather([st.K for st in stats]),
            err_probe=mesh.gather([st.err_probe for st in stats]),
            probe_nfe=stats[0].probe_nfe)

    # ---------------------------------------------------------- segments ----
    def solve_segment(self, f, carry: SegmentCarry, seg: int, *, s0=0.0,
                      mesh=None):
        """Advance every slot of ``carry`` by ``seg`` depth steps; returns
        ``(carry', finished)`` — the resumable core of in-flight batching
        (launch/scheduler.py).

        Slot i steps at ``eps_i`` from ``s = s0 + k_i * eps_i`` and
        freezes (state and counter) once ``k_i >= Ks_i``: the masked
        update ``solve_multirate`` runs, so a batch driven to completion
        segment by segment is step for step one ``solve_multirate`` call
        with the same ``Ks``. Between segments a caller may retire
        finished slots and refill them (a new z row, ``k = 0``, a new
        ``Ks``/``eps``). A slot admitted with a probe ``first_stage`` row
        uses it on its ``k == 0`` step only; the field is evaluated once
        per step for the whole batch either way.

        ``finished`` is ``k >= Ks`` after the segment (True for empty
        slots too: callers keep their own occupancy). Each step is one
        eager call; on the fused path its update is one kernel launch
        per state leaf.

        ``mesh`` shards the SLOT axis as ``solve(mesh=)`` shards the batch
        axis: every ``SegmentCarry`` field is slot-major, so the carry
        splits row-wise over the mesh's ``"data"`` axis, each shard runs
        its ``seg`` steps on its entry's device (step j on every shard
        before step j+1), and ``(z', k', finished)`` are gathered on the
        first entry's device (``Ks``, ``eps`` and ``first_stage`` pass
        through). The slot count must divide the axis. ``f`` must be
        slot-local: per-slot conditioning must split WITH the carry,
        which ``launch/mesh.py::sharded_segment`` does."""
        if mesh is not None:
            return self._solve_segment_sharded(f, carry, seg, s0, mesh)
        z, k, Ks, eps, fs = carry
        for _ in range(int(seg)):
            active = k < Ks
            s = s0 + k * eps
            if fs is None:
                dz0 = None
            else:
                # fresh slots (k == 0) take their probe's dz row as stage
                # 0: the same values as f(s0, z) there, so the probe's
                # saved evaluation stays honest in the NFE accounting
                dz = f(s, z)
                fresh = k == 0
                dz0 = pytree.tree_map(
                    lambda a, b: torch.where(_bcast(fresh, b), a, b), fs, dz)
            z_next, _, _ = self.step(f, s, eps, z, first_stage=dz0,
                                     active=active)
            _check_carry(z, z_next)
            z = z_next
            k = torch.where(active, k + 1, k)
        return SegmentCarry(z, k, Ks, eps, fs), k >= Ks

    def segment_cell(self, field_of, seg: int, *, s0=0.0, g_apply=None,
                     mesh=None):
        """The serving loop's segment call: ``run(xs, z, k, Ks, eps, fs)
        -> (z', fs', meta)`` (with ``g_apply``, a trailing ``gp``
        operand: ``g = g_apply(gp, eps, s, z, dz)`` is bound per call, so
        the correction's params are an input, not a constant of the cell).

        ``meta`` is the stacked ``(3, B)`` int32 ``[k'; finished;
        nonfinite]`` on the state's device: one device-to-host transfer
        retires a segment, and the caller may read it a segment later
        (the overlap loop). ``nonfinite`` (``_nonfinite_rows`` of the
        post-segment state) is the per-slot quarantine flag.

        The reference's buffer donation on PyTorch terms: the pool's
        ``z`` is a preallocated buffer, and the cell writes ``z'`` into
        its storage (the returned ``z'`` is the same tensor), so slot
        state never gets a second pool-sized buffer between segments;
        ``fs'`` is ``fs`` itself, untouched. Any read of the old state (a
        readout gather, a refill scatter) must be enqueued before the
        call, which stream order then keeps.

        With ``mesh``, one cell per ``(shape, seg, mesh)`` drives one
        sub-pool per mesh entry: ``xs``, ``z``, ``k``, ``Ks``, ``eps``
        and ``fs`` (when not None) are sequences with one shard per
        entry (rows ``[i*B/n, (i+1)*B/n)`` of the global pool, on entry
        i's device), and so is ``gp``, one params tree per entry.
        ``field_of`` is called on each shard's own conditioning rows (it
        must build a field on their device), step j runs on every shard
        before step j+1 runs on any (``_advance``), each shard's ``z`` is
        written in place, and the ``(3, B)`` meta is gathered on the
        first entry's device in global slot order."""

        def shard(xs, z, k, Ks, eps, fs, gp):
            integ = self
            if g_apply is not None:
                (params,) = gp
                integ = dataclasses.replace(
                    self, g=lambda e, s, zz, dzz: g_apply(params, e, s, zz,
                                                          dzz))
            return integ, field_of(xs), SegmentCarry(
                z, k.to(torch.int32), Ks.to(torch.int32), eps, fs)

        def finish(z, out: SegmentCarry) -> torch.Tensor:
            fin = out.k >= out.Ks
            bad = _nonfinite_rows(out.z, like=fin)
            meta = torch.stack([out.k.to(torch.int32), fin.to(torch.int32),
                                bad.to(torch.int32)])
            for dst, src in zip(pytree.tree_leaves(z),
                                pytree.tree_leaves(out.z)):
                dst.copy_(src)
            return meta

        if mesh is None:
            def run(xs, z, k, Ks, eps, fs, *gp):
                (out,) = _advance([shard(xs, z, k, Ks, eps, fs, gp)], seg,
                                  s0, [None])
                return z, fs, finish(z, out)

            return run
        devices, n = mesh.devices, mesh.shape["data"]

        def run_sharded(xs, z, k, Ks, eps, fs, *gp):
            if any(len(a) != n for a in (xs, z, k, Ks, eps) + (
                    () if fs is None else (fs,)) + gp):
                raise ValueError(
                    "a sharded segment takes one shard per entry of the "
                    f"'data' mesh axis ({n})")
            runs = []
            for i, d in enumerate(devices):
                with _on(d):
                    runs.append(shard(xs[i], z[i], k[i], Ks[i], eps[i],
                                      None if fs is None else fs[i],
                                      tuple(g[i] for g in gp)))
            metas = []
            for d, z_i, out in zip(devices, z,
                                   _advance(runs, seg, s0, devices)):
                with _on(d):
                    metas.append(finish(z_i, out))
            with _on(devices[0]):
                return z, fs, mesh.gather(metas, dim=1)

        return run_sharded

    def _solve_segment_sharded(self, f, carry, seg, s0, mesh, *,
                               field_of=None, cond=None):
        """Slot-parallel segment advance: split every carry field (and,
        with ``field_of``/``cond`` from ``launch/mesh.py::
        sharded_segment``, the per-slot conditioning rows ``cond``, each
        shard's field rebuilt as ``field_of(cond_shard)``; ``f`` is then
        ignored) over the mesh, advance the shards on their devices
        (``_advance``), and gather ``(z', k', finished)`` on the first
        entry's. Both entry points share this one plumbing, so their
        divisibility policy cannot diverge."""
        z, k, Ks, eps, fs = carry
        k = torch.as_tensor(k, dtype=torch.int32)
        _check_slots(int(k.shape[0]), mesh)
        parts = zip(mesh.devices, *(mesh.split(t) for t in (
            z, k, torch.as_tensor(Ks, dtype=torch.int32), eps, fs, cond)))
        runs = []
        for d, z_i, k_i, Ks_i, eps_i, fs_i, c_i in parts:
            with _on(d):
                runs.append((self, f if cond is None else field_of(c_i),
                             SegmentCarry(z_i, k_i, Ks_i, eps_i, fs_i)))
        outs = _advance(runs, seg, s0, mesh.devices)
        return SegmentCarry(mesh.gather([o.z for o in outs]),
                            mesh.gather([o.k for o in outs]), Ks, eps,
                            fs), mesh.gather([o.k >= o.Ks for o in outs])


def as_integrator(solver, g: Optional[Correction] = None,
                  fused: bool = False) -> Integrator:
    """Coerce a tableau name / Tableau / Integrator / HyperSolver-like
    object (anything with .tableau/.g/.fused) into an Integrator."""
    if isinstance(solver, Integrator):
        return solver
    if isinstance(solver, str):
        return Integrator(tableau=get_tableau(solver), g=g, fused=fused)
    if isinstance(solver, Tableau):
        return Integrator(tableau=solver, g=g, fused=fused)
    if hasattr(solver, "tableau"):
        return Integrator(tableau=solver.tableau,
                          g=getattr(solver, "g", g),
                          fused=getattr(solver, "fused", fused))
    raise TypeError(f"cannot build an Integrator from {solver!r}")
