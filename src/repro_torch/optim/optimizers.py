"""Optimizers as (init, update) pairs over parameter trees — the port of
``repro/optim/optimizers.py`` (AdamW with decoupled weight decay, SGD
with optional momentum, and the global-norm clip).

Functional, as the reference is: ``update(grads, state, params, step)``
returns new update and moment trees and never writes a tensor in place,
so a caller may hand the old params to another thread (an async
checkpoint) or keep serving them while the next step runs. Trees are
nested dicts/lists/tuples of tensors (``torch.utils._pytree``).

AdamW also carries ``update_in_place``: the same arithmetic leaf by leaf,
writing the new moments and params into the old tensors. It is the
counterpart of the reference trainer's donated buffers
(``repro/launch/steps.py:260``): a whole-tree functional step holds the
new moments, the float32 updates and the new params beside the old ones,
which a 4 B-parameter model cannot afford on one 80 GB card. Its values
equal ``update`` followed by ``apply_updates`` bit for bit.

Over a device mesh (``launch/steps.py``) the leaves are DTensors.
``global_norm`` and ``clip_scale`` then run as DTensor ops, so a leaf
replicated over an axis counts once, not once per device, and the norm
comes out replicated. ``update_in_place`` runs on each device's local
block (``to_local()``) of the gradient and moments; where the params'
placements differ from the moments' (ZeRO-1: params replicated over
``"data"``, moments sharded over it) it updates the params' block the
moments cover and all-gathers the params back into place.

The arithmetic is the reference's, step for step: the schedule is read
at ``step + 1``, the moments stay float32, the bias corrections are
float32 powers of the step, and the weight decay is added to the
normalised direction before the learning rate scales it. Not
``torch.optim.AdamW``, which decays the parameter separately and keeps
its own step count.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, List, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.distributed import sharding as shd

Params = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[..., Any]  # (grads, state, params, step) -> (updates, state)
    # (grads list, state, params, step, scale) -> None; AdamW only
    update_in_place: Optional[Callable[..., None]] = None


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    leaves = [torch.sum(l.float() ** 2) for l in pytree.tree_leaves(tree)]
    return torch.sqrt(sum(leaves))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The float32 factor that brings a tree of global norm ``norm`` to at
    most ``max_norm``."""
    return torch.clamp(max_norm / (norm + 1e-12), max=1.0)


def scaled(leaf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``leaf * scale`` with JAX's promotion: the float32 factor widens a
    bf16 or fp16 leaf to float32 (PyTorch would keep the leaf's type)."""
    return leaf.to(torch.promote_types(leaf.dtype, torch.float32)) * scale


def clip_by_global_norm(tree: Params, max_norm: float):
    """The tree scaled so its global norm is at most ``max_norm``, and the
    norm before clipping."""
    norm = global_norm(tree)
    scale = clip_scale(norm, max_norm)
    return pytree.tree_map(lambda l: scaled(l, scale), tree), norm


def apply_updates(params: Params, updates: Params) -> Params:
    return pytree.tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


# elements an in-place update takes at a time: a stacked leaf (every
# layer's copy of one weight, ~0.9 B elements in Qwen3-4B) would
# otherwise hold ~3.6 GB per float32 temporary
IN_PLACE_CHUNK = 1 << 26


def _chunks(*ts: torch.Tensor):
    """Aligned flat views of equally shaped contiguous tensors, at most
    IN_PLACE_CHUNK elements each (the tensors whole if any is not
    contiguous): elementwise arithmetic over them is the arithmetic over
    the whole tensors."""
    if not all(t.is_contiguous() for t in ts):
        return [ts]
    flat = [t.view(-1) for t in ts]
    n = flat[0].numel()
    return [tuple(f[lo:lo + IN_PLACE_CHUNK] for f in flat)
            for lo in range(0, n, IN_PLACE_CHUNK)] or [ts]


def as_schedule(lr) -> Schedule:
    """``lr`` itself when it is a schedule, else the constant ``lr``."""
    return lr if callable(lr) else (
        lambda s: torch.as_tensor(lr, dtype=torch.float32, device=s.device))


def adam_coefficients(sched: Schedule, b1: float, b2: float, step, dev):
    """(lr_t, bc1, bc2) of an Adam update at ``step``: the schedule at
    ``step + 1`` and the bias corrections, float32 0-d tensors on
    ``dev``."""
    step = torch.as_tensor(step, dtype=torch.float32, device=dev) + 1.0
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    return sched(step), 1.0 - f32(b1) ** step, 1.0 - f32(b2) ** step


class AdamState(NamedTuple):
    mu: Params
    nu: Params


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0,
          moment_dtype: torch.dtype = torch.float32) -> Optimizer:
    """AdamW (Loshchilov & Hutter 2017). ``lr`` is a float or a schedule
    of the step (``optim/schedules.py``)."""
    sched = as_schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                      device=p.device)
        return AdamState(mu=pytree.tree_map(zeros, params),
                         nu=pytree.tree_map(zeros, params))

    def upd_mu(g, m):
        return (b1 * m.float() + (1 - b1) * g.float()).to(moment_dtype)

    def upd_nu(g, v):
        g32 = g.float()
        return (b2 * v.float() + (1 - b2) * g32 * g32).to(moment_dtype)

    def upd(p, m, v, lr_t, bc1, bc2):
        m_hat = m.float() / bc1
        v_hat = v.float() / bc2
        step_dir = m_hat / (torch.sqrt(v_hat) + eps)
        if weight_decay:
            step_dir = step_dir + weight_decay * p.float()
        return -lr_t * step_dir

    def update(grads, state: AdamState, params, step):
        lr_t, bc1, bc2 = adam_coefficients(
            sched, b1, b2, step, pytree.tree_leaves(params)[0].device)
        mu = pytree.tree_map(upd_mu, grads, state.mu)
        nu = pytree.tree_map(upd_nu, grads, state.nu)
        updates = pytree.tree_map(
            lambda p, m, v: upd(p, m, v, lr_t, bc1, bc2), params, mu, nu)
        return updates, AdamState(mu=mu, nu=nu)

    def one_leaf(g, p, m, v, lr_t, bc1, bc2, scale) -> None:
        for gc, pc, mc, vc in _chunks(g, p, m, v):
            if scale is not None:
                gc = scaled(gc, scale)
            mu, nu = upd_mu(gc, mc), upd_nu(gc, vc)
            del gc
            u = upd(pc, mu, nu, lr_t, bc1, bc2)
            mc.copy_(mu)
            vc.copy_(nu)
            del mu, nu
            pc.add_(u.to(pc.dtype))

    def update_in_place(grads: List[Optional[torch.Tensor]],
                        state: AdamState, params, step,
                        scale: Optional[torch.Tensor] = None) -> None:
        """``update`` then ``apply_updates``, one leaf at a time, written
        into ``state``'s moments and ``params``' tensors, IN_PLACE_CHUNK
        elements at a time. ``grads``: the gradients in
        ``pytree.tree_leaves(params)`` order, each multiplied by ``scale``
        (``scaled``) when one is given; the list is consumed, each entry
        set to None once used, so a leaf's gradient is freed before the
        next leaf's temporaries exist. DTensor leaves update their local
        blocks (``_local_blocks``)."""
        leaves = pytree.tree_leaves(params)
        if len(grads) != len(leaves):
            raise ValueError(f"{len(grads)} gradients for {len(leaves)} "
                             "parameter leaves")
        lr_t, bc1, bc2 = adam_coefficients(sched, b1, b2, step,
                                           leaves[0].device)
        if shd.is_dtensor(scale):
            scale = scale.to_local()
        with torch.no_grad():
            for i, (p, m, v) in enumerate(zip(
                    leaves, pytree.tree_leaves(state.mu),
                    pytree.tree_leaves(state.nu))):
                g, grads[i] = grads[i], None
                if shd.is_dtensor(p):
                    with _local_blocks(g, p, m, v) as blocks:
                        one_leaf(*blocks, lr_t, bc1, bc2, scale)
                else:
                    one_leaf(g, p, m, v, lr_t, bc1, bc2, scale)
                del g

    return Optimizer(init=init, update=update,
                     update_in_place=update_in_place)


@contextlib.contextmanager
def _local_blocks(g, p, m, v):
    """The local blocks ``(g, p, m, v)`` of DTensor leaves to update in
    place, in the moments' placements: the gradient redistributed there
    (a no-op when it already is), the params' block cut out of them when
    their placements differ and gathered back into the params on exit."""
    g = g.redistribute(placements=m.placements).to_local()
    same = p.placements == m.placements
    pl = p.to_local() if same else \
        p.redistribute(placements=m.placements).to_local().clone()
    yield g, pl, m.to_local(), v.to_local()
    if not same:
        from torch.distributed.tensor import DTensor
        new = DTensor.from_local(pl, m.device_mesh, m.placements,
                                 shape=p.shape, stride=p.stride())
        p.to_local().copy_(new.redistribute(placements=p.placements)
                           .to_local())


class SgdState(NamedTuple):
    momentum: Optional[Params]


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    """SGD with optional heavy-ball momentum (a float32 buffer). Unlike
    AdamW it reads the schedule at ``step``, as the reference does."""
    sched = as_schedule(lr)

    def init(params):
        if momentum == 0.0:
            return SgdState(momentum=None)
        return SgdState(momentum=pytree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params))

    def update(grads, state: SgdState, params, step):
        dev = pytree.tree_leaves(grads)[0].device
        lr_t = sched(torch.as_tensor(step, dtype=torch.float32, device=dev))
        if momentum == 0.0:
            return pytree.tree_map(lambda g: -lr_t * g.float(), grads), state
        buf = pytree.tree_map(lambda b, g: momentum * b + g.float(),
                              state.momentum, grads)
        return (pytree.tree_map(lambda b: -lr_t * b, buf),
                SgdState(momentum=buf))

    return Optimizer(init=init, update=update)
