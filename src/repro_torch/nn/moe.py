"""Mixture-of-experts with capacity dispatch — the port of ``repro/nn/moe.py``.

Softmax routing over ``n_experts``, top-k (ties toward the lower expert
index, as ``jax.lax.top_k``), gates renormalised, each expert holding at
most C = ceil(k · T · capacity_factor / E) of the T tokens' k routing
slots; a slot past C is dropped (its contribution is zero). Stacked
expert weights ``wi``/``wg`` ``(E, d, f)`` and ``wd`` ``(E, f, d)`` run as
batched GEMMs over ``(E, C, d)`` buffers; the dispatch itself (sort,
gather, combine) is plain PyTorch.

The two dispatches differ in which slots a full expert keeps, and each
keeps its reference's order:

* ``moe_apply`` (the reference's einsum dispatch, the decode path) fills
  expert queues slot-major: every token's first choice before any
  second choice; its combine weighs expert outputs by gates rounded to
  the activation type.
* ``moe_apply_sorted`` (train and full-sequence forward) fills them
  token-major, through a stable sort; its combine weighs in float32.

Both take ``groups``: ``"all"`` dispatches the B·S tokens together (the
reference's call); ``"row"`` dispatches each batch row alone (what the
reference's ``vmap`` over samples gives a per-sample depth field);
``"position"`` dispatches each position's B tokens alone (the
reference's prefill: one decode step per position). Every group gets
its own capacity, and the expert GEMMs stay batched over all of them.
The combine sums each token's kept slots in expert order, a fixed order,
so a result does not depend on the device's atomics. The aux terms of a
grouped call are taken over all its tokens.

``moe_apply_sorted(int8_dispatch=True)`` is the reference's int8
dispatch payload: each token is quantized with its own scale
(``nn/module.py::quantize_absmax``) into an int8 ingest buffer, whose rows are dequantized to
the activation type before the expert GEMMs. The router reads the
unquantized tokens. As in the reference, the int8 cast cuts the
gradient of the expert input: a token's gradient through the experts
reaches it only through its scale's amax (split evenly between ties).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.nn.ffn import ACTS
from repro_torch.nn.module import (dense_init, quantize_absmax,
                                   truncated_normal_init)


class MoEOutput(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor
    router_z_loss: torch.Tensor
    fraction_dropped: torch.Tensor


def moe_init(gen, d_model: int, d_ff: int, n_experts: int, gated: bool = True,
             param_dtype=torch.float32, lead=(), device=None):
    scale = d_model ** -0.5
    shape = (*lead, n_experts)
    p = {
        "router": dense_init(gen, d_model, n_experts, param_dtype, lead=lead,
                             device=device),
        # stacked expert weights: leading E axis
        "wi": truncated_normal_init(gen, (*shape, d_model, d_ff), scale,
                                    param_dtype, device),
        "wd": truncated_normal_init(gen, (*shape, d_ff, d_model),
                                    d_ff ** -0.5, param_dtype, device),
    }
    if gated:
        p["wg"] = truncated_normal_init(gen, (*shape, d_model, d_ff), scale,
                                        param_dtype, device)
    return p


def capacity(top_k: int, T: int, capacity_factor: float, E: int) -> int:
    """Slots per expert for a dispatch of T tokens (the reference's
    integer arithmetic)."""
    return int(max(1, -(-top_k * T * capacity_factor // E)))


def _route(params, xt: torch.Tensor, top_k: int, renorm_gates: bool):
    """Float32 router logits of the low-precision operands (the
    reference's ``preferred_element_type=float32``), softmax, and the
    top-k gates and experts, ties toward the lower index."""
    w = params["router"]["kernel"].to(xt.dtype).float()
    logits = torch.matmul(xt.float(), w)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = vals[:, :top_k], idx[:, :top_k]
    if renorm_gates:
        gate = gate / (torch.sum(gate, -1, keepdim=True) + 1e-9)
    return logits, probs, gate, expert


def _expert_ffn(params, xin: torch.Tensor, act: str) -> torch.Tensor:
    """Every expert's FFN on its (E, N, d) buffer: batched GEMMs, each
    rounded once to the activation type."""
    dt = xin.dtype
    h = torch.bmm(xin, params["wi"].to(dt))
    if "wg" in params:
        h = ACTS[act](torch.bmm(xin, params["wg"].to(dt))) * h
    else:
        h = ACTS[act](h)
    return torch.bmm(h, params["wd"].to(dt))


def _grouped(x: torch.Tensor, groups: str) -> torch.Tensor:
    """(B, S, d) as (G, T, d) dispatch groups."""
    if groups == "all":
        return x.reshape(1, -1, x.shape[-1])
    if groups == "row":
        return x
    if groups == "position":
        return x.transpose(0, 1)
    raise ValueError(f"groups={groups!r}: one of 'all', 'row', 'position'")


def _ungrouped(y: torch.Tensor, shape, groups: str) -> torch.Tensor:
    if groups == "position":
        y = y.transpose(0, 1)
    return y.reshape(shape)


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(idx, minlength=n)`` for indices below n, without the
    host sync CUDA's bincount makes to size its output."""
    return torch.zeros(n, dtype=torch.long, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def _dispatch(params, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float, act: str, renorm_gates: bool,
              groups: str, slot_major: bool, int8_dispatch: bool = False,
              experts: slice = slice(None), aux_share: float = 1.0
              ) -> MoEOutput:
    """The dispatch both entry points share. ``experts``: the experts
    whose stacks ``params`` holds (all by default; a device's block under
    expert parallelism, whose output is then that block's share of the
    combine); ``aux_share`` scales the aux terms the same way (each of n
    devices reporting 1/n of them)."""
    xg = _grouped(x, groups)
    G, T, d = xg.shape
    E, k = n_experts, top_k
    dev, dt = x.device, x.dtype
    xt = xg.reshape(G * T, d)
    logits, probs, gate, expert = _route(params, xt, k, renorm_gates)
    C = capacity(k, T, capacity_factor, E)

    # queue order of each group's k·T slots, and each slot's token row
    e = expert.reshape(G, T, k)
    tok = torch.arange(G * T, device=dev).reshape(G, T, 1).expand(G, T, k)
    if slot_major:
        e, tok = e.transpose(1, 2), tok.transpose(1, 2)
    key = (e.reshape(G, k * T)
           + E * torch.arange(G, device=dev)[:, None]).reshape(-1)
    tok = tok.reshape(-1)
    # position in the (group, expert) queue: rank in a stable sort by key
    # less the queue's first rank
    _, perm = torch.sort(key, stable=True)
    rank = torch.empty_like(perm)
    rank[perm] = torch.arange(perm.numel(), device=dev)
    queue = _counts(key, G * E)
    pos = rank - (torch.cumsum(queue, 0) - queue)[key]
    keep = pos < C
    dest = torch.where(keep, key * C + pos, G * E * C)

    # ingest: the token row of each (group, expert, slot); G·T is a zero
    # row, and every dropped slot writes the overflow entry, never read
    src = torch.full((G * E * C + 1,), G * T, dtype=torch.long, device=dev)
    src[dest] = tok
    # the slots of ``experts`` (E_l of them from ``lo``) only
    ex = range(E)[experts]
    lo, E_l = ex.start, len(ex)
    rows = src[:-1].reshape(G, E, C)[:, experts].reshape(-1)
    if int8_dispatch:
        xq, scale = quantize_absmax(xt)
        qpad = torch.cat([xq, xq.new_zeros(1, d)])
        spad = torch.cat([scale, scale.new_zeros(1, 1)])
        xin = (qpad[rows].float() * spad[rows]).to(dt)
    else:
        xin = torch.cat([xt, xt.new_zeros(1, d)])[rows]
    xin = xin.reshape(G, E_l, C, d).transpose(0, 1)
    yout = _expert_ffn(params, xin.reshape(E_l, G * C, d), act)
    yflat = yout.reshape(E_l, G, C, d).transpose(0, 1).reshape(
        G * E_l * C, d)
    ypad = torch.cat([yflat, yflat.new_zeros(1, d)])
    if E_l != E:   # another device's expert's slot reads the zero row
        e = dest // C % E
        mine = keep & (e >= lo) & (e < lo + E_l)
        dest = torch.where(mine, (dest // (E * C) * E_l + e - lo) * C
                           + dest % C, G * E_l * C)

    # combine: each token's k slots, summed in float32 in expert order
    slot_dest = dest.reshape(G, k, T).transpose(1, 2) if slot_major \
        else dest.reshape(G, T, k)
    slot_dest = slot_dest.reshape(G * T, k)
    by_expert = torch.argsort(expert, dim=-1)
    slot_dest = torch.gather(slot_dest, 1, by_expert)
    w = torch.gather(gate, 1, by_expert)
    if slot_major:
        w = w.to(dt).float()
    ys = ypad[slot_dest]
    y = torch.zeros((G * T, d), dtype=torch.float32, device=dev)
    for j in range(k):
        y = y + ys[:, j].float() * w[:, j, None]
    y = _ungrouped(y.reshape(G, T, d), x.shape, groups)
    if experts == slice(None):
        y = y.to(dt)
    counts = _counts(expert.reshape(-1), E)
    n_tok = G * T
    me = torch.mean(probs, dim=0)
    if slot_major:
        # Switch aux load-balance loss: E * sum_e f_e * p_e
        aux = n_experts * torch.sum(me * (counts.float() / n_tok)) / top_k
    else:
        # Switch aux loss: E * sum_e (tokens routed fraction) * (mean prob)
        aux = n_experts * torch.sum(counts.float() / (n_tok * top_k) * me)
    dropped = 1.0 - torch.sum(keep.float()) / (n_tok * top_k)
    return MoEOutput(y=y, aux_loss=aux * aux_share,
                     router_z_loss=_z_loss(logits) * aux_share,
                     fraction_dropped=dropped)


def _dispatch_sharded(params, x: torch.Tensor, **kw) -> MoEOutput:
    """``_dispatch`` under expert parallelism (the expert stacks are
    DTensors, E over the EP axis, under ``set_ep_axis("data")`` f over
    ``"model"`` too). Every device routes the whole batch, replicated
    over every axis (x gathered over the batch axes: the dispatch's
    queues and capacities are the global batch's, as the reference's),
    and runs its own experts' GEMMs on its own f block; the combine is a
    partial sum over the axes that shard the stacks, reduced back into
    x's placements. The aux terms come out of every device as a 1/n
    share of that sum, so their gradients are not counted n times. The
    router's sort and the queues' scatters run on local tensors, as no
    DTensor rule covers them. Correct before fast: an all-to-all dispatch
    of each device's own tokens is later work (ROADMAP.md)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    wi = params["wi"]
    mesh = wi.device_mesh
    ep = [i for i, p in enumerate(wi.placements) if p == Shard(0)]
    split = [i for i, p in enumerate(wi.placements) if isinstance(p, Shard)]
    share = 1
    for i in split:
        share *= mesh.size(i)
    rep = tuple(Replicate() for _ in wi.placements)
    part = tuple(Partial() if i in split else Replicate()
                 for i in range(len(wi.placements)))
    stacks = sorted(k for k in params if k != "router")
    E = kw["n_experts"]

    def local(x, router, *leaves):
        i, n = 0, 1
        for m in ep:
            i = i * mesh.size(m) + mesh.get_local_rank(m)
            n *= mesh.size(m)
        p = {"router": {"kernel": router}, **dict(zip(stacks, leaves))}
        out = _dispatch(p, x, experts=slice(i * E // n, (i + 1) * E // n),
                        aux_share=1.0 / share, **kw)
        return out.y, out.aux_loss, out.router_z_loss, out.fraction_dropped

    leaves = [params[k] for k in stacks]
    y, aux, z, dropped = shd.on_local_shards(
        local, (part, part, part, rep),
        (rep, rep) + tuple(l.placements for l in leaves), mesh,
        in_grad_placements=(part, part) + tuple(l.placements
                                                for l in leaves),
    )(x, params["router"]["kernel"], *leaves)
    back = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return MoEOutput(y=y.redistribute(placements=back).to(x.dtype),
                     aux_loss=aux, router_z_loss=z,
                     fraction_dropped=dropped)


def _z_loss(logits: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))


def _apply(params, x, **kw) -> MoEOutput:
    if shd.is_dtensor(params["wi"]):
        return _dispatch_sharded(params, x, **kw)
    return _dispatch(params, x, **kw)


def moe_apply(params, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, act: str = "silu",
              renorm_gates: bool = True, groups: str = "all") -> MoEOutput:
    """x: (B, S, d) -> MoEOutput with y: (B, S, d); slot-major queues
    (the reference's einsum dispatch)."""
    return _apply(params, x, n_experts=n_experts, top_k=top_k,
                  capacity_factor=capacity_factor, act=act,
                  renorm_gates=renorm_gates, groups=groups, slot_major=True)


def moe_apply_sorted(params, x: torch.Tensor, *, n_experts: int, top_k: int,
                     capacity_factor: float = 1.25, act: str = "silu",
                     renorm_gates: bool = True, int8_dispatch: bool = False,
                     groups: str = "all") -> MoEOutput:
    """Sort-based dispatch, token-major queues: a stable sort of the
    slots by expert, gather into (E, C, d) buffers, batched GEMMs,
    combine. ``int8_dispatch``: the buffers are gathered from int8
    tokens with per-token scales and dequantized (module docstring)."""
    return _apply(params, x, n_experts=n_experts, top_k=top_k,
                  capacity_factor=capacity_factor, act=act,
                  renorm_gates=renorm_gates, groups=groups, slot_major=False,
                  int8_dispatch=int8_dispatch)


def moe_apply_reference(params, x: torch.Tensor, *, n_experts: int,
                        top_k: int, act: str = "silu",
                        renorm_gates: bool = True) -> torch.Tensor:
    """Loop-over-experts oracle with infinite capacity (for tests)."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    _, _, gate, expert = _route(params, xt, top_k, renorm_gates)
    y = torch.zeros(xt.shape, dtype=torch.float32, device=x.device)
    for e in range(n_experts):
        h = xt @ params["wi"][e].to(xt.dtype)
        if "wg" in params:
            h = ACTS[act](xt @ params["wg"][e].to(xt.dtype)) * h
        else:
            h = ACTS[act](h)
        he = (h @ params["wd"][e].to(xt.dtype)).float()
        w_e = torch.sum(torch.where(expert == e, gate, 0.0), dim=-1)
        y = y + w_e[:, None] * he
    return y.to(x.dtype).reshape(B, S, d)
