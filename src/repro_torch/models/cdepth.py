"""Continuous-depth mode for the LM — the port of ``repro/models/cdepth.py``.

A pre-norm residual stack is read as the Euler discretization of a depth
ODE with piecewise-constant parameters theta(s) (paper Eq. 1):

    f(s, h) = n_groups * (group_apply(theta(floor(s * n_groups)), h) - h)

Euler with K = n_groups steps reproduces the discrete network; K <
n_groups trades NFE for accuracy, and a HyperEuler correction g_omega
recovers part of the loss. Group selection follows the reference's
float32 arithmetic exactly: a group index off by one at a mesh point
changes the answer entirely.

Expert routing is not row independent, so the field keeps the
reference's call structure for ``moe`` blocks: a scalar depth routes the
whole batch's tokens in one dispatch; a per-sample ``(B,)`` depth (the
reference's ``vmap`` over samples) gives every row a dispatch of its own,
even when every row maps to the same group.

A ``frontend`` (PaliGemma's patch embeddings) is projected and prepended
to the token embeddings as ``lm_forward`` does. Learned positions are
left out of the depth path's initial state, as the reference leaves
them out (its ``_embed`` adds none): for a ``pos == "learned"`` config
``lm_forward_cdepth`` at K = n_groups is not ``lm_forward``.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.integrate import Integrator, SolveStats
from repro_torch.core.residual import combined_loss
from repro_torch.core.solvers import FixedGrid
from repro_torch.core.tableaus import get as get_tableau
from repro_torch.models.lm import (_readout, block_apply, dtype_of,
                                   embed_inputs, group_layout, group_params)
from repro_torch.nn.module import truncated_normal_init


def _group_apply(params, cfg: ArchConfig, gp, h, per_row: bool = False):
    """One group of blocks over h; its aux tree (the ``moe`` blocks') is
    carried through and dropped, as the reference's."""
    pattern, _, _ = group_layout(cfg)
    aux = None
    for i, kind in enumerate(pattern):
        h, aux = block_apply(gp[f"b{i}"], cfg, kind, h, aux,
                             per_row=per_row)
    return h


def _group_index(s, n_groups: int) -> torch.Tensor:
    """clip(floor(s * n_groups), 0, n_groups - 1) as the reference rounds
    it: a tensor ``s`` multiplies in float32; a Python ``s`` multiplies in
    double and rounds to float32 (a weakly typed JAX scalar)."""
    v = torch.as_tensor(s * n_groups, dtype=torch.float32)
    return torch.clamp(torch.floor(v).to(torch.int32), 0, n_groups - 1)


def depth_field(params, cfg: ArchConfig):
    """VectorField f(s, h) over the residual stream (full sequence).

    ``s`` may be a scalar or a per-sample ``(B,)`` row (multi-rate solves):
    samples at different depths use different groups in the same step.
    The batch is split by group index — each distinct group runs once on
    its rows and the results scatter back — instead of gathering B copies
    of a group's weights. Under a ``(B,)`` row each ``moe`` block routes
    every row alone (``block_apply``'s ``per_row``); the other kinds are
    row independent, so the split leaves them as they were."""
    _, n_groups, _ = group_layout(cfg)

    def run(g: int, h, per_row: bool = False):
        h_out = _group_apply(params, cfg, group_params(params, g), h,
                             per_row)
        return (n_groups * (h_out - h)).to(h.dtype)

    def f(s, h):
        idx = _group_index(s, n_groups)
        if idx.ndim == 0:
            return run(int(idx), h)
        rows = idx.reshape(-1).tolist()
        groups = sorted(set(rows))
        if len(groups) == 1:
            return run(groups[0], h, per_row=True)
        out = torch.empty_like(h)
        for g in groups:
            sel = torch.tensor([i for i, r in enumerate(rows) if r == g],
                               device=h.device)
            out[sel] = run(g, h[sel], per_row=True)
        return out

    return f


def discrete_depth_trajectory(params, cfg: ArchConfig, tokens: torch.Tensor,
                              frontend: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Residual-stream states at every group boundary, the 'exact'
    solution checkpoints for hypersolver fitting (paper Sec. 3.2; ground
    truth here is the deployed full-depth network itself). Not an
    Integrator solve: the group outputs are emitted bit for bit.
    Returns (n_groups+1, B, S, d), S counting a ``frontend``'s rows."""
    _, n_groups, _ = group_layout(cfg)
    h = embed_inputs(params, cfg, tokens, frontend)
    traj = [h]
    for g in range(n_groups):
        h = _group_apply(params, cfg, group_params(params, g), h)
        traj.append(h)
    return torch.stack(traj)


def cdepth_residual_loss(params, g_params, cfg: ArchConfig,
                         tokens: torch.Tensor, K: int,
                         base_solver: str = "euler") -> torch.Tensor:
    """Residual-fitting loss for the LM hypersolver at mesh length K:
    ground truth is the full-depth discrete trajectory subsampled at the
    K-mesh (requires n_groups % K == 0)."""
    _, n_groups, _ = group_layout(cfg)
    if n_groups % K:
        raise ValueError(f"n_groups={n_groups} is not a multiple of K={K}")
    traj = discrete_depth_trajectory(params, cfg, tokens)[::n_groups // K]
    integ = Integrator(
        tableau=get_tableau(base_solver),
        g=lambda eps, s, z, dz: lm_g_apply(g_params, eps, s, None, z, dz))
    return combined_loss(integ, depth_field(params, cfg), traj,
                         FixedGrid.over(0.0, 1.0, K), residual_weight=1.0)


# --------------------------------------------------- g_omega for the LM ----

def lm_g_init(gen, cfg: ArchConfig, rank: int = 64, n_fourier: int = 8,
              param_dtype=None, device=None):
    pd = param_dtype or dtype_of(cfg.param_dtype)
    d = cfg.d_model
    return {
        "w_h": truncated_normal_init(gen, (d, rank), d ** -0.5, pd, device),
        "w_dh": truncated_normal_init(gen, (d, rank), d ** -0.5, pd, device),
        "w_s": truncated_normal_init(gen, (2 * n_fourier + 1, rank), 0.3, pd,
                                     device),
        # zero-init readout: correction starts at exactly 0 (pure base solver)
        "w_out": torch.zeros((rank, d), dtype=pd, device=device),
    }


def _fourier(s, n: int, dtype, device=None) -> torch.Tensor:
    """Fourier depth features of a scalar or per-sample ``(B,)`` depth."""
    s = torch.as_tensor(s, dtype=torch.float32, device=device)
    ks = torch.arange(1, n + 1, dtype=torch.float32, device=s.device)
    ang = 2 * math.pi * ks * s[..., None]               # (..., n)
    feats = torch.cat([torch.sin(ang), torch.cos(ang), s[..., None]], dim=-1)
    return feats.reshape(tuple(s.shape) + (2 * n + 1,)).to(dtype)


def lm_g_apply(gp, eps, s, x, h, dh):
    """Correction net: rank-r MLP over (h, dh, s)."""
    del eps, x
    nf = (gp["w_s"].shape[0] - 1) // 2  # w_s: (2*n_fourier + 1, rank)
    fs = _fourier(s, nf, h.dtype, device=h.device)
    w_s = gp["w_s"].to(h.dtype)
    if fs.ndim > 1:
        # batched depth row: the (B, 2F+1) @ (2F+1, r) product summed
        # feature by feature, so every row sums in one order whatever the
        # batch (a matmul picks its order by the batch, a gemv at one
        # row) and a slot pool split over a mesh serves what it serves
        # whole; then (B, r) -> (B, 1..., r) against h's token axes
        sf = fs[..., :1] * w_s[0]
        for j in range(1, w_s.shape[0]):
            sf = sf + fs[..., j:j + 1] * w_s[j]
        sf = sf.reshape(tuple(sf.shape[:-1]) + (1,) * (h.ndim - sf.ndim)
                        + tuple(sf.shape[-1:]))
    else:
        sf = fs @ w_s
    pre = (h @ gp["w_h"].to(h.dtype)
           + dh.to(h.dtype) @ gp["w_dh"].to(h.dtype) + sf)
    return (torch.tanh(pre) @ gp["w_out"].to(h.dtype)).to(h.dtype)


# ----------------------------------------------- flow head for the LM ----

def lm_flow_init(gen, cfg: ArchConfig, rank: int = 64, n_fourier: int = 8,
                 param_dtype=None, device=None):
    """Flow-net params for the K=0 tier (core/flowhead.py): the same
    rank-r net as g_omega, its zero-initialised readout making the flow
    exactly one full-span Euler step."""
    return lm_g_init(gen, cfg, rank=rank, n_fourier=n_fourier,
                     param_dtype=param_dtype, device=device)


def lm_flow_apply(fp, eps, s, z, dz, order: int = 1):
    """LM solution operator F(z(s)) -> z(s+eps): ``make_flow_apply``
    over the ``lm_g_apply`` net (DepthModel.flow_apply signature)."""
    from repro_torch.core.flowhead import flow_combine

    return flow_combine(eps, z, dz, lm_g_apply(fp, eps, s, None, z, dz),
                        order=order)


# ----------------------------------------------------------- inference ----

def bind_lm_g(g_params):
    """Close LM g_omega over its params to the core Correction signature."""
    return lambda eps, s, z, dz: lm_g_apply(g_params, eps, s, None, z, dz)


def lm_integrator(solver: str = "euler", g_params: Any = None,
                  fused: bool = False) -> Integrator:
    """The serving Integrator for the LM depth ODE; a ``hyper_`` prefix
    pairs the base tableau with the correction, which then must be given."""
    if solver.startswith("hyper_"):
        if g_params is None:
            raise ValueError(
                f"solver {solver!r} needs a trained correction: pass "
                "g_params (serve CLI: --g-ckpt)")
        base = solver[len("hyper_"):]
    else:
        base = solver
    g = bind_lm_g(g_params) if g_params is not None else None
    return Integrator(tableau=get_tableau(base), g=g, fused=fused)


def apply_tail(params, cfg: ArchConfig, h):
    """The discrete tail layers + readout shared by every LM serving path."""
    pattern, _, tail = group_layout(cfg)
    for i in range(tail):
        h, _ = block_apply(params["tail"][f"t{i}"], cfg, pattern[i], h)
    return _readout(params, cfg, h)


def lm_forward_cdepth(params, cfg: ArchConfig, tokens: torch.Tensor, K: int,
                      solver: str = "euler", g_params: Any = None,
                      frontend: Optional[torch.Tensor] = None,
                      with_stats: bool = False, fused: bool = False):
    """Full-sequence scoring with a K-step (hyper)solved depth integration.
    K == n_groups with solver='euler' and no g reproduces ``lm_forward``
    (but for learned positions, module docstring). ``fused`` takes the
    solver's fused step (``kernels/hyper_step`` on the card), the
    serving engine's; the reference's function has no such option."""
    h = embed_inputs(params, cfg, tokens, frontend)
    f = depth_field(params, cfg)
    integ = lm_integrator(solver, g_params, fused=fused)
    h = integ.solve(f, h, FixedGrid.over(0.0, 1.0, K), return_traj=False)
    logits = apply_tail(params, cfg, h)
    if not with_stats:
        return logits
    B, dev = tokens.shape[0], logits.device
    stats = SolveStats(
        nfe=torch.full((B,), integ.tableau.stages * K, dtype=torch.int32,
                       device=dev),
        K=torch.full((B,), K, dtype=torch.int32, device=dev),
        err_probe=torch.zeros((B,), dtype=torch.float32, device=dev),
        probe_nfe=0,
    )
    return logits, stats


def depth_probe(params, cfg: ArchConfig, tokens: torch.Tensor, controller,
                solver: str = "euler", g_params: Any = None,
                frontend: Optional[torch.Tensor] = None):
    """Cheap per-request error probe over the LM depth ODE: a ``Probe``
    (K, err, nfe, dz0) from one controller probe step."""
    h = embed_inputs(params, cfg, tokens, frontend)
    f = depth_field(params, cfg)
    integ = lm_integrator(solver, g_params)
    return controller.select(integ, f, h, (0.0, 1.0))
