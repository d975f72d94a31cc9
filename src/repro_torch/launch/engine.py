"""Multi-rate serving engine — the drain loop of ``repro/launch/engine.py``.

    submit(x) -> request queue
        -> probe: one cheap depth-field step per request picks a mesh
           length K (core/controllers.py); the probe's dz = f(s0, z0) is
           reused as stage 0 of the solve
        -> bucket snap: clamp K to the serving buckets (a packing policy)
        -> pack same-shape requests into batches sorted by K
        -> one masked multi-rate solve per batch
           (``Integrator.solve_multirate``): with ``fused`` every step's
           update is one launch of the CUDA kernel, for any K mix
        -> Completed{outputs, K, nfe, err_probe} per request

Deadlines, the bounded queue's shed/degrade/block policies, the retry
ladder for non-finite outputs and the fault injector's admission and
flow-eval hooks are kept. With ``EngineConfig.flow_threshold > 0`` a
model carrying a flow head (``DepthModel.flow_apply``) serves its
probe-easy requests on the K=0 tier (core/flowhead.py): one flow-head
eval over the probe's ``(z0, dz0)`` and a readout, zero solver steps; a
non-finite flow row escalates into the K-bucket ladder (status
``escalated``). A ``ResidualLedger`` (launch/refinery.py) passed as
``ledger=`` captures residual rows from each drain's probe states,
reading them only. ``hot_swap_g``/``hot_swap_flow`` replace the
correction's or the flow head's params between drains: the next call
reads them, nothing is rebuilt, and the old tensors are never written.

The discrete path, ``greedy_generate``, is the standard cached decode
(the CLI's default): a prefill, then one greedy token a step.

Where the reference jit-compiles one cell per (shape, k_max) and one
decode step, the port runs eagerly: a probe, a solve and a decode step
are plain calls on the model's device.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import flatten_sorted, treedef_str
from repro_torch.configs import ArchConfig
from repro_torch.core.controllers import (EmbeddedErrorController,
                                          FixedController,
                                          HypersolverResidualController,
                                          TierRouter)
from repro_torch.core.integrate import Integrator, OneTimeWarning
from repro_torch.models.cdepth import lm_flow_init, lm_g_init, lm_integrator
from repro_torch.models.lm import (dtype_of, init_lm_cache, lm_decode_step,
                                  lm_prefill, readout_weight)


# ----------------------------------------------------------- discrete path ----

def greedy_generate(params, cfg: ArchConfig, prompt, gen_len: int):
    """Standard cached decode on the device of ``params``; prompt: (B, P)
    int. Prefill is one full-sequence forward that fills the caches
    (models/lm.py::lm_prefill), then ``gen_len - 1`` greedy decode steps.
    The float32 readout matrix is built once for the whole generate, and
    tokens stay on the device between steps (no host sync per token).
    Returns (B, gen_len) int32 tokens on that device."""
    dev = params["embed"]["table"].device
    prompt = torch.as_tensor(prompt, device=dev)
    B, P = prompt.shape
    caches = init_lm_cache(cfg, B, P + gen_len, device=dev)
    w = readout_weight(params, cfg, dtype_of(cfg.dtype))
    logits, caches = lm_prefill(params, cfg, prompt, caches, readout_w=w)
    out = [logits.argmax(-1).to(torch.int32)]
    for t in range(P, P + gen_len - 1):
        logits, caches = lm_decode_step(params, cfg, out[-1], caches, t,
                                        readout_w=w)
        out.append(logits.argmax(-1).to(torch.int32))
    return torch.stack(out, dim=1)


# -------------------------------------------------------------- g loading ----

def _load_rank_r(path: str, init, cfg: ArchConfig, rank: int, device):
    cm = CheckpointManager(path)
    step = cm.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path!r}")
    template = init(torch.Generator().manual_seed(0), cfg, rank=rank,
                    param_dtype=torch.float32)
    return cm.restore(step, template, device=device)


def load_g_params(path: str, cfg: ArchConfig, rank: int = 32, device=None):
    """Restore a trained LM hypersolver correction from a checkpoint
    directory either package's CheckpointManager wrote (--g-ckpt)."""
    return _load_rank_r(path, lm_g_init, cfg, rank, device)


def load_flow_params(path: str, cfg: ArchConfig, rank: int = 64,
                     device=None):
    """Restore a trained LM flow head (core/flowhead.py) from a
    checkpoint directory (--flow-ckpt)."""
    return _load_rank_r(path, lm_flow_init, cfg, rank, device)


# ---------------------------------------------------------- model adapters ----

@dataclasses.dataclass(frozen=True)
class DepthModel:
    """What the engine needs to serve a continuous-depth model:
    ``embed(x)`` lifts a request batch to z0, ``field_of(x)`` closes the
    vector field over it, ``readout(x, zT)`` maps the terminal state to
    outputs, ``integ`` is the serving Integrator. A correction rides
    either in ``integ.g`` (closure) or as ``g_apply(gp, eps, s, z, dz)``
    plus ``g_params`` (parametric: the serving loops pass the params at
    call time, so ``hot_swap_g`` replaces them between calls).
    ``flow_apply(fp, eps, s, z, dz) -> z(s + eps)`` with ``flow_params``
    is the optional K=0 flow tier, swappable the same way."""

    embed: Callable[[Any], Any]
    field_of: Callable[[Any], Callable]
    readout: Callable[[Any, Any], Any]
    integ: Integrator
    span: Tuple[float, float] = (0.0, 1.0)
    g_apply: Optional[Callable] = None   # g_apply(gp, eps, s, z, dz)
    g_params: Any = None
    flow_apply: Optional[Callable] = None  # flow_apply(fp, eps, s, z, dz)
    flow_params: Any = None


def bound_integrator(model: DepthModel, gp=None) -> Integrator:
    """``model.integ`` with the parametric correction bound over ``gp``
    (defaulting to the model's own params)."""
    if model.g_apply is None:
        return model.integ
    ga = model.g_apply
    if gp is None:
        gp = model.g_params
    return dataclasses.replace(
        model.integ, g=lambda e, s, z, dz: ga(gp, e, s, z, dz))


def validate_g_swap(current, new, label: str = "hot_swap_g") -> None:
    """Refuse a swap whose params do not match the resident ones leaf for
    leaf (tree structure, shapes, dtypes) — the reference's no-retrace
    contract, kept so a swapped tree always fits every call that took
    the old one. Shared by both loops' ``hot_swap_g`` and
    ``hot_swap_flow`` (``label`` names the caller)."""
    t_cur, d_cur = flatten_sorted(current)[0], treedef_str(current)
    t_new, d_new = flatten_sorted(new)[0], treedef_str(new)
    if d_cur != d_new:
        raise ValueError(
            f"{label}: params treedef mismatch ({d_new} vs resident "
            f"{d_cur}) — a swap must preserve the tree structure")
    for i, (c, n) in enumerate(zip(t_cur, t_new)):
        c, n = torch.as_tensor(c), torch.as_tensor(n)
        if tuple(c.shape) != tuple(n.shape) or c.dtype != n.dtype:
            raise ValueError(
                f"{label}: leaf {i} is {tuple(n.shape)}/{n.dtype}, "
                f"resident is {tuple(c.shape)}/{c.dtype} — shapes and "
                "dtypes must match exactly")


def swap_params(current, new, label: str):
    """``new`` validated against ``current`` and placed leaf by leaf on
    the resident leaves' devices: a new tree, the old one untouched."""
    validate_g_swap(current, new, label)
    t_cur = flatten_sorted(current)[0]
    t_new, build = flatten_sorted(new)
    return build([torch.as_tensor(n, device=torch.as_tensor(c).device)
                  for c, n in zip(t_cur, t_new)])


def lm_depth_model(params, cfg: ArchConfig, solver: str = "euler",
                   g_params: Any = None, fused: bool = False, *,
                   refinable: bool = False, rank: int = 32,
                   flow_params: Any = None, device=None) -> DepthModel:
    """The LM's depth ODE (models/cdepth.py) as a servable model. Requests
    are token rows (numpy or tensors); ``device`` is where they are moved
    (default: the device of the weights). ``refinable=True`` carries the
    correction on the parametric path (a zero-readout init when no
    ``g_params`` is given). ``flow_params`` (an ``lm_flow_init``-shaped
    tree, e.g. from ``load_flow_params``) attaches the K=0 flow tier."""
    from repro_torch.models.cdepth import (apply_tail, depth_field,
                                           lm_flow_apply, lm_g_apply)
    from repro_torch.models.lm import _embed

    dev = params["embed"]["table"].device if device is None else device
    f = depth_field(params, cfg)
    kw = {}
    if refinable:
        base = solver[len("hyper_"):] if solver.startswith("hyper_") \
            else solver
        if g_params is None:
            g_params = lm_g_init(torch.Generator(device=dev).manual_seed(0),
                                 cfg, rank=rank, param_dtype=torch.float32,
                                 device=dev)
        integ = lm_integrator(base, None, fused=fused)
        kw = dict(
            g_apply=lambda gp, eps, s, z, dz:
                lm_g_apply(gp, eps, s, None, z, dz),
            g_params=g_params)
    else:
        integ = lm_integrator(solver, g_params, fused=fused)
    if flow_params is not None:
        order = integ.order
        kw.update(
            flow_apply=lambda fp, eps, s, z, dz:
                lm_flow_apply(fp, eps, s, z, dz, order=order),
            flow_params=flow_params)
    return DepthModel(
        embed=lambda toks: _embed(params, cfg, torch.as_tensor(toks,
                                                               device=dev)),
        field_of=lambda toks: f,
        readout=lambda toks, h: apply_tail(params, cfg, h),
        integ=integ,
        **kw,
    )


def node_depth_model(node, params, solver: str = "euler",
                     g_apply: Any = None, g_params: Any = None,
                     fused: bool = False) -> DepthModel:
    """Any ``NeuralODE`` (core/neural_ode.py) as a servable model — e.g.
    the paper's image classifiers (models/conv_node.py). ``solver`` may
    carry a ``hyper_`` prefix (requires g_apply/g_params). ``g_apply`` gets
    x=None: conditioning-dependent corrections need a custom adapter.
    Requests (numpy rows) are moved to the device of the params.

    The engine solves at a per-sample ``(B,)`` depth, so the node's field
    and g must lift ``s`` with ``core/integrate.py::depth_like``; the
    conv fields of models/conv_node.py, like the reference's, take a
    scalar depth only and raise there."""
    from repro_torch.core.train import make_integrator

    if solver.startswith("hyper_"):
        if g_apply is None:
            raise ValueError(
                f"solver {solver!r} needs a correction: pass g_apply/"
                "g_params (a hyper solver silently downgraded to its base "
                "would misreport benchmark numbers)")
        base = solver[len("hyper_"):]
    else:
        base = solver
    dev = pytree.tree_leaves(params)[0].device

    def lift(x):
        return torch.as_tensor(x, device=dev)

    return DepthModel(
        embed=lambda x: node.hx_apply(params, lift(x)),
        field_of=lambda x: node.field(params, lift(x)),
        readout=lambda x, zT: node.hy_apply(params, zT),
        integ=make_integrator(base, g_apply, g_params, None, fused=fused),
        span=tuple(node.s_span),
    )


# ------------------------------------------------------------ bucket policy ----

_snap_overflow = OneTimeWarning()
_probe_nonfinite = OneTimeWarning()


def reset_snap_overflow_warning() -> None:
    """Re-arm the one-time bucket-overflow RuntimeWarning (test isolation)."""
    _snap_overflow.reset()


def reset_probe_nonfinite_warning() -> None:
    """Re-arm the one-time non-finite-probe RuntimeWarning (test
    isolation)."""
    _probe_nonfinite.reset()


def screen_probe_errors(errs: np.ndarray) -> int:
    """Count non-finite probe errors in a host error row and warn once
    (``mesh_for_tolerance`` already routes such requests to ``k_max``)."""
    n_bad = int((~np.isfinite(np.asarray(errs))).sum())
    if n_bad:
        _probe_nonfinite.warn(
            f"non-finite probe error for {n_bad} request(s): the probe "
            "step itself blew up, so the controller assigned k_max (the "
            "finest mesh). The solve is likely to diverge too.",
            stacklevel=3)
    return n_bad


def next_bucket_above(K: int, buckets: Sequence[int]) -> Optional[int]:
    """The finest configured bucket strictly greater than ``K`` — the
    retry ladder's escalation rule. None when ``K`` is the top bucket."""
    for b in sorted(buckets):
        if b > K:
            return int(b)
    return None


def snap_to_buckets(Ks: np.ndarray, buckets: Sequence[int]) -> np.ndarray:
    """Smallest configured bucket >= K (the largest bucket when K
    overshoots, with a one-time warning: that clamp integrates COARSER
    than asked)."""
    buckets = np.asarray(sorted(buckets), np.int32)
    Ks = np.asarray(Ks, np.int32)
    if Ks.size and int(Ks.max()) > int(buckets[-1]):
        _snap_overflow.warn(
            f"snap_to_buckets: probed K={int(Ks.max())} exceeds the "
            f"largest configured bucket {int(buckets[-1])}; clamping down "
            "to it. The request will integrate more coarsely than its "
            "controller asked for.", stacklevel=3)
    idx = np.searchsorted(buckets, Ks, side="left")
    return buckets[np.minimum(idx, len(buckets) - 1)]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Batching/eps policy knobs for the multi-rate engine."""

    buckets: Tuple[int, ...] = (2, 4, 8, 16)
    tol: float = 1e-2             # target local-error tolerance for probes
    max_batch: int = 8            # max requests packed into one bucket batch
    solver: str = "euler"         # base tableau; "hyper_*" pairs it with g
    controller: str = "auto"      # auto | residual | embedded | fixed
    fixed_K: int = 0              # mesh length when controller == "fixed"
    fused: bool = False           # route batch solves through the kernel
    flow_threshold: float = 0.0   # K=0 flow tier confidence fraction:
    #                               route iff probe err <= this * tol
    #                               (0 disables the tier)

    def __post_init__(self):
        if self.buckets != tuple(sorted(self.buckets)):
            raise ValueError(f"buckets must be sorted, got {self.buckets}")
        if not (0.0 <= self.flow_threshold <= 1.0):
            raise ValueError(
                f"flow_threshold={self.flow_threshold}: expected a "
                "confidence fraction in [0, 1] (core/controllers.py::"
                "TierRouter) — the flow tier only serves requests whose "
                "probe error is confidently below tol")


def prepare_model(model: DepthModel, ecfg: EngineConfig) -> DepthModel:
    """Promote the integrator onto the fused kernel path when the config
    asks for it, and refuse a hyper_* solver with no correction."""
    if ecfg.fused and not model.integ.fused:
        model = dataclasses.replace(
            model, integ=dataclasses.replace(model.integ, fused=True))
    if model.g_apply is not None and model.integ.g is not None:
        raise ValueError(
            "DepthModel carries BOTH a closure correction (integ.g) and "
            "a parametric one (g_apply); pick one")
    if ecfg.solver.startswith("hyper_") and model.integ.g is None \
            and model.g_apply is None:
        raise ValueError(
            f"solver {ecfg.solver!r} needs a correction: build the "
            "DepthModel with g_params (serve CLI: --g-ckpt)")
    if ecfg.flow_threshold > 0:
        if model.flow_apply is None:
            raise ValueError(
                f"flow_threshold={ecfg.flow_threshold} routes easy "
                "requests to the K=0 flow tier, but the DepthModel "
                "carries no flow head: build it with flow_apply/"
                "flow_params (serve CLI: --flow-ckpt)")
        if ecfg.controller == "fixed":
            raise ValueError(
                "flow_threshold > 0 needs a probing controller — the "
                "flow tier routes off the admission probe's difficulty "
                "estimate, which controller='fixed' never computes")
    return model


def make_controller(integ: Integrator, ecfg: EngineConfig):
    """Controller selection from the engine config."""
    kind = ecfg.controller
    if kind == "auto":
        kind = "residual" if integ.g is not None else "embedded"
    k_min, k_max = min(ecfg.buckets), max(ecfg.buckets)
    if kind == "fixed":
        K = ecfg.fixed_K or k_max
        if K > k_max:
            raise ValueError(f"fixed_K={K} exceeds the largest bucket "
                             f"{k_max}; snap_to_buckets never snaps down")
        return FixedController(K=K)
    if kind == "residual":
        return HypersolverResidualController(
            tol=ecfg.tol, k_min=k_min, k_max=k_max)
    if kind == "embedded":
        return EmbeddedErrorController(
            tol=ecfg.tol, k_min=k_min, k_max=k_max)
    raise ValueError(f"unknown controller {kind!r}")


def probe_net_nfe(controller) -> int:
    """Per-request probe cost net of the reused first stage."""
    raw = getattr(controller, "probe_nfe", 0)
    return max(raw - 1, 0) if raw else 0


@dataclasses.dataclass(frozen=True)
class StepReport:
    """Virtual-cost accounting for one engine drain, priced by the cost
    oracle (sequential vector-field evaluations by default)."""

    cost: float = 0.0                 # total sequential evals this drain
    probe_cost: float = 0.0           # sequential evals spent probing
    useful_steps: int = 0             # sum of per-sample K over served rows
    total_steps: int = 0              # sum of batch_rows * k_max over batches
    batches: int = 0
    probe_nonfinite: int = 0          # non-finite probe errors this drain
    finish_offset: Dict[int, float] = dataclasses.field(default_factory=dict)
    flow_served: int = 0              # requests completed on the K=0 tier
    escalated: int = 0                # flow failures requeued to the ladder

    @property
    def waste_steps(self) -> int:
        """Masked sample-steps: rows scanned past their own K_i."""
        return self.total_steps - self.useful_steps


# terminal request statuses (the reference's tuple): ok, retried (after
# a quarantine retry), diverged, deadline, shed, escalated (completed on
# the K-bucket ladder after its K=0 flow eval came back non-finite)
STATUSES = ("ok", "retried", "diverged", "deadline", "shed", "escalated")


class QueueFull(RuntimeError):
    """Bounded admission queue is full under overload_policy='block'."""


@dataclasses.dataclass(frozen=True)
class Request:
    uid: int
    x: np.ndarray                 # one request's input (no batch axis)
    deadline: Optional[float] = None  # replay-clock deadline (None = none)
    attempts: int = 0             # completed (failed) serve attempts so far
    K_floor: int = 0              # retry ladder: minimum bucket on re-probe
    escalated: bool = False       # a failed K=0 flow eval sent it here


@dataclasses.dataclass(frozen=True)
class Completed:
    uid: int
    outputs: Optional[np.ndarray]  # host readout of the terminal state
    K: int                        # bucket mesh length actually used
    nfe: int                      # per-request NFE, probe included
    err_probe: float              # controller's local-error estimate
    fused_kernel: bool            # CUDA fused update in play for the solve
    status: str = "ok"            # terminal status (STATUSES)


def take_rows(tree, sel: np.ndarray):
    """Rows ``sel`` of every leaf (a gather: a new tensor), or None."""
    if tree is None:
        return None
    return pytree.tree_map(
        lambda l: l[torch.as_tensor(sel, dtype=torch.long, device=l.device)],
        tree)


class MultiRateEngine:
    """Request-queue engine serving continuous-depth models at per-request
    rates (the reference's drain loop)."""

    def __init__(self, model: DepthModel, engine_cfg: EngineConfig,
                 oracle=None, *, queue_cap: Optional[int] = None,
                 overload_policy: str = "shed", retry=None,
                 fault_injector=None, ledger=None):
        from repro_torch.distributed.fault import RetryPolicy
        from repro_torch.launch.oracle import SequentialEvalOracle
        if overload_policy not in ("shed", "degrade", "block"):
            raise ValueError(f"unknown overload_policy {overload_policy!r} "
                             "(shed | degrade | block)")
        if queue_cap is not None and queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {queue_cap}")
        self.model = prepare_model(model, engine_cfg)
        self.ecfg = engine_cfg
        self.controller = make_controller(
            bound_integrator(self.model), self.ecfg)
        self.g_params = self.model.g_params \
            if self.model.g_apply is not None else None
        # the K=0 tier's swappable params and router; None when the tier
        # is off (flow_threshold == 0), and then no flow code runs
        self.flow_params = self.model.flow_params \
            if self.model.flow_apply is not None else None
        self.router = TierRouter(flow_threshold=engine_cfg.flow_threshold) \
            if engine_cfg.flow_threshold > 0 else None
        self.ledger = ledger   # optional ResidualLedger (launch/refinery)
        self.oracle = oracle or SequentialEvalOracle()
        self.queue_cap = queue_cap
        self.overload_policy = overload_policy
        self.retry = retry or RetryPolicy()
        self.fault_injector = fault_injector
        self._queue: deque = deque()
        self._uid = 0
        self._shed: List[Completed] = []
        self._nfe_extra: Dict[int, int] = {}   # failed attempts' NFE per uid
        self.last_report = StepReport()

    # ---------------------------------------------------------- policy ----
    @property
    def probe_nfe(self) -> int:
        """Probe cost per request, net of the reused first stage."""
        return probe_net_nfe(self.controller)

    def fused_in_play(self, z0=None) -> bool:
        return self.model.integ.fused_available(z=z0)

    def nfe_of(self, K: int) -> int:
        """Per-request NFE for a bucket-K solve, probe included."""
        return self.probe_nfe + self.model.integ.tableau.stages * K

    @property
    def nfe_flow(self) -> int:
        """Per-request NFE on the K=0 tier: the probe's raw field evals
        (the stage ``probe_nfe`` nets out is consumed by the flow
        combine's ``eps*dz`` term, so it is billed back), zero steps."""
        return self.probe_nfe + 1

    def _integ(self) -> Integrator:
        return bound_integrator(self.model, self.g_params)

    def _flow(self, xs, z0, dz0):
        """The K=0 tier: one flow-head eval over the probe's (z0, dz0)
        rows and a readout, with the params read at call time."""
        m = self.model
        return m.readout(xs, m.flow_apply(self.flow_params,
                                          m.span[1] - m.span[0], m.span[0],
                                          z0, dz0))

    # --------------------------------------------------------- hot swap ----
    def hot_swap_g(self, gp):
        """Install new correction params between drains; the next probe
        and solve read them. Returns the previous params (the refinery's
        rollback handle). Raises ValueError on a structural mismatch."""
        if self.model.g_apply is None:
            raise ValueError(
                "hot_swap_g on a non-parametric model: build the "
                "DepthModel with g_apply/g_params (params-are-inputs) "
                "to make the correction swappable")
        old, self.g_params = self.g_params, swap_params(self.g_params, gp,
                                                        "hot_swap_g")
        return old

    def hot_swap_flow(self, fp):
        """Install new flow-head params between drains — the flow twin of
        ``hot_swap_g``. Returns the previous params."""
        if self.model.flow_apply is None:
            raise ValueError(
                "hot_swap_flow on a model with no flow head: build the "
                "DepthModel with flow_apply/flow_params (core/flowhead."
                "py) to make the K=0 tier swappable")
        old, self.flow_params = self.flow_params, swap_params(
            self.flow_params, fp, "hot_swap_flow")
        return old

    def _probe(self, xs):
        m = self.model
        z0 = m.embed(xs)
        p = self.controller.select(self._integ(), m.field_of(xs), z0, m.span)
        return p.K, p.err, z0, p.dz0

    def probe(self, xs):
        """Probe a request batch without serving it: (raw per-sample K
        before bucket snapping, per-sample error estimate) as numpy."""
        Ks, errs, _, _ = self._probe(np.asarray(xs))
        return Ks.cpu().numpy(), errs.cpu().numpy()

    def _solve(self, xs, z0, dz0, Ks, k_max: int):
        m = self.model
        if z0 is None:
            z0 = m.embed(xs)
        zT = self._integ().solve_multirate(
            m.field_of(xs), z0, m.span, Ks, k_max, first_stage=dz0)
        return m.readout(xs, zT)

    # ----------------------------------------------------------- queue ----
    def can_submit(self) -> bool:
        return not (self.queue_cap is not None
                    and self.overload_policy == "block"
                    and len(self._queue) >= self.queue_cap)

    def submit(self, x, deadline: Optional[float] = None) -> int:
        """Queue a request; a full bounded queue sheds it (terminal
        ``status="shed"``) or raises ``QueueFull`` under ``block``."""
        if self.queue_cap is not None \
                and len(self._queue) >= self.queue_cap:
            if self.overload_policy == "block":
                raise QueueFull(
                    f"admission queue at cap {self.queue_cap} under "
                    "overload_policy='block'; poll can_submit() and "
                    "resubmit")
            if self.overload_policy == "shed":
                self._uid += 1
                self._shed.append(Completed(
                    uid=self._uid, outputs=None, K=0, nfe=0,
                    err_probe=0.0, fused_kernel=False, status="shed"))
                return self._uid
            # degrade: admit past the cap; the drain caps K one bucket down
        self._uid += 1
        self._queue.append(Request(uid=self._uid, x=np.asarray(x),
                                   deadline=deadline))
        return self._uid

    def __len__(self) -> int:
        return len(self._queue) + len(self._shed)

    # ------------------------------------------------------------ serve ----
    def step(self, now: float = 0.0) -> List[Completed]:
        """Drain the queue once: probe, bucket, pack, solve. Returns the
        completed requests; ``self.last_report`` carries this drain's
        virtual-cost accounting."""
        done: List[Completed] = list(self._shed)
        self._shed = []
        if not self._queue:
            self.last_report = StepReport(
                finish_offset={c.uid: 0.0 for c in done})
            return done
        stages = self.model.integ.tableau.stages
        cost = probe_cost = 0.0
        useful = total = batches = probe_nonfinite = 0
        flow_served = escalated = 0
        finish_offset: Dict[int, float] = {c.uid: 0.0 for c in done}
        degrade = (self.queue_cap is not None
                   and self.overload_policy == "degrade"
                   and len(self._queue) > self.queue_cap)
        pending: List[Request] = []
        while self._queue:
            r = self._queue.popleft()
            if r.deadline is not None and r.deadline < now:
                finish_offset[r.uid] = 0.0
                done.append(Completed(
                    uid=r.uid, outputs=None, K=0,
                    nfe=self._nfe_extra.pop(r.uid, 0), err_probe=0.0,
                    fused_kernel=False, status="deadline"))
                continue
            pending.append(r)
        if not pending:
            self.last_report = StepReport(finish_offset=finish_offset)
            return done
        by_shape: Dict[Tuple, List[Request]] = {}
        for r in pending:
            by_shape.setdefault(r.x.shape, []).append(r)

        for shape, reqs in by_shape.items():
            rows = [r.x for r in reqs]
            if self.fault_injector is not None:
                rows = [self.fault_injector.corrupt_admission(
                    r.uid, r.attempts, x) for r, x in zip(reqs, rows)]
            xs = np.stack(rows)
            if isinstance(self.controller, FixedController):
                Ks_raw = np.full((len(reqs),), self.controller.K, np.int32)
                errs = np.zeros((len(reqs),), np.float32)
                z0 = dz0 = None
            else:
                Ks_dev, err_dev, z0, dz0 = self._probe(xs)
                Ks_raw = Ks_dev.cpu().numpy()
                errs = err_dev.cpu().numpy()
                probe_nonfinite += screen_probe_errors(errs)
                p = self.oracle.probe_cost(
                    shape, len(reqs),
                    getattr(self.controller, "probe_nfe", 0))
                probe_cost += p
                cost += p
            Ks = snap_to_buckets(Ks_raw, self.ecfg.buckets)
            if degrade:
                b = np.asarray(sorted(self.ecfg.buckets), np.int32)
                Ks = b[np.maximum(np.searchsorted(b, Ks) - 1, 0)]
            floors = np.asarray([r.K_floor for r in reqs], np.int32)
            Ks = np.maximum(Ks, floors)

            if self.ledger is not None:
                # residual capture from the probe states at the eps each
                # request will integrate at (the fixed path embeds its own
                # copy); rows with a non-finite probe are left out. A read
                # only, never priced: completions stay bit for bit equal
                span = self.model.span
                z_cap = z0 if z0 is not None else self.model.embed(xs)
                self.ledger.capture(
                    xs, z_cap, np.full(len(reqs), span[0], np.float32),
                    ((span[1] - span[0])
                     / Ks.astype(np.float64)).astype(np.float32),
                    keep=np.isfinite(errs))

            z_like = z0 if z0 is not None else self.model.embed(xs[:1])
            fused = self.fused_in_play(z_like)

            # K=0 flow tier: probe-easy rows skip the ladder (a packing
            # decision like the buckets); with the router off this block
            # never runs and the drain is the flow-free one bit for bit
            flow_sel = np.zeros(len(reqs), bool)
            if self.router is not None and z0 is not None:
                flow_sel = self.router.flow_mask(errs, self.ecfg.tol, floors)
            fidx = np.flatnonzero(flow_sel)
            if len(fidx):
                f_out = self._flow(xs[fidx], take_rows(z0, fidx),
                                   take_rows(dz0, fidx)).cpu().numpy()
                cost += self.oracle.flow_cost(shape, len(fidx))
                for j, i in enumerate(fidx):
                    r = reqs[i]
                    row = f_out[j]
                    if self.fault_injector is not None:
                        row = self.fault_injector.corrupt_flow_eval(
                            r.uid, r.attempts, row)
                    if not np.isfinite(row).all():
                        # escalation: bill the flow attempt, requeue into
                        # the ladder at the coarsest bucket (K_floor > 0
                        # also bars flow on the next probe)
                        if self.retry.should_retry("diverged", r.attempts):
                            self._nfe_extra[r.uid] = (
                                self._nfe_extra.get(r.uid, 0)
                                + self.nfe_flow)
                            self._queue.append(dataclasses.replace(
                                r, attempts=r.attempts + 1,
                                K_floor=min(self.ecfg.buckets),
                                escalated=True))
                            escalated += 1
                            continue
                        finish_offset[r.uid] = cost
                        done.append(Completed(
                            uid=r.uid, outputs=row, K=0,
                            nfe=self.nfe_flow
                            + self._nfe_extra.pop(r.uid, 0),
                            err_probe=float(errs[i]),
                            fused_kernel=False, status="diverged"))
                        continue
                    # flow_mask bars K_floor > 0, so attempts == 0 here
                    finish_offset[r.uid] = cost
                    flow_served += 1
                    done.append(Completed(
                        uid=r.uid, outputs=row, K=0,
                        nfe=self.nfe_flow + self._nfe_extra.pop(r.uid, 0),
                        err_probe=float(errs[i]), fused_kernel=False,
                        status="ok"))

            order = np.argsort(Ks, kind="stable")
            order = order[~flow_sel[order]]
            for lo in range(0, len(order), self.ecfg.max_batch):
                sel = order[lo:lo + self.ecfg.max_batch]
                k_max = int(Ks[sel].max())
                outputs = self._solve(
                    xs[sel], take_rows(z0, sel), take_rows(dz0, sel),
                    Ks[sel], k_max).cpu().numpy()
                cost += self.oracle.solve_cost(shape, k_max, len(sel),
                                               stages)
                useful += int(Ks[sel].sum())
                total += len(sel) * k_max
                batches += 1
                finite = np.isfinite(
                    outputs.reshape(len(sel), -1)).all(axis=1)
                for j, i in enumerate(sel):
                    r, K = reqs[i], int(Ks[i])
                    if not finite[j]:
                        nxt = next_bucket_above(K, self.ecfg.buckets) or K
                        if self.retry.should_retry("diverged", r.attempts):
                            self._nfe_extra[r.uid] = (
                                self._nfe_extra.get(r.uid, 0)
                                + self.nfe_of(K))
                            self._queue.append(dataclasses.replace(
                                r, attempts=r.attempts + 1, K_floor=nxt))
                            continue     # served by the next drain
                        status = "diverged"
                    else:
                        status = "ok" if r.attempts == 0 else (
                            "escalated" if r.escalated else "retried")
                    finish_offset[r.uid] = cost
                    done.append(Completed(
                        uid=r.uid, outputs=outputs[j], K=K,
                        nfe=self.nfe_of(K) + self._nfe_extra.pop(r.uid, 0),
                        err_probe=float(errs[i]), fused_kernel=fused,
                        status=status))
        self.last_report = StepReport(
            cost=cost, probe_cost=probe_cost, useful_steps=useful,
            total_steps=total, batches=batches,
            probe_nonfinite=probe_nonfinite, finish_offset=finish_offset,
            flow_served=flow_served, escalated=escalated)
        return done

    def run(self, xs) -> List[Completed]:
        """Submit a batch (leading axis = requests) and drain to
        completion; results in submission order."""
        uids = [self.submit(x) for x in np.asarray(xs)]
        results: Dict[int, Completed] = {}
        while len(self):
            for c in self.step():
                results[c.uid] = c
        return [results[u] for u in uids]
