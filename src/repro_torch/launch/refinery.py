"""Online refinery: closed-loop hypersolver refinement from live traffic —
the port of ``repro/launch/refinery.py`` (see its docstring).

1. **Residual ledger** (``ResidualLedger``): both serving loops capture
   ``(s, eps, z, dz, R)`` rows from states they already hold — the
   in-flight scheduler from interior healthy slot rows at each retire,
   the drain engine from the probe states at admission. ``R`` is the
   Eq. 6 residual against a finer reference (two RK4 half-steps), so a
   fit needs neither the field nor a trajectory. Rows live on the host
   in a bounded, seeded reservoir (algorithm R) behind a ``capture_rate``
   gate drawn from the ledger's own ``RandomState``, in the reference's
   order of draws. Capture reads serving state and writes none, runs
   under ``torch.no_grad()``, and is never priced by the cost oracle, so
   capture-enabled completions are bit for bit the capture-free ones.
2. **Trainer** (``Refinery.train_tick``): a few fit steps between
   scheduler ticks on the caller's thread — a ledger batch uploaded to
   the params' device, ``core/train.py::make_fit_step`` over
   ``ledger_fitting_loss`` (or ``flow_fitting_loss`` at
   ``param_site="flow"``), the candidate checkpointed by the async
   ``CheckpointManager`` (only the file write rides its thread).
3. **Shadow scorer and gate** (``maybe_promote``, ``check_promoted``):
   a held-out request set replayed through a shadow engine of its own
   (the live pools are never drained), candidate against current on
   agreement with a fine frozen reference and on held-out residual;
   promotion only on non-regression, hot-swapped into the live loops
   between segments, rolled back if a later re-score regresses.

The frozen reference is the base tableau at ``ref_K`` steps on the
model's fused path when it has one (the reference runs it unfused,
where a bf16 state cannot take a per-sample eps; the port keeps the
state's dtype through the kernel instead).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.integrate import (Integrator, _bcast, rk_stages,
                                        tree_axpy, tree_lincomb)
from repro_torch.core.residual import flow_fitting_loss, ledger_fitting_loss
from repro_torch.core.tableaus import get as get_tableau
from repro_torch.core.train import batch_to, make_fit_step
from repro_torch.launch.engine import take_rows
from repro_torch.optim import adamw
from repro_torch.optim.schedules import cosine_annealing

__all__ = ["ResidualLedger", "Refinery", "RefineryConfig"]


def _device_of(tree) -> torch.device:
    return pytree.tree_leaves(tree)[0].device


# --------------------------------------------------------------- the ledger ----

class ResidualLedger:
    """Bounded, seeded-reservoir host buffer of serving-time residual rows
    and the capture cell that produces them.

    One row is ``(s, eps, z, dz, R)`` for one request: the state ``z`` at
    depth ``s``, its step size, ``dz = f(s, z)``, and ``R = [z_ref(s+eps)
    - z - eps*psi] / eps^{p+1}`` with ``z_ref`` two RK4 half-steps.
    ``holdout_every``: every Nth kept row goes to a held-out split the
    trainer never samples (the shadow scorer's residual metric). Rows are
    CPU tensors in the dtypes the cell produced them in."""

    def __init__(self, model, capacity: int = 512,
                 capture_rate: float = 1.0, seed: int = 0,
                 holdout_every: int = 8):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if not (0.0 <= capture_rate <= 1.0):
            raise ValueError(
                f"capture_rate must be in [0, 1], got {capture_rate}")
        self.model = model
        self.capacity = int(capacity)
        self.capture_rate = float(capture_rate)
        self.holdout_every = int(holdout_every)
        self._rng = np.random.RandomState(seed)
        self._samples: List[Tuple] = []      # (s, eps, z, dz, R) rows
        self._holdout: List[Tuple] = []
        self.seen = 0                        # kept rows ever offered
        self.captures = 0                    # capture events that fired

    # ------------------------------------------------------------- state ----
    @property
    def fill(self) -> int:
        return len(self._samples)

    @property
    def holdout_fill(self) -> int:
        return len(self._holdout)

    # ------------------------------------------------------- capture cell ----
    def _cell(self, xs, z, s: torch.Tensor, eps: torch.Tensor):
        """``(dz, R)`` of every row: the base tableau's stages and psi, a
        finer RK4 reference (two half steps) and the Eq. 6 residual, row
        by row, in the reference's arithmetic (a float32 ``eps`` promotes
        a low-precision state as JAX promotes it)."""
        m = self.model
        tab = m.integ.tableau
        ref_tab = get_tableau("rk4")
        p1 = tab.order + 1
        with torch.no_grad():
            f = m.field_of(xs)
            stages = rk_stages(f, tab, s, eps, z)
            dz = stages[0]
            psi = tree_lincomb(tab.b, stages)

            def fine(s_, h_, z_):
                st = rk_stages(f, ref_tab, s_, h_, z_)
                return tree_axpy(h_, tree_lincomb(ref_tab.b, st), z_)

            h2 = eps * 0.5
            z_ref = fine(s + h2, h2, fine(s, h2, z))
            R = pytree.tree_map(
                lambda zr, zz, ps: (zr - zz - _bcast(eps, zz) * ps)
                / _bcast(eps ** p1, zz), z_ref, z, psi)
        return dz, R

    # ----------------------------------------------------------- capture ----
    def _fires(self) -> bool:
        if self.capture_rate <= 0.0:
            return False
        if self.capture_rate >= 1.0:
            return True
        return bool(self._rng.random_sample() < self.capture_rate)

    def _offer(self, sample: Tuple) -> None:
        """Reservoir-add one kept row (algorithm R), every
        ``holdout_every``-th to the held-out split (cyclic overwrite once
        that split is full)."""
        self.seen += 1
        if self.holdout_every and self.seen % self.holdout_every == 0:
            if len(self._holdout) < self.capacity:
                self._holdout.append(sample)
            else:
                self._holdout[self.seen % self.capacity] = sample
            return
        if len(self._samples) < self.capacity:
            self._samples.append(sample)
        else:
            j = int(self._rng.randint(0, self.seen))
            if j < self.capacity:
                self._samples[j] = sample

    def capture(self, xs, z, s, eps, keep=None) -> int:
        """Capture residual rows from a request batch (the drain engine's
        admission hook): ``xs`` the (B, ...) inputs, ``z`` the matching
        state tree, ``s``/``eps`` (B,) float rows, ``keep`` a row mask.
        Pads to a power-of-two row width as the reference does. Returns
        the number of rows offered to the reservoir."""
        if not self._fires():
            return 0
        B = len(xs)
        if B == 0:
            return 0
        w = 1 << max(B - 1, 0).bit_length()
        s = np.asarray(s, np.float32)
        eps = np.asarray(eps, np.float32)
        if w != B:
            pad = np.arange(w) % B
            xs, z = xs[pad], take_rows(z, pad)
            s, eps = s[pad], eps[pad]
        mask = np.ones(B, bool) if keep is None else \
            np.asarray(keep, bool).copy()
        dev = _device_of(z)
        dz, R = self._cell(xs, z, torch.as_tensor(s, device=dev),
                           torch.as_tensor(eps, device=dev))
        return self._ingest(s, eps, z, dz, R, np.flatnonzero(mask))

    def capture_pool(self, pool, rows: np.ndarray) -> int:
        """Capture residual rows from an in-flight slot pool (the
        scheduler's retire hook): one pool-width pass of the cell at each
        row's current ``s = s0 + k*eps``, then the rows ``rows``. The
        pool's buffers are read, never written, before the next segment
        is launched. A pool split over a mesh is read across its
        sub-pools, gathered in slot order on its first device."""
        if len(rows) == 0 or not self._fires():
            return 0
        s0 = self.model.span[0]
        s = (s0 + pool.k.astype(np.float64)
             * pool.eps.astype(np.float64)).astype(np.float32)
        eps = np.asarray(pool.eps, np.float32)
        dev = pool.device
        xs, z = pool.gathered()
        dz, R = self._cell(xs, z, torch.as_tensor(s, device=dev),
                           torch.as_tensor(eps, device=dev))
        return self._ingest(s, eps, z, dz, R, rows)

    def _ingest(self, s, eps, z, dz, R, rows) -> int:
        """Bring the captured rows to the host (a gathered snapshot,
        blocking), drop rows whose ``R`` is not finite, and offer the
        rest to the reservoir in row order."""
        self.captures += 1
        rows = np.asarray(rows, np.int64)
        if not len(rows):
            return 0
        host = lambda t: pytree.tree_map(lambda l: l.cpu(),
                                         take_rows(t, rows))
        z_h, dz_h, R_h = host(z), host(dz), host(R)
        finite = torch.stack([
            torch.isfinite(l.reshape(len(rows), -1)).all(dim=1)
            for l in pytree.tree_leaves(R_h)]).all(dim=0).numpy()
        offered = 0
        for j, i in enumerate(rows):
            if not finite[j]:
                continue
            row = lambda t: pytree.tree_map(lambda l: l[j].clone(), t)
            self._offer((np.float32(s[i]), np.float32(eps[i]),
                         row(z_h), row(dz_h), row(R_h)))
            offered += 1
        return offered

    # ---------------------------------------------------------- batching ----
    @staticmethod
    def _stack(samples: Sequence[Tuple]) -> Dict[str, Any]:
        s = torch.as_tensor(np.asarray([t[0] for t in samples], np.float32))
        eps = torch.as_tensor(np.asarray([t[1] for t in samples],
                                         np.float32))
        stack = lambda col: pytree.tree_map(
            lambda *ls: torch.stack(ls), *[t[col] for t in samples])
        return {"s": s, "eps": eps, "z": stack(2), "dz": stack(3),
                "R": stack(4)}

    def sample_batch(self, n: int, rng: np.random.RandomState
                     ) -> Dict[str, Any]:
        """Stacked host batch of ``n`` reservoir rows drawn with
        replacement from ``rng``."""
        if not self._samples:
            raise ValueError("empty ledger: nothing captured yet")
        idx = rng.randint(0, len(self._samples), size=n)
        return self._stack([self._samples[i] for i in idx])

    def holdout_batch(self, n: int) -> Optional[Dict[str, Any]]:
        """Fixed-width batch of the held-out split (rows cycled to width
        ``n``); None until anything is held out."""
        if not self._holdout:
            return None
        return self._stack([self._holdout[i % len(self._holdout)]
                            for i in range(n)])

    # ------------------------------------------------------------- flush ----
    def flush(self, path: str) -> int:
        """Persist both splits as an .npz (``s``, ``eps``, ``n_train`` and
        ``z_i``/``dz_i``/``R_i`` per leaf; bf16 leaves widened exactly to
        float32, which numpy stores) — the graceful-drain hook. Returns
        the number of rows written."""
        rows = self._samples + self._holdout
        if not rows:
            np.savez(path, s=np.zeros((0,), np.float32),
                     eps=np.zeros((0,), np.float32), n_train=0)
            return 0
        cols = self._stack(rows)
        flat = {"s": cols["s"].numpy(), "eps": cols["eps"].numpy(),
                "n_train": len(self._samples)}
        for name in ("z", "dz", "R"):
            for i, leaf in enumerate(pytree.tree_leaves(cols[name])):
                if leaf.dtype == torch.bfloat16:
                    leaf = leaf.float()
                flat[f"{name}_{i}"] = leaf.numpy()
        np.savez(path, **flat)
        return len(rows)


# -------------------------------------------------------------- the trainer ----

@dataclasses.dataclass(frozen=True)
class RefineryConfig:
    """Knobs of the cooperative trainer and the promotion gate."""

    steps_per_tick: int = 2       # fit steps per scheduler tick
    batch_size: int = 32          # ledger rows per fit step
    min_fill: int = 32            # ledger fill before training starts
    lr: float = 3e-3              # AdamW peak lr (cosine to lr_min)
    lr_min: float = 1e-4
    weight_decay: float = 1e-6
    grad_clip: float = 10.0
    total_steps: int = 1000       # cosine horizon for the candidate
    ckpt_every: int = 50          # candidate steps between async saves
    shadow_every: int = 100       # candidate steps between shadow scores
    agreement_margin: float = 0.0  # allowed agreement slack at the gate
    resid_margin: float = 0.0     # allowed residual-norm slack at the gate
    holdout_rows: int = 64        # fixed eval width over the holdout split
    ref_K: int = 64               # fine frozen-reference mesh length
    seed: int = 0


class Refinery:
    """The closed loop: ledger batches -> candidate -> shadow score ->
    gate -> hot-swap (with rollback). Every method runs on the caller's
    thread between scheduler ticks; only the checkpoint write rides the
    CheckpointManager's saver thread, which never touches CUDA.

    ``model`` must carry the refined site parametrically (``g_apply``/
    ``g_params``, or ``flow_apply``/``flow_params`` at
    ``param_site="flow"``); ``shadow_xs`` is the held-out request set;
    ``targets`` of ``tick``/``maybe_promote`` are live engines or
    schedulers, hot-swapped between segments, never drained."""

    def __init__(self, model, ledger: ResidualLedger,
                 cfg: Optional[RefineryConfig] = None, *,
                 ecfg=None, shadow_xs=None, ckpt_dir: Optional[str] = None,
                 score_fn: Optional[Callable] = None,
                 param_site: str = "g"):
        from repro_torch.launch.engine import EngineConfig, MultiRateEngine
        if param_site not in ("g", "flow"):
            raise ValueError(
                f"param_site={param_site!r}: expected 'g' (refine the "
                "hypersolver correction) or 'flow' (refine the K=0 flow "
                "head, core/flowhead.py)")
        if param_site == "g" and model.g_apply is None:
            raise ValueError(
                "Refinery needs a parametric model (DepthModel.g_apply/"
                "g_params): a closure g cannot be swapped")
        if param_site == "flow" and model.flow_apply is None:
            raise ValueError(
                "Refinery(param_site='flow') needs a model with a flow "
                "head (DepthModel.flow_apply/flow_params)")
        self.model = model
        self.ledger = ledger
        self.cfg = cfg or RefineryConfig()
        self.param_site = param_site
        self._rng = np.random.RandomState(self.cfg.seed)

        # current is what serving runs; the candidate trains ahead of it
        self.current = model.g_params if param_site == "g" \
            else model.flow_params
        self.candidate = self.current
        self.device = _device_of(self.current)
        self.steps = 0                      # candidate fit steps taken
        self.last_loss: Optional[float] = None
        self.last_promotion: Optional[int] = None
        self.last_verdict: Optional[Dict] = None
        self.promotions = 0
        self.rejections = 0
        self.rollbacks = 0
        self._prev: Optional[Tuple[Any, Dict]] = None   # rollback handle
        self._current_score: Optional[Dict] = None

        opt = adamw(cosine_annealing(self.cfg.lr, self.cfg.lr_min,
                                     self.cfg.total_steps),
                    weight_decay=self.cfg.weight_decay)
        self._opt_state = opt.init(self.candidate)

        if param_site == "g":
            ga = model.g_apply

            def loss_fn(gp, s, eps, z, dz, R):
                g = lambda e, s_, z_, dz_: ga(gp, e, s_, z_, dz_)
                return ledger_fitting_loss(g, s, eps, z, dz, R)
        else:
            # the flow head fits the same rows; relative=True because the
            # router only hands it confidently easy ones
            fa = model.flow_apply
            order = model.integ.order

            def loss_fn(fp, s, eps, z, dz, R):
                flow = lambda e, s_, z_, dz_: fa(fp, e, s_, z_, dz_)
                return flow_fitting_loss(flow, s, eps, z, dz, R,
                                         order=order, relative=True)

        self._fit_step = make_fit_step(loss_fn, opt, self.cfg.grad_clip)
        self._loss_fn = loss_fn

        # shadow scorer: an engine of its own over the same model (the
        # candidate swaps into it), or at param_site="flow" the K=0 cell
        self._shadow_xs = None if shadow_xs is None else np.asarray(
            shadow_xs)
        self._score_fn = score_fn or self._argmax_agreement
        self._shadow_engine = None
        self._ref_out = None
        if self._shadow_xs is not None:
            if param_site == "g":
                self._shadow_engine = MultiRateEngine(
                    model, ecfg or EngineConfig())
            self._ref_out = self._reference(self._shadow_xs)

        self._ckpt = None
        if ckpt_dir is not None:
            from repro_torch.checkpoint import CheckpointManager
            self._ckpt = CheckpointManager(ckpt_dir, keep=3,
                                           async_save=True)

    # ---------------------------------------------------------- training ----
    def _eval_loss(self, params, s, eps, z, dz, R) -> torch.Tensor:
        with torch.no_grad():
            b = batch_to(dict(s=s, eps=eps, z=z, dz=dz, R=R), self.device)
            return self._loss_fn(params, b["s"], b["eps"], b["z"], b["dz"],
                                 b["R"])

    def train_tick(self) -> Optional[float]:
        """Up to ``steps_per_tick`` fit steps over ledger batches (none
        below ``min_fill``), the candidate saved asynchronously every
        ``ckpt_every`` steps. Returns the last batch loss, or None."""
        if self.ledger.fill < max(self.cfg.min_fill, 1):
            return None
        loss = None
        for _ in range(self.cfg.steps_per_tick):
            b = batch_to(self.ledger.sample_batch(self.cfg.batch_size,
                                                  self._rng), self.device)
            self.candidate, self._opt_state, l = self._fit_step(
                self.candidate, self._opt_state, self.steps,
                b["s"], b["eps"], b["z"], b["dz"], b["R"])
            self.steps += 1
            loss = float(l)
            if self._ckpt is not None \
                    and self.steps % self.cfg.ckpt_every == 0:
                self._ckpt.save(self.steps, self.candidate)
        self.last_loss = loss
        return loss

    # ----------------------------------------------------------- scoring ----
    def _reference(self, xs) -> np.ndarray:
        """Fine frozen reference for shadow agreement: the base tableau
        (no correction) at ``ref_K`` steps, on the fused path when the
        model serves fused."""
        m = self.model
        K = int(self.cfg.ref_K)
        ref = Integrator(tableau=m.integ.tableau, fused=m.integ.fused)
        with torch.no_grad():
            z0 = m.embed(xs)
            dev = _device_of(z0)
            Ks = torch.full((len(xs),), K, dtype=torch.int32, device=dev)
            zT = ref.solve_multirate(m.field_of(xs), z0, m.span, Ks, K)
            return m.readout(xs, zT).cpu().numpy()

    def _flow_outputs(self, xs, fp) -> np.ndarray:
        """The candidate flow head serving the held-out set as the K=0
        tier would: one full-span F eval off ``(z0, dz0)``, readout."""
        m = self.model
        h, s0 = m.span[1] - m.span[0], m.span[0]
        with torch.no_grad():
            z0 = m.embed(xs)
            dz0 = m.field_of(xs)(s0, z0)
            return m.readout(xs, m.flow_apply(fp, h, s0, z0,
                                              dz0)).cpu().numpy()

    @staticmethod
    def _argmax_agreement(outs: np.ndarray, ref: np.ndarray) -> float:
        """Fraction of matching argmax over the last output axis."""
        return float((np.argmax(outs, -1) == np.argmax(ref, -1)).mean())

    def shadow_score(self, gp) -> Dict[str, float]:
        """Score params on the held-out set: agreement with the frozen
        reference, mean NFE, held-out residual loss. Live pools untouched."""
        out: Dict[str, float] = {}
        if self._shadow_engine is not None:
            self._shadow_engine.hot_swap_g(gp)
            with torch.no_grad():
                recs = self._shadow_engine.run(self._shadow_xs)
            recs = sorted(recs, key=lambda c: c.uid)
            outs = np.stack([c.outputs for c in recs])
            out["agreement"] = self._score_fn(outs, self._ref_out)
            out["mean_nfe"] = float(np.mean([c.nfe for c in recs]))
        elif self._ref_out is not None:
            outs = self._flow_outputs(self._shadow_xs, gp)
            out["agreement"] = self._score_fn(outs, self._ref_out)
        hb = self.ledger.holdout_batch(self.cfg.holdout_rows)
        if hb is not None:
            out["resid"] = float(self._eval_loss(
                gp, hb["s"], hb["eps"], hb["z"], hb["dz"], hb["R"]))
        return out

    def _non_regression(self, cand: Dict, cur: Dict) -> bool:
        """The gate: no regression on any metric both scores carry."""
        ok = True
        if "agreement" in cand and "agreement" in cur:
            ok &= cand["agreement"] >= cur["agreement"] \
                - self.cfg.agreement_margin
        if "resid" in cand and "resid" in cur:
            ok &= cand["resid"] <= cur["resid"] + self.cfg.resid_margin
        return bool(ok)

    def _swap(self, target, params) -> None:
        if self.param_site == "g":
            target.hot_swap_g(params)
        else:
            target.hot_swap_flow(params)

    # ---------------------------------------------------- promote / roll ----
    def maybe_promote(self, targets: Sequence = ()) -> Dict:
        """Score candidate and current fresh; hot-swap the candidate into
        every target only on non-regression. Returns the verdict."""
        cand = self.shadow_score(self.candidate)
        cur = self.shadow_score(self.current)
        self._current_score = cur
        promoted = self._non_regression(cand, cur)
        self.last_verdict = {
            "step": self.steps, "promoted": promoted,
            "candidate": cand, "current": cur,
        }
        if promoted:
            self._prev = (self.current, cur)
            self.current = self.candidate
            self._current_score = cand
            for t in targets:
                self._swap(t, self.current)
            self.promotions += 1
            self.last_promotion = self.steps
        else:
            self.rejections += 1
        return self.last_verdict

    def check_promoted(self, targets: Sequence = ()) -> Optional[bool]:
        """Re-score the promoted params against the pre-promotion ones
        (both fresh) and roll the previous ones back into every target
        on regression. None if there is nothing to check, else whether a
        rollback fired."""
        if self._prev is None:
            return None
        score = self.shadow_score(self.current)
        prev_params, _ = self._prev
        prev_score = self.shadow_score(prev_params)
        if self._non_regression(score, prev_score):
            self._current_score = score
            return False
        for t in targets:
            self._swap(t, prev_params)
        self.current = prev_params
        self._current_score = prev_score
        self._prev = None
        self.rollbacks += 1
        return True

    # -------------------------------------------------------- tick / misc ----
    def tick(self, targets: Sequence = ()) -> None:
        """Train a little; every ``shadow_every`` candidate steps run the
        post-promotion guard and the gate."""
        before = self.steps
        self.train_tick()
        crossed = (self.steps // self.cfg.shadow_every
                   > before // self.cfg.shadow_every)
        if crossed and self.steps > 0:
            self.check_promoted(targets)
            self.maybe_promote(targets)

    def flush(self) -> None:
        """Block until any pending async candidate checkpoint is on disk."""
        if self._ckpt is not None:
            self._ckpt.wait()

    def status(self) -> Dict[str, Any]:
        """One-line state for the serving CLI's progress line."""
        return {
            "ledger_fill": self.ledger.fill,
            "ledger_seen": self.ledger.seen,
            "candidate_step": self.steps,
            "last_loss": self.last_loss,
            "last_promotion": self.last_promotion,
            "promotions": self.promotions,
            "rejections": self.rejections,
            "rollbacks": self.rollbacks,
        }
