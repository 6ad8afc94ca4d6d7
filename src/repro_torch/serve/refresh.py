"""Warm-started online model refresh (append -> refine -> atomic swap); port
of ``repro.serve.refresh``.

The same carry that amortises outer MLL steps (paper §4) amortises *model
refresh* when observations stream in (Dong et al., 2025): the old
solutions, zero-padded on the appended rows, warm-start the enlarged
system, so a budgeted warm solve reaches tolerance in far fewer epochs than
a cold start. `OnlineGP` owns the mutable (data, state) pair; serving stays
on the frozen `ServableGP` until `refine` finishes and the engine swap makes
the new artifact visible atomically.

  * **Geometric capacity growth** (``growth="geometric"``): the training
    arrays are padded up the capacity ladder
    (:func:`repro_torch.core.outer.grow_capacity`) with *ghost rows*, points
    on the ray ``j * unit * (1, ..., 1)`` hundreds of lengthscales from the
    data and from each other, so the exported artifact keeps one shape
    between growth events. Every cross term between a ghost and a real row
    underflows to exactly 0.0 in fp32, so the real-row solutions are those
    of the unpadded system. The forward kernel (and the plain versions of
    the ``cuda`` backend) take ``r2`` by direct differences, so each ghost's
    diagonal is exactly ``s^2 + sigma^2``; the reference's expanded form
    cancels at the ghost coordinates and leaves some ghost diagonals at
    ``sigma^2`` (so ghost-row solutions, and iteration counts under geometric
    growth, may differ from the reference's; real rows do not).

  * **Damped old-row correction** (``correction="damped"``): the block
    refresh (``mode="block"``) leaves the old-row back-coupling ``K12 dv``
    unpaid; the correction repairs the old rows with a free damped-Jacobi
    step ``dv1 = -omega * K12 dv / (signal^2 + noise^2)`` and a small
    budgeted warm polish of the full system whose solver residual is the
    honest report. ``mode="auto"`` escalates to a full warm re-solve only
    when that residual is still above threshold.

Port differences: the reference's per-solve PRNG keys (``fold_in(state.key,
11/13/17/19)``, read only by SGD) are a ``generator=`` (or SGD's handed-over
``batch_idx=``) here, and the new rows' base noise comes from
``extend_state(generator=, rows=)``: from the OnlineGP's generator, or
handed over as ``rows=`` (:meth:`OnlineGP.append`, ``reserve_rows=``).
There is no jit: one solve entry per static solver config (full and block)
is a plain function, and :meth:`OnlineGP.num_solve_compiles` returns None
("accounting unavailable"); under geometric growth the shape contract is
held by ``capacity`` and ``growth_events`` staying constant. The port's
`OuterState` carries no rolling diagnostics, so the OnlineGP keeps the last
residuals itself. Every kernel product of a refine (the solves' MVMs, the
block refresh's two cross-MVMs) goes through the forward tile kernel when
``cfg.backend == "cuda"`` (its plain version on CPU tensors).
"""
from __future__ import annotations

import math
import threading
from concurrent.futures import Future
from dataclasses import replace
from typing import NamedTuple, Optional

import torch

from repro_torch.core.estimators import build_system_targets
from repro_torch.core.outer import (
    OuterConfig,
    OuterState,
    effective_kind,
    extend_state,
    grow_capacity,
    outer_step,
)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.artifact import ServableGP, export_servable
from repro_torch.solvers import (
    HOperator,
    kernel_mvm_tiled,
    numerics_of,
    solve,
    strip_numerics,
)


def merge_refined_state(current: OuterState,
                        refined: OuterState) -> OuterState:
    """Fold a refinement computed on an n-row snapshot into ``current``.

    ``current`` may have grown past the snapshot (appends that raced a
    background refine): its extra carry/probe rows — zero carry plus fresh
    base noise from `extend_state` — survive the commit, so the solved rows
    overwrite only the snapshot's prefix. ``current``'s probes are kept;
    hyperparameter/Adam/step progress is taken from ``refined``.
    """
    n_solved = refined.carry_v.shape[0]
    if current.carry_v.shape[0] > n_solved:
        carry = torch.cat([refined.carry_v, current.carry_v[n_solved:]])
    else:
        carry = refined.carry_v
    return current._replace(carry_v=carry, params=refined.params,
                            adam=refined.adam, step=refined.step)


# refine(mode="auto") escalation threshold, in units of the solver
# tolerance (the reference's: ~2x vs ~9000x tolerance on its fixtures for
# weak vs strong coupling). Override per call with ``coupling_threshold``.
AUTO_COUPLING_FACTOR = 5.0

# Growth policies for appended observations.
GROWTH_EXACT = "exact"  # arrays grow by the exact append size
GROWTH_GEOMETRIC = "geometric"  # capacity ladder + inert ghost rows

# Ghost rows sit on the ray ``j * unit * (1, ..., 1)`` with ``unit =
# GHOST_UNIT_FACTOR * (data span + max lengthscale + 1)``: >= 256
# lengthscales from every real point and every other ghost, where exp(-256)
# (Matérn-1/2, the slowest-decaying registered kernel) underflows to 0.0.
GHOST_UNIT_FACTOR = 256.0

# Damped old-row correction defaults: the damping of the free Jacobi step
# and the full-system epoch budget of the warm polish.
CORRECTION_DAMPING = 0.5
CORRECTION_EPOCHS = 2.0


class RefreshReport(NamedTuple):
    """What one `refine` cost and achieved (the reference's fields, plus
    ``mvms``).

    ``epochs`` is in FULL-system epoch units (one epoch = every entry of
    the n x n H once, n the PADDED capacity under geometric growth): a
    block refresh on k new rows charges 2k/n for its two cross MVMs plus
    ``block_epochs * (k/n)^2`` for the k x k solve; an escalated
    ``mode="auto"`` charges the block attempt (and correction) plus the
    full re-solve. ``mvms`` counts the kernel products the refine ran —
    the solves' full MVMs (a k x k one for the block solve), the block
    refresh's two cross-MVMs and, for ``mode="step"``, the gradient's
    forward — each one launch of the forward kernel on the card (AP and
    SGD slabs are counted by ``iters``, as in the solver).
    """

    n: int  # REAL training rows after the refresh (ghost rows excluded)
    appended: int  # rows appended since the last refine
    epochs: float  # solver epochs consumed (full-system units)
    iters: int  # inner iterations
    res_y: float  # final mean-system relative residual
    res_z: float  # final probe-average relative residual
    warm: bool  # warm-started from the extended carry?
    mode: str = "solve"  # solve | step | block | auto
    block_rows: int = 0  # rows of the block sub-system (mode="block"/"auto")
    block_epochs: float = 0.0  # solver epochs in k-system units (block/auto)
    escalated: bool = False  # auto mode fell back to a full re-solve?
    corrected: bool = False  # damped old-row correction ran?
    correction_epochs: float = 0.0  # full-system epochs spent by it
    capacity: int = 0  # padded system rows (== n under growth="exact")
    trace_ids: tuple = ()  # traces of the appends this refine absorbed
    mvms: int = 0  # kernel products run (see the class docstring)


class OnlineGP:
    """A fitted GP that can absorb new observations and refresh in place.

    Typical loop:

        online = OnlineGP(x, y, fit_result.state, cfg)
        engine = BucketedEngine(online.export()); engine.warmup()
        ...
        online.append(x_new, y_new)
        online.refresh_into(engine, budget_epochs=10.0)   # solve + swap

    Args:
      x: (n, d) training inputs of the fitted state (on its device).
      y: (n,) training targets.
      state: the fitted `OuterState` (pathwise carry for serving export).
      cfg: the `OuterConfig` the state was fitted under (``cfg.backend``
        picks the kernel products: ``cuda`` is the forward tile kernel).
      growth: ``"exact"`` (default) or ``"geometric"`` (module docstring).
      reserve: with geometric growth, pre-extend capacity to cover this
        many future appended rows up front (zero growth events after).
      generator: draws the new rows' base noise (a generator on ``x``'s
        device seeded with 0 when None).
      reserve_rows: the (pad, s) base-noise rows of the reserve's growth,
        handed over instead of drawn.
      last_residuals: ``(res_y, res_z)`` of the fit's last solve (what a
        no-append block refine reports); NaN when not given. A hand-over:
        the reference keeps these in its state, the port's `OuterState`
        does not. The parity tests pass the reference's; a caller can pass
        its fit's ``history["res_y"][-1], history["res_z"][-1]``.
    """

    def __init__(self, x: torch.Tensor, y: torch.Tensor, state: OuterState,
                 cfg: OuterConfig, growth: str = GROWTH_EXACT,
                 reserve: int = 0,
                 generator: Optional[torch.Generator] = None,
                 reserve_rows: Optional[torch.Tensor] = None,
                 last_residuals: Optional[tuple] = None):
        if growth not in (GROWTH_EXACT, GROWTH_GEOMETRIC):
            raise ValueError(
                f"growth must be {GROWTH_EXACT!r} or {GROWTH_GEOMETRIC!r}, "
                f"got {growth!r}")
        self.x = x  #: guarded by self._lock (replaced, never written)
        self.y = y  #: guarded by self._lock
        self.state = state  #: guarded by self._lock
        self.cfg = cfg
        self.growth = growth
        self._generator = (generator if generator is not None else
                           torch.Generator(device=x.device).manual_seed(0))
        self._n = int(x.shape[0])
        self._appended = 0
        self._ghost_count = 0
        self._ghost_unit_val: Optional[float] = None
        self._lock = threading.Lock()
        self._last_report: Optional[RefreshReport] = None
        res_y, res_z = last_residuals or (math.nan, math.nan)
        self._last_res = (float(res_y), float(res_z))
        self._counters = {
            "refines": 0, "appends": 0, "appended_rows": 0,
            "escalations": 0, "corrections": 0, "growth_events": 0,
            "cum_epochs": 0.0, "cum_iters": 0,
        }
        self._pending_traces: list = []
        reg = obs_metrics.default_registry()
        self._m_refines = reg.counter(
            "gp_refresh_refines_total", "Refine operations by mode",
            labelnames=("mode",))
        self._m_appended = reg.counter(
            "gp_refresh_appended_rows_total", "Observations appended")
        self._m_escalations = reg.counter(
            "gp_refresh_escalations_total", "auto-mode full-solve escalations")
        self._m_epochs = reg.counter(
            "gp_refresh_epochs_total", "Solver epochs spent by refines")
        self._m_pending = reg.gauge(
            "gp_refresh_pending_appends", "Appended rows awaiting a refine")

        kind = effective_kind(cfg, state.params)
        self._kind = kind
        base = cfg.solver if cfg.solver.kind == kind else replace(
            cfg.solver, kind=kind)
        # The caller's numeric values ride in as SolverNumerics; the solve
        # entries close over the stripped static half, one per static
        # config (full and block), as the reference's jitted wrappers.
        self._scfg_full = base
        self._scfg_block = replace(base, name="cg")
        self._solve_full = self._make_solve(strip_numerics(self._scfg_full))
        self._solve_block = self._make_solve(strip_numerics(self._scfg_block))
        if growth == GROWTH_GEOMETRIC and reserve > 0:
            with self._lock:
                self._grow_to_locked(self._n + int(reserve), reserve_rows)
        elif reserve_rows is not None:
            raise ValueError("reserve_rows needs growth='geometric' and "
                             "reserve > 0")

    # -- sizes ---------------------------------------------------------------
    @property
    def n(self) -> int:
        """Number of REAL training rows (ghost padding excluded)."""
        return self._n

    @property
    def capacity(self) -> int:
        """Padded row count of the stored arrays (== n under exact growth)."""
        with self._lock:
            return self._capacity_locked()

    def _capacity_locked(self) -> int:
        return int(self.x.shape[0])

    # -- solver plumbing -----------------------------------------------------
    def _make_solve(self, scfg):
        """One solve entry per static solver config (numerics passed in)."""
        cfg, kind = self.cfg, self._kind

        def _solve(xs, b, v0, params, numerics, generator=None,
                   batch_idx=None):
            op = HOperator(x=xs, params=params, kind=kind,
                           backend=cfg.backend, bm=cfg.bm, bn=cfg.bn)
            with torch.no_grad():
                return solve(op, b, v0, scfg, batch_idx=batch_idx,
                             generator=generator, numerics=numerics)

        return _solve

    def _cross_mvm(self, x1: torch.Tensor, x2: torch.Tensor, v: torch.Tensor,
                   params) -> torch.Tensor:
        """K(x1, x2) @ v for the block refresh: the forward kernel under the
        ``cuda`` backend, the plain tiled MVM otherwise (the reference's)."""
        with torch.no_grad():
            if self.cfg.backend == "cuda":
                from repro_torch.kernels.ops import kernel_mvm

                return kernel_mvm(x1, x2, v, params, kind=self._kind)
            return kernel_mvm_tiled(x1, x2, v, params, kind=self._kind,
                                    bm=self.cfg.bm, bn=self.cfg.bn)

    def num_solve_compiles(self) -> Optional[int]:
        """None: eager PyTorch keeps no executable cache ("accounting
        unavailable", never zero)."""
        return None

    # -- growth --------------------------------------------------------------
    def _ghost_unit_locked(self) -> float:
        """Spacing of the ghost ray (computed once, from data + lengthscale;
        lock held by caller)."""
        if self._ghost_unit_val is None:
            span = (float(torch.max(torch.abs(self.x[: self._n])))
                    if self._n else 1.0)
            ls = float(torch.max(self.state.params.lengthscales))
            self._ghost_unit_val = GHOST_UNIT_FACTOR * (span + ls + 1.0)
        return self._ghost_unit_val

    def _ghost_inputs_locked(self, k: int) -> torch.Tensor:
        """(k, d) inert pad points: far from the data AND from each other
        (lock held by caller)."""
        unit = self._ghost_unit_locked()
        d, dtype, device = self.x.shape[1], self.x.dtype, self.x.device
        idx = (torch.arange(1, k + 1, dtype=dtype, device=device)
               + torch.tensor(self._ghost_count, dtype=dtype, device=device))
        self._ghost_count += k
        return idx[:, None] * unit * torch.ones((1, d), dtype=dtype,
                                                device=device)

    def _extend_locked(self, num_new: int,
                       rows: Optional[torch.Tensor]) -> None:
        """Extend the state by ``num_new`` rows (lock held by caller)."""
        if rows is not None and rows.shape[0] != num_new:
            raise ValueError(f"rows has {rows.shape[0]} rows, the extension "
                             f"{num_new}")
        self.state = extend_state(self.state, num_new, dtype=self.x.dtype,
                                  generator=self._generator, rows=rows)

    def _grow_to_locked(self, needed: int,
                        rows: Optional[torch.Tensor] = None) -> bool:
        """Extend capacity up the geometric ladder (lock held by caller);
        True when it grew."""
        cap = self._capacity_locked()
        new_cap = grow_capacity(cap, needed)
        if new_cap <= cap:
            return False
        pad = new_cap - cap
        self._extend_locked(pad, rows)
        self.x = torch.cat([self.x, self._ghost_inputs_locked(pad)])
        self.y = torch.cat([self.y, torch.zeros((pad,), dtype=self.y.dtype,
                                                device=self.y.device)])
        self._counters["growth_events"] += 1
        return True

    def append(self, x_new: torch.Tensor, y_new: torch.Tensor,
               trace_id: Optional[str] = None,
               rows: Optional[torch.Tensor] = None) -> None:
        """Add observations; extends the warm-start carry with zero rows and
        fixes base-probe randomness for the new rows.

        Under geometric growth the rows are written into reserved ghost
        slots (their base noise was drawn at growth time and stays fixed);
        capacity grows, by :func:`repro_torch.core.outer.grow_capacity`,
        only when the slots run out. ``rows`` hands over the base noise of
        the extension this call makes instead of drawing it: (k, s) under
        exact growth, the growth event's (pad, s) under geometric growth
        (an error when no growth happens). Stored tensors are replaced,
        never written in place, so an exported artifact or a background
        refine's snapshot never sees the append.

        ``trace_id`` (default: the caller's current trace context) is kept
        until the next :meth:`refine`, whose report and "refresh" event
        carry every trace that contributed appends.
        """
        tid = trace_id if trace_id is not None else obs_trace.current_trace_id()
        with self._lock:
            if x_new.ndim != 2 or x_new.shape[1] != self.x.shape[1]:
                raise ValueError(f"x_new must be (k, {self.x.shape[1]}), "
                                 f"got {tuple(x_new.shape)}")
            x_new = x_new.to(dtype=self.x.dtype, device=self.x.device)
            y_new = y_new.to(dtype=self.y.dtype, device=self.y.device)
            k = x_new.shape[0]
            if self.growth == GROWTH_GEOMETRIC:
                grew = self._grow_to_locked(self._n + k, rows)
                if rows is not None and not grew:
                    raise ValueError("rows given, but this append needs no "
                                     "growth (its slots were drawn already)")
                lo = self._n
                x, y = self.x.clone(), self.y.clone()
                x[lo:lo + k], y[lo:lo + k] = x_new, y_new
                carry = self.state.carry_v.clone()
                carry[lo:lo + k] = 0.0
                self.x, self.y = x, y
                self.state = self.state._replace(carry_v=carry)
            else:
                self._extend_locked(k, rows)
                self.x = torch.cat([self.x, x_new])
                self.y = torch.cat([self.y, y_new])
            self._n += k
            self._appended += k
            self._counters["appends"] += 1
            self._counters["appended_rows"] += k
            if tid is not None:
                self._pending_traces.append(tid)
            pending = self._appended
        self._m_appended.inc(k)
        self._m_pending.set(pending)

    # -- refinement ----------------------------------------------------------
    def _record(self, report: RefreshReport) -> None:
        """Fold one refine into the cumulative counters (lock held)."""
        self._counters["refines"] += 1
        self._counters["cum_epochs"] += float(report.epochs)
        self._counters["cum_iters"] += int(report.iters)
        if report.escalated:
            self._counters["escalations"] += 1
        if report.corrected:
            self._counters["corrections"] += 1
        self._last_report = report
        self._m_refines.inc(mode=report.mode)
        self._m_epochs.inc(float(report.epochs))
        if report.escalated:
            self._m_escalations.inc()
        self._m_pending.set(self._appended)

    def _emit_refresh(self, report: RefreshReport) -> None:
        """One structured "refresh" event per refine (no-op when no log)."""
        obs_trace.emit(
            "refresh", mode=report.mode, n=report.n,
            appended=report.appended, epochs=report.epochs,
            iters=report.iters, res_y=report.res_y, res_z=report.res_z,
            escalated=report.escalated, corrected=report.corrected,
            trace_ids=list(report.trace_ids),
        )

    def _numerics(self, scfg, max_epochs: Optional[float]):
        nm = numerics_of(scfg)
        if max_epochs is not None:
            nm = nm._replace(max_epochs=torch.tensor(float(max_epochs),
                                                     dtype=torch.float32))
        return nm

    def refine(
        self,
        budget_epochs: Optional[float] = None,
        warm: bool = True,
        mode: str = "solve",
        generator: Optional[torch.Generator] = None,
        coupling_threshold: Optional[float] = None,
        correction: str = "none",
        correction_epochs: float = CORRECTION_EPOCHS,
        correction_damping: float = CORRECTION_DAMPING,
        batch_idx=None,
    ) -> RefreshReport:
        """Budgeted refinement of the enlarged system (paper §5 budgets).

        ``mode="solve"`` re-solves the systems at fixed hyperparameters
        (tolerance the early stop, the epoch budget the cap; ``warm=False``
        is the cold-start control). ``mode="step"`` runs one full
        `outer_step` (hyperparameters move too; refused under geometric
        growth, where ghost rows would bias the MLL gradient).

        ``mode="block"`` solves only the k x k sub-system of the appended
        rows, ``(K(x_new, x_new) + sigma^2 I) dv = b_new - H[new, :] @
        v_old``, and leaves the old rows' back-coupling ``K12 dv`` unpaid;
        its report's ``res_y``/``res_z`` are that neglected residual over
        ``||b||``. ``correction="damped"`` (block/auto) repairs the old rows
        when it exceeds tolerance: a damped-Jacobi step then a warm
        full-system polish of ``correction_epochs`` epochs, whose solver
        residual is reported. ``mode="auto"`` escalates to a full warm
        re-solve from the corrected carry, with the epochs already spent
        subtracted from ``budget_epochs``, when ``max(res_y, res_z)``
        exceeds ``coupling_threshold`` (default ``AUTO_COUPLING_FACTOR x``
        tolerance).

        ``generator`` draws SGD's schedules (and a cold step's fresh
        probes) unless ``batch_idx`` hands a schedule over; CG and AP draw
        nothing.

        Returns:
          A :class:`RefreshReport`; the refined carry is committed into the
          live state (merged with any appends that raced this refine).
        """
        if correction not in ("none", "damped"):
            raise ValueError(
                f"correction must be 'none' or 'damped', got {correction!r}")
        with self._lock:
            state, x, y, cfg = self.state, self.x, self.y, self.cfg
            appended = self._appended
            n_real = self._n
            trace_ids = tuple(self._pending_traces)
            last_res = self._last_res
        cap = int(x.shape[0])
        if mode == "step":
            if self.growth == GROWTH_GEOMETRIC:
                raise ValueError(
                    "mode='step' moves hyperparameters on the padded system; "
                    "ghost rows would bias the MLL gradient — use "
                    "growth='exact' for refresh-with-hyperparameter-updates")
            scfg = cfg.solver if budget_epochs is None else replace(
                cfg.solver, max_epochs=budget_epochs)
            step_cfg = replace(cfg, solver=scfg, warm_start=warm)
            new_state, metrics = outer_step(state, x, y, step_cfg,
                                            generator=generator,
                                            batch_idx=batch_idx)
            report = RefreshReport(
                n=n_real, appended=appended,
                epochs=float(metrics["epochs"]), iters=int(metrics["iters"]),
                res_y=float(metrics["res_y"]), res_z=float(metrics["res_z"]),
                warm=warm, mode=mode, capacity=cap,
                mvms=int(metrics["mvms"]) + 1)
        elif mode == "solve":
            with torch.no_grad():
                targets = build_system_targets(state.probes, x, y,
                                               state.params)
            res = self._solve_full(
                x, targets, state.carry_v if warm else None, state.params,
                self._numerics(self._scfg_full, budget_epochs), generator,
                batch_idx)
            new_state = state._replace(carry_v=res.v)
            report = RefreshReport(
                n=n_real, appended=appended,
                epochs=float(res.epochs), iters=int(res.iters),
                res_y=float(res.res_y), res_z=float(res.res_z), warm=warm,
                mode=mode, capacity=cap, mvms=res.mvms)
        elif mode in ("block", "auto"):
            if not warm:
                raise ValueError(
                    "block refresh refines the warm carry; it has no "
                    "cold-start variant (use mode='solve', warm=False)")
            k = appended
            if k == 0:
                report = RefreshReport(
                    n=n_real, appended=0, epochs=0.0, iters=0,
                    res_y=last_res[0], res_z=last_res[1], warm=True,
                    mode=mode, capacity=cap, trace_ids=trace_ids)
                with self._lock:
                    self._pending_traces = self._pending_traces[len(trace_ids):]
                    self._record(report)
                self._emit_refresh(report)
                return report
            new_state, report, targets = self._block_refine(
                state, x, y, n_real, k, budget_epochs, generator, batch_idx,
                correction, correction_epochs, correction_damping)
            threshold = (coupling_threshold if coupling_threshold is not None
                         else AUTO_COUPLING_FACTOR
                         * float(self._scfg_full.tolerance))
            if mode == "auto" and max(report.res_y, report.res_z) > threshold:
                # Too strongly coupled for the block update (and the
                # correction): the full warm re-solve, from the corrected
                # carry, with the epochs already spent subtracted.
                budget = (None if budget_epochs is None
                          else max(0.0, budget_epochs - report.epochs))
                fres = self._solve_full(
                    x, targets, new_state.carry_v, state.params,
                    self._numerics(self._scfg_full, budget), generator,
                    batch_idx)
                new_state = state._replace(carry_v=fres.v)
                report = report._replace(
                    epochs=report.epochs + float(fres.epochs),
                    iters=report.iters + int(fres.iters),
                    res_y=float(fres.res_y), res_z=float(fres.res_z),
                    escalated=True, mvms=report.mvms + fres.mvms)
            report = report._replace(mode=mode)
        else:
            raise ValueError(f"unknown refine mode {mode!r}")
        report = report._replace(trace_ids=trace_ids)
        with self._lock:
            # Appends may have raced this refine (background mode): commit
            # the solved rows into the CURRENT state so they survive.
            merged = merge_refined_state(self.state, new_state)
            if self._n > n_real:
                # Rows appended mid-refine inside the refined capacity
                # (geometric growth): re-zero their carry, the zero-padded
                # warm-start contract.
                carry = merged.carry_v.clone()
                carry[n_real:self._n] = 0.0
                merged = merged._replace(carry_v=carry)
            self.state = merged
            self._last_res = (report.res_y, report.res_z)
            self._appended = max(0, self._appended - appended)
            # Drain exactly the traces this refine absorbed; ones appended
            # mid-refine stay pending for the next one.
            self._pending_traces = self._pending_traces[len(trace_ids):]
            self._record(report)
        self._emit_refresh(report)
        return report

    def _block_refine(self, state, x, y, n_real, k, budget_epochs, generator,
                      batch_idx, correction, correction_epochs,
                      correction_damping):
        """The block refresh on the last ``k`` real rows (and the damped
        correction): the new state, its report (mode ``block``) and the
        system's right-hand sides."""
        cap = int(x.shape[0])
        n0 = n_real - k
        params = state.params
        with torch.no_grad():
            targets = build_system_targets(state.probes, x, y, params)
        x_new = x[n0:n_real]
        # Residual restricted to the new rows: one (k x cap) cross MVM
        # against the FULL carry (the new rows' carry may be nonzero after
        # an earlier block refine).
        kv = self._cross_mvm(x_new, x, state.carry_v, params)
        noise_var = params.noise ** 2
        r_new = (targets[n0:n_real] - kv
                 - noise_var * state.carry_v[n0:n_real])
        block_budget = None
        if budget_epochs is not None:
            # budget in full-system units: charge BOTH cross MVMs, convert
            # the remainder to k-system epochs.
            block_budget = (max(0.0, budget_epochs - 2 * k / cap)
                            * (cap / k) ** 2)
        res = self._solve_block(
            x_new, r_new, None, params,
            self._numerics(self._scfg_block, block_budget), generator,
            batch_idx)
        new_carry = state.carry_v.clone()
        new_carry[n0:n_real] += res.v
        block_epochs = float(res.epochs)
        iters_total = int(res.iters)
        mvms = res.mvms + 2
        # The unpaid back-coupling K12 @ dv, at full capacity with the block
        # rows masked out (ghost rows contribute exactly 0): the honest
        # full-system residual estimate.
        neglected = self._cross_mvm(x, x_new, res.v, params)
        rows = torch.arange(cap, device=x.device)
        outside = torch.logical_or(rows < n0, rows >= n_real)[:, None]
        neglected = torch.where(outside, neglected,
                                torch.zeros_like(neglected))
        bscale = torch.linalg.vector_norm(targets, dim=0) + 1e-10
        coupling = torch.linalg.vector_norm(neglected, dim=0) / bscale
        res_y = float(coupling[0])
        res_z = (float(torch.mean(coupling[1:])) if coupling.shape[0] > 1
                 else res_y)
        epochs_equiv = 2 * k / cap + block_epochs * (k / cap) ** 2
        corrected = False
        corr_epochs = 0.0
        tol = float(self._scfg_full.tolerance)
        if correction == "damped" and max(res_y, res_z) > tol:
            if correction_epochs <= 0:
                raise ValueError(
                    "correction_epochs must be > 0: the budgeted polish "
                    "is what keeps the reported residual honest after "
                    "the damped step")
            # Free damped-Jacobi head start on the old rows (H's diagonal
            # is signal^2 + noise^2 for every registered stationary
            # kernel), then a warm full-system polish.
            diag = params.signal ** 2 + params.noise ** 2
            head = new_carry - (correction_damping / diag) * neglected
            pres = self._solve_full(
                x, targets, head, params,
                self._numerics(self._scfg_full, correction_epochs), generator,
                batch_idx)
            new_carry = pres.v
            res_y, res_z = float(pres.res_y), float(pres.res_z)
            corr_epochs = float(pres.epochs)
            epochs_equiv += corr_epochs
            iters_total += int(pres.iters)
            mvms += pres.mvms
            corrected = True
        report = RefreshReport(
            n=n_real, appended=k, epochs=epochs_equiv, iters=iters_total,
            res_y=res_y, res_z=res_z, warm=True, mode="block", block_rows=k,
            block_epochs=block_epochs, corrected=corrected,
            correction_epochs=corr_epochs, capacity=cap, mvms=mvms)
        return state._replace(carry_v=new_carry), report, targets

    # -- observability -------------------------------------------------------
    def stats_dict(self) -> dict:
        """JSON-serialisable refresh counters (the reference's ``refresh``
        section of ``GET /stats``): cumulative refines / escalations /
        corrections / growth events / appended rows / epochs / iters;
        point-in-time real rows ``n``, padded ``capacity``, pending appends,
        the solve compile count (None) and the last report's essentials."""
        with self._lock:
            out = dict(self._counters)
            rep = self._last_report
            out.update({
                "n": self._n,
                "capacity": self._capacity_locked(),
                "growth": self.growth,
                "pending_appends": self._appended,
                "num_solve_compiles": self.num_solve_compiles(),
            })
        if rep is not None:
            out["last"] = {
                "mode": rep.mode, "appended": rep.appended,
                "epochs": rep.epochs, "iters": rep.iters,
                "res_y": rep.res_y, "res_z": rep.res_z,
                "block_rows": rep.block_rows,
                "block_epochs": rep.block_epochs,
                "escalated": rep.escalated, "corrected": rep.corrected,
                "correction_epochs": rep.correction_epochs,
            }
        return out

    def export(self) -> ServableGP:
        """Freeze the current state into a serving artifact (at the padded
        capacity under geometric growth: ghost rows add exactly 0 to every
        prediction and keep the artifact's shape)."""
        with self._lock:
            return export_servable(
                self.state, self.x,
                kind=effective_kind(self.cfg, self.state.params))

    def refresh_into(
        self,
        engine,
        name: Optional[str] = None,
        budget_epochs: Optional[float] = None,
        mode: str = "solve",
        warm: bool = True,
        background: bool = False,
        coupling_threshold: Optional[float] = None,
        correction: str = "none",
        correction_epochs: float = CORRECTION_EPOCHS,
        correction_damping: float = CORRECTION_DAMPING,
        generator: Optional[torch.Generator] = None,
        batch_idx=None,
    ):
        """Refine, then atomically swap the new artifact into ``engine``.

        ``engine`` is a `BucketedEngine` (or a `MultiModelServer` with
        ``name``); the refinement knobs pass through to :meth:`refine`.
        ``background=True`` runs refine + export + swap on a daemon thread
        (serving continues on the old artifact until the swap) and returns
        a `concurrent.futures.Future` of the `RefreshReport`, carrying the
        exception if the refresh raises. The thread launches on the
        device's default stream, as the engine's worker and the caller do,
        so the swapped-in artifact is fully written before any later
        dispatch reads it. Otherwise returns the report directly.
        """

        def _do():
            report = self.refine(budget_epochs=budget_epochs, mode=mode,
                                 warm=warm, generator=generator,
                                 coupling_threshold=coupling_threshold,
                                 correction=correction,
                                 correction_epochs=correction_epochs,
                                 correction_damping=correction_damping,
                                 batch_idx=batch_idx)
            model = self.export()
            if name is not None:
                engine.swap(name, model)
            else:
                engine.swap_model(model)
            return report

        if background:
            fut: Future = Future()

            def _run():
                try:
                    fut.set_result(_do())
                except Exception as e:  # the caller reads it from the Future
                    fut.set_exception(e)

            threading.Thread(target=_run, name="gp-refresh", daemon=True).start()
            return fut
        return _do()
