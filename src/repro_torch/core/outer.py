"""The outer marginal-likelihood optimisation loop (paper Fig. 2, §2.1).

Port of ``repro.core.outer``. One outer step: build targets -> warm start
from the carry -> inner solve -> gradient assembly -> Adam ascent -> new
carry. Without warm starting, each step draws fresh probes (or takes them
as given) and solves from zero. SGD's batch schedule comes from the same
generator unless handed over.

Lanes: the step body runs on lane-stacked states (every tensor of the
state with a leading B axis, see :func:`stack_states`): B scenarios that
share the data and the static config (kernel, solver, shapes) and differ in
draws, initial hyperparameters and numeric solver settings advance in one
lane-stacked step, each lane as its own single run (the solvers' freeze
mask), with one launch of each kernel per solver iteration and one fused
backward per step for all lanes. One system is B = 1: :func:`outer_step`
lifts it. The reference's random keys are ``torch.Generator``\\s here, one
per lane, and every draw can be handed over instead.

:func:`outer_scan` is the reference's scan as a Python loop that keeps each
step's metrics on the device and stacks them, so a round of k steps reads
the host once. :func:`outer_step_budget` runs the adaptive budget
controller (:mod:`repro_torch.solvers.adaptive`) around the step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import lanes as lanes_mod
from repro_torch.core.estimators import (
    PATHWISE,
    ProbeState,
    build_system_targets,
    init_probes,
    resample_probes,
)
from repro_torch.core.gradients import mll_grad_estimate
from repro_torch.gp.hyperparams import HyperParams
from repro_torch.solvers import HOperator, SolverConfig, SolverNumerics, solve
from repro_torch.solvers.adaptive import (
    MIN_RECORD_HISTORY,
    BudgetPolicy,
    broadcast_policy,
    budget_allocate,
    budget_observe,
)
from repro_torch.solvers.base import lane_numerics, numerics_of
from repro_torch.train.adam import AdamConfig, AdamState, adam_init, adam_update


@dataclass(frozen=True)
class OuterConfig:
    """Configuration of the outer MLL loop (reference defaults)."""

    estimator: str = PATHWISE  # standard | pathwise
    warm_start: bool = True
    num_probes: int = 64
    num_rff_pairs: int = 1000
    kind: Optional[str] = None  # registered kernel; None => params.kernel
    solver: SolverConfig = field(default_factory=SolverConfig)
    adam: AdamConfig = field(default_factory=lambda: AdamConfig(learning_rate=0.1))
    num_steps: int = 100
    backend: str = "streamed"  # HOperator backend: dense | streamed | cuda
    bm: int = 1024
    bn: int = 1024


def effective_kind(cfg: OuterConfig, params: HyperParams) -> str:
    """Kernel precedence: OuterConfig.kind > SolverConfig.kind > params.kernel."""
    if cfg.kind is not None:
        return cfg.kind
    if cfg.solver.kind is not None:
        return cfg.solver.kind
    return params.kernel


class OuterState(NamedTuple):
    """Everything that evolves across outer steps (lane-stacked: a leading
    B axis on every tensor; ``step`` is shared)."""

    params: HyperParams
    adam: AdamState
    probes: ProbeState
    carry_v: torch.Tensor  # (n, 1+s) previous solutions (warm-start carry)
    step: int


def init_outer_state(
    cfg: OuterConfig,
    x: torch.Tensor,
    init_params: Optional[HyperParams] = None,
    generator: Optional[torch.Generator] = None,
    probes: Optional[ProbeState] = None,
) -> OuterState:
    """Fresh `OuterState`: hyperparameters, Adam, probes, zero carry.

    Probes are drawn from ``generator`` unless given (``probes=``), which is
    how a test hands over the reference's draws.
    """
    n, d = x.shape
    if init_params is not None:
        params = init_params
    else:
        params = HyperParams.create(
            d, kernel=cfg.kind or cfg.solver.kind or "matern32",
            dtype=x.dtype, device=x.device)
    if probes is None:
        probes = init_probes(
            generator, cfg.estimator, n, d, cfg.num_probes, cfg.num_rff_pairs,
            kind=effective_kind(cfg, params), dtype=x.dtype, device=x.device)
    carry = torch.zeros((n, 1 + cfg.num_probes), dtype=x.dtype, device=x.device)
    return OuterState(params=params, adam=adam_init(params), probes=probes,
                      carry_v=carry, step=0)


def stack_states(states: Sequence[OuterState]) -> OuterState:
    """Stack one-system states into one lane-stacked state (lane axis 0).
    They must share the static structure (kernel, estimator, shapes, step):
    that is what one lane-stacked program runs."""
    steps = {s.step for s in states}
    if len(steps) != 1:
        raise ValueError(f"lanes must be at one step, got {sorted(steps)}")
    return lanes_mod.stack(list(states))


def unstack_state(states: OuterState, lane: int) -> OuterState:
    """Lane ``lane`` of a lane-stacked state as one system's state."""
    return lanes_mod.lane(states, lane)


def num_lanes(states: OuterState) -> int:
    """Lane count of a lane-stacked state."""
    return states.carry_v.shape[0]


def init_outer_state_lanes(
    cfg: OuterConfig,
    x: torch.Tensor,
    generators: Sequence[torch.Generator],
    init_params: Optional[HyperParams] = None,
) -> OuterState:
    """B lanes at once: lane l is ``init_outer_state(cfg, x, init_params=
    <lane l's or the shared params>, generator=generators[l])``."""
    def params_of(l):
        if init_params is None or init_params.lanes is None:
            return init_params
        return init_params.lane(l)

    return stack_states([init_outer_state(cfg, x, init_params=params_of(l),
                                          generator=g)
                         for l, g in enumerate(generators)])


# Geometric capacity growth for sequential appends: capacities on the ladder
# factor^j * base keep the number of distinct system shapes O(log N) over N
# appended rows.
GROWTH_FACTOR = 2.0
MIN_CAPACITY = 16


def grow_capacity(current: int, needed: int, factor: float = GROWTH_FACTOR,
                  minimum: int = MIN_CAPACITY) -> int:
    """The smallest capacity ``>= needed`` on the geometric ladder
    ``max(current, minimum) * factor^j`` (j >= 0)."""
    if factor <= 1.0:
        raise ValueError(f"growth factor must be > 1, got {factor}")
    cap = max(int(current), int(minimum))
    needed = int(needed)
    while cap < needed:
        cap = max(cap + 1, int(math.ceil(cap * factor)))
    return cap


def extend_state(state: OuterState, num_new: int, dtype=None,
                 generator=None, rows: Optional[torch.Tensor] = None
                 ) -> OuterState:
    """Extend the warm-start carry for ``num_new`` appended observations.

    The carry gains ``num_new`` zero rows (the old solutions, zero-padded,
    warm-start the enlarged system), and the pathwise ``w_eps`` (standard
    ``z``) gains ``num_new`` N(0, 1) rows, drawn once and then fixed: from
    ``generator`` (one per lane for a lane-stacked state) or handed over as
    ``rows`` ((num_new, s), or (B, num_new, s) for lanes). The RFF base
    draws are function-space and need no extension.
    """
    if num_new <= 0:
        return state
    carry = state.carry_v
    dtype = dtype if dtype is not None else carry.dtype
    probes = state.probes
    name = "w_eps" if probes.estimator == PATHWISE else "z"
    base = getattr(probes, name)
    lead = carry.shape[:-2]
    s = base.shape[-1]
    if rows is None:
        gens = (list(generator) if isinstance(generator, (list, tuple))
                else [generator])
        drawn = [torch.randn((num_new, s), generator=g, dtype=dtype,
                             device=carry.device) for g in gens]
        rows = torch.stack(drawn) if lead else drawn[0]
    rows = rows.to(dtype=dtype, device=carry.device)
    pad = torch.zeros((*lead, num_new, carry.shape[-1]), dtype=dtype,
                      device=carry.device)
    return state._replace(
        carry_v=torch.cat([carry, pad], dim=-2),
        probes=probes._replace(**{name: torch.cat([base, rows], dim=-2)}))


def _generators(generators, lanes: int) -> list:
    if isinstance(generators, (list, tuple)):
        if len(generators) != lanes:
            raise ValueError(f"{len(generators)} generators for {lanes} lanes")
        return list(generators)
    return [generators] * lanes


def _outer_step_lanes(states: OuterState, x: torch.Tensor, y: torch.Tensor,
                      cfg: OuterConfig,
                      numerics: Optional[SolverNumerics] = None,
                      generators=None, probes: Optional[ProbeState] = None,
                      batch_idx=None) -> tuple[OuterState, dict]:
    """One outer step of lane-stacked ``states``; metrics as device tensors
    with a leading lane axis (``step``, ``mvms`` and ``host_syncs`` are the
    lane-stacked step's ints)."""
    lanes = num_lanes(states)
    gens = _generators(generators, lanes)
    kind = effective_kind(cfg, states.params)
    if cfg.warm_start:
        probes, v0 = states.probes, states.carry_v
    else:
        if probes is None:
            probes = lanes_mod.stack([
                resample_probes(g, lanes_mod.lane(states.probes, l), x)
                for l, g in enumerate(gens)])
        v0 = None
    with torch.no_grad():
        targets = build_system_targets(probes, x, y, states.params)
        op = HOperator(x=x, params=states.params, kind=kind,
                       backend=cfg.backend, bm=cfg.bm, bn=cfg.bn)
        scfg = (cfg.solver if cfg.solver.kind == kind
                else replace(cfg.solver, kind=kind))
        res = solve(op, targets, v0, scfg, batch_idx=batch_idx,
                    generator=gens, numerics=numerics)

    grads, aux = mll_grad_estimate(
        x, y, states.params, res.v, targets, cfg.estimator,
        kind=kind, bm=cfg.bm, bn=cfg.bn, backend=cfg.backend,
    )
    with torch.no_grad():
        new_params, new_adam = adam_update(
            grads, states.adam, states.params, cfg.adam, maximize=True)
        grad_norm = torch.sqrt(sum(
            torch.sum(g**2, dim=tuple(range(1, g.ndim))) for g in grads.leaves))
    new_states = OuterState(
        params=new_params, adam=new_adam, probes=probes,
        carry_v=res.v, step=states.step + 1,
    )
    metrics = {
        "step": states.step,
        "res_y": res.res_y,
        "res_z": res.res_z,
        "iters": res.iters,
        "epochs": res.epochs,
        "mvms": res.mvms,
        "host_syncs": res.host_syncs,
        "data_fit": aux.data_fit.detach(),
        "hypers": new_params.flat().detach(),
        "grad_norm": grad_norm,
    }
    if res.res_history is not None:
        metrics["res_history"] = res.res_history
    return new_states, metrics


def outer_step_lanes(states: OuterState, x: torch.Tensor, y: torch.Tensor,
                     cfg: OuterConfig,
                     numerics: Optional[SolverNumerics] = None,
                     generators=None, probes: Optional[ProbeState] = None,
                     batch_idx=None) -> tuple[OuterState, dict]:
    """One outer MLL step for B lane-stacked scenarios in one lane-stacked
    step. ``(x, y)`` and ``cfg`` are shared; ``numerics`` (scalar or (B,)
    leaves) gives each lane its own tolerance, budget and learning rate.
    ``generators`` (one per lane, or one shared) draw the fresh probes of a
    cold start and SGD's schedules unless ``probes`` (lane-stacked) or
    ``batch_idx`` ((B, iters)) hand them over. Returns the new states and
    the metrics as device tensors with a leading lane axis; each lane
    advances as :func:`outer_step` would advance it alone."""
    return _outer_step_lanes(states, x, y, cfg, numerics, generators, probes,
                             batch_idx)


def _host_metrics(metrics: dict) -> dict:
    """Device metrics as host numbers (one read per tensor): how a round
    of steps reads the host once."""
    out = {}
    for k, v in metrics.items():
        # torch-lint: disable=trace-host-sync -- one copy per metric tensor, once per round of steps
        out[k] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
    return out


def _single(metrics: dict) -> dict:
    """Lane 0 of lane-stacked host metrics, as one run's: ints and floats,
    the hyperparameters (and the ring) as arrays."""
    out = {}
    for k, v in metrics.items():
        if isinstance(v, np.ndarray):
            v = v[0]
            if v.ndim == 0:
                v = int(v) if np.issubdtype(v.dtype, np.integer) else float(v)
        out[k] = v
    return out


def _lift(state: OuterState, probes, batch_idx):
    return (stack_states([state]),
            None if probes is None else lanes_mod.stack([probes]),
            None if batch_idx is None else [batch_idx])


def outer_step(state: OuterState, x: torch.Tensor, y: torch.Tensor,
               cfg: OuterConfig, generator: Optional[torch.Generator] = None,
               probes: Optional[ProbeState] = None,
               batch_idx: Optional[Sequence[int]] = None,
               numerics: Optional[SolverNumerics] = None
               ) -> tuple[OuterState, dict]:
    """One outer MLL step: solve -> gradient -> Adam -> carry.

    With ``cfg.warm_start`` the probes of ``state`` are kept and the solve
    starts from the carry. Without it the step solves from zero with fresh
    probes: ``probes`` when given (how a test hands over the reference's
    per-step draws), else drawn from ``generator``. SGD's block schedule is
    ``batch_idx`` when given (the reference's ``ksolve`` draws), else drawn
    from ``generator`` after the probes. ``numerics`` overrides the solver
    config's numeric settings. The step is the lane-stacked one at B = 1;
    its metrics are read to the host.
    """
    states, probes, batch_idx = _lift(state, probes, batch_idx)
    states, metrics = _outer_step_lanes(states, x, y, cfg, numerics,
                                        [generator], probes, batch_idx)
    return unstack_state(states, 0), _single(_host_metrics(metrics))


def _require_history(cfg: OuterConfig) -> None:
    """Adaptive budgets need the solver residual ring (the decay model is
    fitted to it): raise below :data:`MIN_RECORD_HISTORY` recorded points."""
    if cfg.solver.record_history < MIN_RECORD_HISTORY:
        raise ValueError(
            "adaptive budgets (budget_policy=) require solver residual "
            f"telemetry: set SolverConfig.record_history >= "
            f"{MIN_RECORD_HISTORY} (got {cfg.solver.record_history}); the "
            "decay estimator fits its model to SolveResult.res_history")


def _outer_step_budget_lanes(states: OuterState, policy: BudgetPolicy,
                             x: torch.Tensor, y: torch.Tensor,
                             cfg: OuterConfig,
                             numerics: Optional[SolverNumerics] = None,
                             generators=None, batch_idx=None, probes=None
                             ) -> tuple[OuterState, BudgetPolicy, dict]:
    _require_history(cfg)
    lanes = num_lanes(states)
    num = lane_numerics(numerics if numerics is not None
                        else numerics_of(cfg.solver), lanes, x.device)
    policy = policy.to(x.device)
    alloc, pred = budget_allocate(policy, num)
    states, metrics = _outer_step_lanes(
        states, x, y, cfg, num._replace(max_epochs=alloc), generators,
        probes=probes, batch_idx=batch_idx)
    policy, decision = budget_observe(
        policy, metrics["res_history"], metrics["iters"], metrics["epochs"],
        metrics["res_y"], metrics["res_z"], num.tolerance)
    metrics["budget_alloc"] = alloc
    metrics["budget_pred_to_tol"] = pred
    for name, val in decision.items():
        metrics[f"budget_{name}"] = val
    return states, policy, metrics


def outer_step_budget_lanes(states: OuterState, policy: BudgetPolicy,
                            x: torch.Tensor, y: torch.Tensor,
                            cfg: OuterConfig,
                            numerics: Optional[SolverNumerics] = None,
                            generators=None
                            ) -> tuple[OuterState, BudgetPolicy, dict]:
    """One lane-stacked outer step under the adaptive budget controller:
    allocate (each lane from its own (B,) policy leaves) -> solve with
    ``max_epochs`` the allocation -> observe the residual rings. The
    metrics gain the ``budget_*`` family (``budget_alloc``,
    ``budget_pred_to_tol`` and the decision's fields), as device tensors."""
    return _outer_step_budget_lanes(states, policy, x, y, cfg, numerics,
                                    generators)


def outer_step_budget(state: OuterState, policy: BudgetPolicy,
                      x: torch.Tensor, y: torch.Tensor, cfg: OuterConfig,
                      numerics: Optional[SolverNumerics] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> tuple[OuterState, BudgetPolicy, dict]:
    """:func:`outer_step_budget_lanes` for one system (B = 1), with a
    scalar-leaf policy; its metrics are read to the host."""
    states, policy, metrics = _outer_step_budget_lanes(
        stack_states([state]), broadcast_policy(policy, 1), x, y, cfg,
        numerics, [generator])
    return (unstack_state(states, 0), lanes_mod.lane(policy, 0),
            _single(_host_metrics(metrics)))


def outer_scan(state: OuterState, x: torch.Tensor, y: torch.Tensor,
               cfg: OuterConfig, num_steps: int, lanes: bool = False,
               numerics: Optional[SolverNumerics] = None,
               budget: Optional[BudgetPolicy] = None, generators=None,
               batch_idx=None, probes=None):
    """Run ``num_steps`` outer steps, keeping each step's metrics on the
    device and stacking them: a leading ``num_steps`` axis (then the lane
    axis when ``lanes``), read by the caller once per round.

    The steps are those of :func:`outer_step` (or of
    :func:`outer_step_lanes` on a lane-stacked ``state`` when ``lanes``),
    so a loop of single steps gives the same trajectory. ``budget`` (a
    :class:`BudgetPolicy`, lane-stacked when ``lanes``) runs the budget
    controller in every step and returns ``((state, policy), metrics)``;
    pass the returned policy into the next round. ``generators``: one
    generator, or one per lane. ``batch_idx``, when given, hands over
    SGD's block schedule of each step (step i's ``batch_idx[i]``: (B,
    iters) when ``lanes``, else (iters,)) in place of draws, and
    ``probes`` the fresh probes of each step without warm starting (step
    i's ``probes[i]``, lane-stacked when ``lanes``).
    """
    states = state if lanes else stack_states([state])
    policy = budget
    if policy is not None and not lanes:
        policy = broadcast_policy(policy, 1)
    gens = generators if lanes else [generators]
    per_step = []
    for i in range(num_steps):
        sched = None if batch_idx is None else batch_idx[i]
        fresh = None if probes is None else probes[i]
        if not lanes:
            sched = None if sched is None else [sched]
            fresh = None if fresh is None else lanes_mod.stack([fresh])
        if policy is None:
            states, m = _outer_step_lanes(states, x, y, cfg, numerics, gens,
                                          probes=fresh, batch_idx=sched)
        else:
            states, policy, m = _outer_step_budget_lanes(
                states, policy, x, y, cfg, numerics, gens, batch_idx=sched,
                probes=fresh)
        per_step.append(m)
    metrics = {}
    for k in (per_step[0] if per_step else {}):
        vals = [m[k] for m in per_step]
        metrics[k] = (torch.stack(vals) if isinstance(vals[0], torch.Tensor)
                      else torch.tensor(vals))
        if not lanes and metrics[k].ndim > 1:
            metrics[k] = metrics[k][:, 0]
    if not lanes:
        states = unstack_state(states, 0)
        if policy is not None:
            policy = lanes_mod.lane(policy, 0)
    if budget is None:
        return states, metrics
    return (states, policy), metrics


def exact_outer_step(params: HyperParams, adam: AdamState, x: torch.Tensor,
                     y: torch.Tensor, adam_cfg: AdamConfig,
                     kind: Optional[str] = None):
    """Reference: one Adam step on the EXACT Cholesky MLL gradient (the
    paper's exact-optimisation trajectories). Returns ``(new_params,
    new_adam, mll)``."""
    from repro_torch.gp.exact import exact_mll_grad

    mll, grads = exact_mll_grad(x, y, params, kind=kind)
    with torch.no_grad():
        new_params, new_adam = adam_update(grads, adam, params, adam_cfg,
                                           maximize=True)
    return new_params, new_adam, mll
