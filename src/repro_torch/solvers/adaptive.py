"""Adaptive per-step solver budgets calibrated from residual telemetry.

Port of ``repro.solvers.adaptive`` (the model and its constants are the
reference's; see its docstring and ``docs/adaptive.md``):

1. :func:`fit_decay` fits ``log res ~ intercept + slope * iter`` by
   weighted least squares directly on a solver's rotated residual ring
   (``SolverConfig.record_history``), and :func:`predict_epochs` turns the
   slope into epochs to a target residual.
2. :func:`noise_probe` scores the gradient estimate's noise from the same
   solves: the fit's RMS misfit and ``log(res_z / tolerance)``.
3. :class:`BudgetPolicy` is the controller's state, carried across outer
   steps; :func:`budget_allocate` picks a step's ``max_epochs`` before the
   solve and :func:`budget_observe` folds the solve's telemetry back in.
   The residual target is ``max(tolerance, margin * perturbation *
   anneal)`` and the allocation the predicted epochs to reach it, clipped
   to ``[floor, ceiling]``, capped by the pool and ``max_epochs``; until a
   fit is accepted the fixed budget ``min(ceiling, max_epochs)`` stands.

Every function is arithmetic on small tensors: scalar leaves for one fit,
(B,) leaves for lanes (a ring is then (B, H, 2)), so the policy stays on
the device and rides across rounds without a host read.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.solvers.base import SolverNumerics

# Smallest ring that supports a slope fit; `fit` refuses adaptive budgets
# below it.
MIN_RECORD_HISTORY = 2

# Slopes flatter than this (nats per epoch) count as no measurable decay:
# the controller falls back to the fixed budget.
SLOPE_EPS = 1e-4

# Sentinel horizon: `fit` resolves it to the run's `cfg.num_steps`.
AUTO_HORIZON = 0.0

# Factor by which a stalled step (the residual grew past its target)
# shrinks the assumed decay rate.
STALL_DECAY = 0.5

# Floor on residuals entering logs.
_RES_FLOOR = 1e-12


class DecayFit(NamedTuple):
    """Weighted least-squares fit of ``log res ~ intercept + slope * iter``
    (per lane for lane-stacked rings): slope in nats per ITERATION,
    intercept at iteration 0, RMS misfit, the number of valid ring entries,
    and the log combined residual at the earliest and latest entries (NaN
    for an empty ring)."""

    slope: torch.Tensor
    intercept: torch.Tensor
    rms: torch.Tensor
    n_pts: torch.Tensor
    log_first: torch.Tensor
    log_last: torch.Tensor


def _t(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def _combined(res_y: torch.Tensor, res_z: torch.Tensor) -> torch.Tensor:
    """The convergence-relevant residual: BOTH families must reach tau."""
    return torch.maximum(res_y, res_z)


def fit_decay(hist: torch.Tensor, iters: torch.Tensor) -> DecayFit:
    """Fit the log-linear decay model to a rotated residual ring.

    ``hist`` (..., H, 2): slot ``j % H`` holds the residuals after
    iteration ``j + 1``; ``iters`` (...) the solve's iteration count. Each
    slot's iteration is reconstructed from the count, and unfilled or NaN
    slots are masked out. ``n_pts < 2`` marks an unusable fit.
    """
    h = hist.shape[-2]
    n = torch.as_tensor(iters, device=hist.device).to(torch.int64)[..., None]
    j = torch.arange(h, device=hist.device)
    # Slot j holds iteration m = j + 1 + H * floor((n - 1 - j) / H), the
    # latest iteration <= n with (m - 1) mod H == j; m <= 0 is unwritten.
    m = j + 1 + h * torch.div(n - 1 - j, h, rounding_mode="floor")
    r = _combined(hist[..., 0], hist[..., 1]).to(torch.float32)
    logr = torch.log(torch.clamp_min(r, _RES_FLOOR))
    valid = (m >= 1) & (m <= n) & torch.isfinite(logr)
    w = valid.to(torch.float32)
    zero = torch.zeros_like(logr)
    ms = torch.where(valid, m.to(torch.float32), zero)
    ys = torch.where(valid, logr, zero)
    sw = torch.sum(w, dim=-1)
    swc = torch.clamp_min(sw, 1.0)
    mx = torch.sum(w * ms, dim=-1) / swc
    my = torch.sum(w * ys, dim=-1) / swc
    dx = torch.where(valid, ms - mx[..., None], zero)
    dy = torch.where(valid, ys - my[..., None], zero)
    sxx = torch.sum(w * dx * dx, dim=-1)
    sxy = torch.sum(w * dx * dy, dim=-1)
    slope = sxy / torch.clamp_min(sxx, 1e-20)
    slope = torch.where(sxx > 0, slope, torch.zeros_like(slope))
    resid = torch.where(valid, dy - slope[..., None] * dx, zero)
    rms = torch.sqrt(torch.sum(w * resid * resid, dim=-1) / swc)
    n = n[..., 0]
    first_slot = torch.where(n <= h, torch.zeros_like(n), torch.remainder(n, h))
    last_slot = torch.remainder(torch.clamp_min(n - 1, 0), h)
    empty = n < 1
    nan = torch.full_like(my, float("nan"))
    log_first = torch.where(empty, nan, torch.take_along_dim(
        logr, first_slot[..., None], dim=-1)[..., 0])
    log_last = torch.where(empty, nan, torch.take_along_dim(
        logr, last_slot[..., None], dim=-1)[..., 0])
    return DecayFit(slope=slope, intercept=my - slope * mx, rms=rms,
                    n_pts=sw, log_first=log_first, log_last=log_last)


def predict_epochs(fit: DecayFit, epochs_per_iter, log_from,
                   log_target) -> torch.Tensor:
    """Epochs to descend ``log_from -> log_target`` at the fitted rate;
    +inf when the fit shows no decay (slope >= -SLOPE_EPS per epoch)."""
    epi = _t(epochs_per_iter, fit.slope)
    rate = -fit.slope / torch.clamp_min(epi, 1e-12)
    need = torch.clamp_min(_t(log_from, rate) - _t(log_target, rate), 0.0)
    return torch.where(rate > SLOPE_EPS,
                       need / torch.clamp_min(rate, SLOPE_EPS),
                       torch.full_like(rate, float("inf")))


def noise_probe(fit: DecayFit, res_z, tolerance) -> tuple:
    """``(stochasticity, grad_noise)``: the decay fit's RMS misfit in nats,
    and ``log(res_z / tolerance)`` clipped at 0."""
    res_z, tol = _t(res_z, fit.rms), _t(tolerance, fit.rms)
    grad_noise = torch.clamp_min(
        torch.log(torch.clamp_min(res_z, _RES_FLOOR))
        - torch.log(torch.clamp_min(tol, _RES_FLOOR)), 0.0)
    return fit.rms, grad_noise


class BudgetPolicy(NamedTuple):
    """Adaptive-budget controller state and coefficients (the reference's
    leaves): ``pool``, ``slope`` (EMA, per epoch), ``noise``,
    ``perturbation``, ``last_res``, ``steps_seen`` and ``fits_seen``
    evolve; ``floor``, ``ceiling``, ``margin``, ``safety``, ``ema`` and
    ``horizon`` are the coefficients. Scalar leaves for one fit, (B,) for
    lanes."""

    pool: torch.Tensor
    slope: torch.Tensor
    noise: torch.Tensor
    perturbation: torch.Tensor
    last_res: torch.Tensor
    steps_seen: torch.Tensor
    fits_seen: torch.Tensor
    floor: torch.Tensor
    ceiling: torch.Tensor
    margin: torch.Tensor
    safety: torch.Tensor
    ema: torch.Tensor
    horizon: torch.Tensor

    def to(self, device) -> "BudgetPolicy":
        """The policy with every leaf on ``device``."""
        return BudgetPolicy(*(v.to(device) for v in self))


def make_budget_policy(pool: float = float("inf"), floor: float = 1.0,
                       ceiling: float = float("inf"), margin: float = 1.0,
                       safety: float = 1.5, ema: float = 0.7,
                       horizon: float = AUTO_HORIZON, dtype=torch.float32,
                       device=None) -> BudgetPolicy:
    """A fresh scalar-leaf :class:`BudgetPolicy` (the reference's
    arguments and defaults)."""
    def f(v):
        return torch.tensor(v, dtype=dtype, device=device)

    def i(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return BudgetPolicy(
        pool=f(pool), slope=f(0.0), noise=f(0.0), perturbation=f(0.0),
        last_res=f(float("inf")), steps_seen=i(0), fits_seen=i(0),
        floor=f(floor), ceiling=f(ceiling), margin=f(margin),
        safety=f(safety), ema=f(ema), horizon=f(horizon))


def broadcast_policy(policy: BudgetPolicy, lanes: int) -> BudgetPolicy:
    """Scalar policy leaves broadcast to (lanes,); stacked ones checked."""
    def one(v):
        v = torch.as_tensor(v)
        if v.ndim == 0:
            return v.expand(lanes).clone()
        if v.shape != (lanes,):
            raise ValueError(f"policy leaf shape {tuple(v.shape)} does not "
                             f"match lanes={lanes}")
        return v

    return BudgetPolicy(*map(one, policy))


def resolve_horizon(policy: BudgetPolicy, num_steps: int) -> BudgetPolicy:
    """Replace :data:`AUTO_HORIZON` leaves with the run's step count."""
    h = policy.horizon
    return policy._replace(horizon=torch.where(
        h == AUTO_HORIZON, torch.full_like(h, float(num_steps)), h))


def step_target(policy: BudgetPolicy, tolerance) -> torch.Tensor:
    """This step's annealed residual target: ``max(tolerance, margin *
    perturbation * anneal)``, the anneal ``1 - (steps_seen + 1) / horizon``
    clipped to [0, 1] (1 for a non-positive horizon)."""
    tol = torch.clamp_min(_t(tolerance, policy.margin), _RES_FLOOR)
    anneal = torch.where(
        policy.horizon > 0,
        torch.clamp(1.0 - (policy.steps_seen.to(torch.float32) + 1.0)
                    / torch.clamp_min(policy.horizon, 1.0), 0.0, 1.0),
        torch.ones_like(policy.horizon))
    return torch.maximum(tol, policy.margin * policy.perturbation * anneal)


def budget_allocate(policy: BudgetPolicy,
                    numerics: SolverNumerics) -> tuple:
    """This step's ``(alloc, pred_to_tol)``, decided before the solve: the
    clipped predicted epochs to this step's target, capped by the pool and
    ``numerics.max_epochs`` (the fixed budget ``min(ceiling, max_epochs)``
    until a fit is accepted or when the slope shows no decay), and the
    predicted epochs to the tolerance (NaN without a model)."""
    like = policy.slope
    tol = torch.clamp_min(_t(numerics.tolerance, like), _RES_FLOOR)
    max_epochs = _t(numerics.max_epochs, like)
    log_tol = torch.log(tol)
    rate = -policy.slope
    have_model = (policy.fits_seen >= 1) & (rate > SLOPE_EPS)
    res_in = torch.clamp_max(policy.last_res, 1.0) + policy.perturbation
    log_res_in = torch.log(torch.clamp_min(res_in, _RES_FLOOR))
    log_target = torch.log(step_target(policy, numerics.tolerance))
    need = torch.clamp_min(log_res_in - log_target, 0.0) + policy.noise
    safe_rate = torch.clamp_min(rate, SLOPE_EPS)
    alloc = torch.clamp(need / safe_rate * policy.safety, policy.floor,
                        policy.ceiling)
    fallback = torch.minimum(policy.ceiling, max_epochs)
    alloc = torch.where(have_model, alloc, fallback)
    alloc = torch.minimum(alloc, max_epochs)
    alloc = torch.minimum(alloc, torch.clamp_min(policy.pool, 0.0))
    pred = (torch.clamp_min(log_res_in - log_tol, 0.0) + policy.noise) \
        / safe_rate * policy.safety
    pred = torch.where(have_model, pred, torch.full_like(pred, float("nan")))
    return alloc, pred


def budget_observe(policy: BudgetPolicy, hist: torch.Tensor, iters, epochs,
                   res_y, res_z, tolerance) -> tuple:
    """Fold one solve's telemetry into the policy, after the solve: the
    decay fit on its ring, the slope per epoch through the solve's own
    ``epochs / iters``, the EMAs (each only on a valid observation; a
    first one seeds it), the stall rule, and the pool less the epochs
    spent. Returns ``(new_policy, decision)``, the decision holding the
    realised epochs, end residual, EMAs, gradient noise, pool and epochs
    per iteration."""
    like = policy.slope
    fit = fit_decay(hist, iters)
    iters = torch.as_tensor(iters, device=like.device)
    epochs, res_y, res_z = (_t(v, like) for v in (epochs, res_y, res_z))
    ran = iters >= 1
    itf = torch.clamp_min(iters.to(epochs.dtype), 1.0)
    epi = epochs / itf
    slope_epoch = fit.slope * itf / torch.clamp_min(epochs, 1e-12)
    ok_fit = ran & (fit.n_pts >= 2) & (slope_epoch < -SLOPE_EPS)

    def ema_update(prev, obs, ok, seeded):
        blended = policy.ema * prev + (1.0 - policy.ema) * obs
        return torch.where(ok, torch.where(seeded, blended, obs), prev)

    res_end = _combined(res_y, res_z)
    target = step_target(policy, tolerance)
    stalled = ran & torch.isfinite(policy.last_res) & (
        res_end > torch.maximum(1.5 * target, policy.last_res))
    stalled_slope = torch.where(stalled, policy.slope * STALL_DECAY,
                                policy.slope)
    fits_seeded = policy.fits_seen >= 1
    slope = torch.where(ok_fit, ema_update(policy.slope, slope_epoch, ok_fit,
                                           fits_seeded), stalled_slope)
    stoch, grad_noise = noise_probe(fit, res_z, tolerance)
    noise = ema_update(policy.noise, stoch, ok_fit, fits_seeded)
    res_first = torch.exp(fit.log_first)
    res_entry = torch.where(
        ok_fit, torch.maximum(torch.exp(fit.intercept), res_first), res_first)
    pert_obs = torch.clamp_min(res_entry - policy.last_res, 0.0)
    ok_pert = ran & (policy.steps_seen >= 1) & torch.isfinite(pert_obs)
    pert_seeded = policy.steps_seen >= 2
    perturbation = ema_update(policy.perturbation, pert_obs, ok_pert,
                              pert_seeded)
    new = policy._replace(
        pool=policy.pool - epochs, slope=slope, noise=noise,
        perturbation=perturbation, last_res=res_end,
        steps_seen=policy.steps_seen + 1,
        fits_seen=policy.fits_seen + ok_fit.to(torch.int32))
    decision = {"realised": epochs, "res": res_end, "slope": slope,
                "noise": noise, "perturbation": perturbation,
                "grad_noise": grad_noise, "pool": new.pool,
                "epochs_per_iter": epi}
    return new, decision
