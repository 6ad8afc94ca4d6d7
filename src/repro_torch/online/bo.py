"""Sequential BO loop: acquire -> observe -> append -> refresh -> predict;
port of ``repro.online.bo``.

One round: (1) take a fixed-size candidate set, (2) predict through the
bucketed serving engine (one launch of the forward kernel on the card),
(3) pick the acquisition argmax (:func:`acquisition_argmax`), (4) evaluate
the objective there, (5) `OnlineGP.append` the observation, (6) refresh
with the configured mode (block / auto-escalate / full solve) and swap the
new artifact into the engine. Every moving part keeps its shape: the
candidate set is one engine bucket and the training arrays sit on the
geometric capacity ladder (``growth="geometric"`` + ``reserve=rounds``).

The loop accumulates solver epochs round by round, counts escalations
and damped corrections, and tracks simple regret, so a warm run and the
cold-re-solve baseline (``BOConfig(warm=False)``) compare directly.

Draws: the reference draws each round's candidates from ``fold_in(key,
r)``; here they come from ``generator=``, or are handed over as
``candidates=`` (a callable ``r -> (C, d)`` or a (rounds, C, d) tensor).
There is no executable cache, so ``engine_retraces`` and
``solve_compiles`` are None ("accounting unavailable").
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.estimators import PATHWISE
from repro_torch.core.outer import OuterConfig, OuterState
from repro_torch.device import resolve_device
from repro_torch.online.acquisition import ACQUISITIONS, acquisition_argmax
from repro_torch.serve.engine import BucketedEngine
from repro_torch.serve.refresh import (
    CORRECTION_DAMPING,
    CORRECTION_EPOCHS,
    GROWTH_GEOMETRIC,
    OnlineGP,
)


@dataclass(frozen=True)
class BOConfig:
    """Knobs of the sequential loop (the reference's fields and defaults).

    ``warm=True`` refreshes via ``refresh_mode`` (default ``"auto"``: block
    refresh with the damped old-row correction, escalating to a warm full
    solve only when the corrected residual stays above threshold).
    ``warm=False`` is the cold-re-solve control: every refresh is a full
    ``mode="solve"`` from zero.
    """

    rounds: int = 200  # acquisition rounds (one append each)
    num_candidates: int = 512  # fixed candidate-set size (= engine bucket)
    acquisition: str = "ucb"  # "ucb" | "ei"
    beta: float = 2.0  # UCB exploration weight
    xi: float = 0.01  # EI exploration margin
    warm: bool = True  # False => cold full re-solve baseline
    refresh_mode: str = "auto"  # refine mode when warm (block|auto|solve)
    correction: str = "damped"  # old-row correction for block/auto
    correction_epochs: float = CORRECTION_EPOCHS
    correction_damping: float = CORRECTION_DAMPING
    budget_epochs: Optional[float] = None  # per-refresh cap; None = tolerance
    refresh_every: int = 1  # refresh after every k-th append
    seed: int = 0  # seed of the candidate generator when none is given


class BOResult(NamedTuple):
    """What one BO run gives: per-round dicts and run-level rollups."""

    history: list  # per-round dicts (JSON-serialisable)
    best_y: float  # incumbent objective value after the last round
    regret: Optional[float]  # f_opt - best_y, when f_opt was given
    cum_epochs: float  # solver epochs over all refreshes (full-system units)
    escalations: int  # auto-mode refreshes that fell back to a full solve
    corrections: int  # refreshes that ran the damped old-row correction
    rounds_per_sec: float  # wall-clock throughput of the whole loop
    engine_retraces: Optional[int]  # None: no executable cache to count
    solve_compiles: Optional[int]  # None: no executable cache to count
    refresh_stats: dict  # OnlineGP.stats_dict() snapshot at the end


def make_gaussian_bumps(
    d: int,
    num_bumps: int = 4,
    bounds: tuple = (-1.0, 1.0),
    width: float = 0.35,
    generator: Optional[torch.Generator] = None,
    centers: Optional[torch.Tensor] = None,
    amps: Optional[torch.Tensor] = None,
    device=None,
) -> tuple[Callable[[torch.Tensor], torch.Tensor], float]:
    """A smooth multi-modal test objective: a sum of Gaussian bumps.

    Centres are drawn uniformly in ``bounds`` and amplitudes in [0.5, 1.5]
    from ``generator``, unless handed over (``centers`` (num_bumps, d),
    ``amps`` (num_bumps,)). The objective lives on ``device``; left unset,
    that is the handed-over centres' device, else the generator's, else the
    card. Returns ``(objective, f_opt)``: a vectorised callable mapping
    (m, d) inputs on that device to (m,) values (an input on another device
    raises), and the objective at the best bump centre (a lower bound on
    the optimum, so regret can go marginally negative).
    """
    if device is None:
        if isinstance(centers, torch.Tensor):
            device = centers.device
        elif generator is not None:
            device = generator.device
        else:
            device = "cuda"
    device = resolve_device(device)
    lo, hi = bounds
    if centers is None:
        centers = lo + (hi - lo) * torch.rand((num_bumps, d),
                                              generator=generator,
                                              device=device)
    if amps is None:
        amps = 0.5 + torch.rand((num_bumps,), generator=generator,
                                device=device)
    centers = torch.as_tensor(centers, dtype=torch.float32, device=device)
    amps = torch.as_tensor(amps, dtype=torch.float32, device=device)

    def objective(x: torch.Tensor) -> torch.Tensor:
        x = torch.atleast_2d(x)
        if x.device != centers.device:
            raise ValueError(f"objective input on device {x.device}, its bumps on "
                             f"{centers.device}")
        sq = torch.sum((x[:, None, :] - centers[None]) ** 2, dim=-1)
        return torch.sum(amps * torch.exp(-sq / (2.0 * width**2)), dim=-1)

    f_opt = float(torch.max(objective(centers)))
    return objective, f_opt


def run_bo(
    objective: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    y0: torch.Tensor,
    state: OuterState,
    cfg: OuterConfig,
    bo: BOConfig = BOConfig(),
    bounds: tuple = (-1.0, 1.0),
    f_opt: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    candidates=None,
    reserve_rows: Optional[torch.Tensor] = None,
) -> BOResult:
    """Run the sequential loop for ``bo.rounds`` rounds.

    Args:
      objective: vectorised black box mapping (m, d) inputs to (m,) values
        (maximisation convention).
      x0: (n0, d) initial training inputs (the fitted model's data).
      y0: (n0,) initial training targets.
      state: the fitted `OuterState` (pathwise estimator required — the
        engine's variance comes from the pathwise sample paths).
      cfg: the `OuterConfig` the state was fitted under.
      bo: loop configuration (:class:`BOConfig`).
      bounds: (lo, hi) box candidates are drawn uniformly from.
      f_opt: known optimum for regret tracking (optional).
      generator: draws the candidates (a generator on ``x0``'s device
        seeded with ``bo.seed`` when None) and the reserve's base noise.
      candidates: each round's candidates handed over instead: a callable
        ``r -> (num_candidates, d)`` or a (rounds, num_candidates, d)
        tensor.
      reserve_rows: the base-noise rows of the up-front capacity reserve,
        handed over (see `OnlineGP`).
    Returns:
      :class:`BOResult`.
    """
    if cfg.estimator != PATHWISE:
        raise ValueError(
            "run_bo needs a pathwise-fitted state (the serving engine's "
            f"variance comes from pathwise samples); got {cfg.estimator!r}")
    if bo.acquisition not in ACQUISITIONS:
        raise ValueError(
            f"unknown acquisition {bo.acquisition!r}; "
            f"have {sorted(ACQUISITIONS)}")
    if bo.refresh_every < 1:
        raise ValueError(f"refresh_every must be >= 1, got {bo.refresh_every}")
    device = x0.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(bo.seed)
    d = x0.shape[1]
    lo, hi = bounds

    def cands_of(r: int) -> torch.Tensor:
        if candidates is None:
            return lo + (hi - lo) * torch.rand(
                (bo.num_candidates, d), generator=generator,
                dtype=x0.dtype, device=device)
        c = candidates(r) if callable(candidates) else candidates[r]
        return torch.as_tensor(c, dtype=x0.dtype, device=device)

    # Capacity for every future append is reserved up front: the exported
    # artifact keeps ONE shape for the whole run.
    online = OnlineGP(x0, y0, state, cfg, growth=GROWTH_GEOMETRIC,
                      reserve=bo.rounds, generator=generator,
                      reserve_rows=reserve_rows)
    engine = BucketedEngine(online.export(), buckets=(bo.num_candidates,))
    engine.warmup()

    # Cold baseline = full re-solve from zero; the warm path uses the
    # configured incremental mode.
    mode = bo.refresh_mode if bo.warm else "solve"
    best_y = float(torch.max(y0))
    history: list = []
    t0 = time.perf_counter()
    for r in range(bo.rounds):
        cands = cands_of(r)
        pred = engine.submit(cands)
        idx, score = acquisition_argmax(
            pred.mean, pred.var, name=bo.acquisition, best=best_y,
            beta=bo.beta, xi=bo.xi)
        # torch-lint: disable=trace-host-sync -- the acquisition's argmax picks the next input on the host: one read a BO round
        i = int(idx)
        x_sel = cands[i]
        # torch-lint: disable=trace-host-sync -- the observed value goes into the round's record: one read a BO round
        y_obs = float(objective(x_sel[None, :])[0])
        online.append(x_sel[None, :],
                      torch.tensor([y_obs], dtype=y0.dtype, device=device))
        # torch-lint: disable=trace-host-sync -- the acquisition score goes into the round's record: one read a BO round
        entry = {"round": r, "y": y_obs, "score": float(score),
                 "acquisition": bo.acquisition, "index": i}
        if (r + 1) % bo.refresh_every == 0:
            report = online.refresh_into(
                engine, budget_epochs=bo.budget_epochs, mode=mode,
                warm=bo.warm,
                correction=bo.correction if bo.warm else "none",
                correction_epochs=bo.correction_epochs,
                correction_damping=bo.correction_damping,
                generator=generator)
            entry.update({
                "mode": report.mode, "epochs": report.epochs,
                "res_y": report.res_y, "res_z": report.res_z,
                "escalated": report.escalated,
                "corrected": report.corrected, "mvms": report.mvms,
            })
        best_y = max(best_y, y_obs)
        entry["best_y"] = best_y
        if f_opt is not None:
            entry["regret"] = f_opt - best_y
        history.append(entry)
    elapsed = time.perf_counter() - t0

    stats = online.stats_dict()
    return BOResult(
        history=history,
        best_y=best_y,
        regret=None if f_opt is None else f_opt - best_y,
        cum_epochs=float(stats["cum_epochs"]),
        escalations=int(stats["escalations"]),
        corrections=int(stats["corrections"]),
        rounds_per_sec=bo.rounds / max(elapsed, 1e-9),
        engine_retraces=None,
        solve_compiles=stats["num_solve_compiles"],
        refresh_stats=stats,
    )
