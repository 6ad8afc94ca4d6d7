"""The fit loop with evaluation and checkpoints, the SGD learning-rate grid
and the large-dataset initialisation heuristic; port of the single-lane
part of ``repro.core.driver``.

Runs ``cfg.num_steps`` outer steps one at a time, keeps the per-step
history, evaluates on ``(x_test, y_test)`` every ``eval_every`` steps and
checkpoints every ``ckpt_every`` steps and at the end, with the reference's
restart semantics. The budget policy and lanes arrive with later slices.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import (
    latest_step,
    load_metadata,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.core.estimators import (
    PATHWISE,
    ProbeState,
    build_system_targets,
    init_probes,
)
from repro_torch.core.outer import (
    OuterConfig,
    OuterState,
    effective_kind,
    init_outer_state,
    outer_step,
)
from repro_torch.core.predict import pathwise_predict, predictive_metrics
from repro_torch.gp.exact import exact_mll
from repro_torch.gp.hyperparams import HyperParams
from repro_torch.solvers import HOperator, solve
from repro_torch.solvers.base import max_iters_from_epochs
from repro_torch.solvers.sgd import draw_schedule
from repro_torch.train.adam import AdamConfig, adam_init, adam_update

SGD_LR_GRID = [5.0, 10.0, 20.0, 30.0, 50.0, 60.0, 70.0, 80.0, 90.0, 100.0]

# Divergence cut-off of the SGD learning-rate grid (paper Appendix B: "the
# largest learning rate which does not cause divergence"). Systems are
# normalised to ||b~|| = 1, so a cold-started probe solve begins at relative
# residual ~1 per family; res_y + res_z above 2 + 2 after the probe epochs
# means both families grew past twice their start.
SGD_DIVERGENCE_THRESHOLD = 4.0

HISTORY_KEYS = ("res_y", "res_z", "iters", "epochs", "mvms", "host_syncs",
                "hypers", "grad_norm", "data_fit", "step_time_s")
EVAL_KEYS = ("eval_step", "eval_rmse", "eval_llh", "eval_mvms")


@dataclass
class FitResult:
    """What `fit` returns: final state + per-step history."""

    state: OuterState
    history: dict  # str -> np.ndarray over steps (eval_* over evaluations)
    wall_time_s: float


def _sync(x: torch.Tensor) -> None:
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def fit(
    x: torch.Tensor,
    y: torch.Tensor,
    cfg: OuterConfig,
    generator: Optional[torch.Generator] = None,
    init_params: Optional[HyperParams] = None,
    state: Optional[OuterState] = None,
    x_test: Optional[torch.Tensor] = None,
    y_test: Optional[torch.Tensor] = None,
    eval_every: int = 0,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    resume: bool = True,
    verbose: bool = False,
) -> FitResult:
    """Run ``cfg.num_steps`` outer MLL steps with optional eval/checkpoints.

    ``generator`` draws the probes of a fresh state, the fresh probes of
    every step without warm starting, SGD's batch schedules and the standard
    estimator's eval probes (a generator on ``x``'s device seeded with 0
    when None).
    ``state`` starts from a given state instead (e.g. the reference's
    initial state carried across by :mod:`repro_torch.interop`).

    Restart semantics (the reference's): if ``ckpt_dir`` holds a checkpoint
    and ``resume``, training continues from it, carry and probes included;
    the generator's state rides in the checkpoint's sidecar, so a resumed
    fit draws what an uninterrupted one would. Evaluation runs after every
    step that is a multiple of ``eval_every`` (when ``x_test`` is given),
    a checkpoint after every multiple of ``ckpt_every`` and one at the end.
    Each step's time is taken on the host after a device synchronise.
    """
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    if state is None:
        state = init_outer_state(cfg, x, init_params=init_params,
                                 generator=generator)
    if ckpt_dir and resume and latest_step(ckpt_dir) is not None:
        state, _ = restore_checkpoint(ckpt_dir, state)
        saved = load_metadata(ckpt_dir).get("generator")
        if saved is not None:
            generator.set_state(torch.tensor(saved, dtype=torch.uint8))

    def checkpoint(step: int) -> None:
        save_checkpoint(ckpt_dir, step, state,
                        metadata={"generator": generator.get_state().tolist()})

    history = {k: [] for k in HISTORY_KEYS + EVAL_KEYS}
    t0 = time.perf_counter()
    while state.step < cfg.num_steps:
        ts = time.perf_counter()
        state, metrics = outer_step(state, x, y, cfg, generator=generator)
        _sync(state.carry_v)
        metrics["step_time_s"] = time.perf_counter() - ts
        for k in HISTORY_KEYS:
            history[k].append(metrics[k])
        step = state.step
        if eval_every and x_test is not None and step % eval_every == 0:
            m = evaluate(x, state, cfg, x_test, y_test, generator=generator)
            for k, val in (("eval_step", step), ("eval_rmse", m["rmse"]),
                           ("eval_llh", m["llh"]), ("eval_mvms", m["mvms"])):
                history[k].append(val)
            if verbose:
                print(f"[fit] step {step}: rmse={m['rmse']:.4f} "
                      f"llh={m['llh']:.4f}", flush=True)
        if ckpt_dir and ckpt_every and step % ckpt_every == 0:
            checkpoint(step)
        if verbose:
            print(f"[fit] step {step}/{cfg.num_steps} "
                  f"res_y={metrics['res_y']:.4f} res_z={metrics['res_z']:.4f} "
                  f"iters={metrics['iters']} ({metrics['step_time_s']:.2f}s)",
                  flush=True)
    if ckpt_dir:
        checkpoint(cfg.num_steps)
    return FitResult(state=state,
                     history={k: np.asarray(v) for k, v in history.items()},
                     wall_time_s=time.perf_counter() - t0)


def pick_sgd_learning_rate(
    x: torch.Tensor,
    y: torch.Tensor,
    params: HyperParams,
    cfg: OuterConfig,
    generator: Optional[torch.Generator] = None,
    probes: Optional[ProbeState] = None,
    batch_idx: Optional[Sequence[int]] = None,
    grid=None,
    probe_epochs: float = 3.0,
    halve: bool = False,
    divergence_threshold: float = SGD_DIVERGENCE_THRESHOLD,
    trials: Optional[list] = None,
) -> float:
    """Paper protocol: the largest grid lr whose first-step solve does not
    diverge; ``halve=True`` returns half of it (the large-dataset rule).

    The grid is swept in ascending order; each lr solves the first step's
    system cold for ``probe_epochs`` epochs with the freeze on divergence
    off, and "diverged" reads the FINAL ``res_y + res_z``: non-finite or
    above ``divergence_threshold``. The sweep stops at the first lr that
    diverges. Every lr sees the same probes and the same batch schedule
    (the reference reuses one key): ``probes`` and ``batch_idx`` when
    given, else drawn from ``generator``. ``trials``, when given, receives
    ``(lr, SolveResult)`` for each solve run.
    """
    grid = sorted(grid or SGD_LR_GRID)
    n, d = x.shape
    kind = effective_kind(cfg, params)
    if probes is None:
        probes = init_probes(generator, cfg.estimator, n, d, cfg.num_probes,
                             cfg.num_rff_pairs, kind=kind, dtype=x.dtype,
                             device=x.device)
    base = replace(cfg.solver, name="sgd", max_epochs=probe_epochs, kind=kind,
                   divergence_threshold=float("inf"))
    if batch_idx is None:
        nb = n // base.batch_size
        batch_idx = draw_schedule(
            generator, nb, max_iters_from_epochs(probe_epochs, float(nb)))
    with torch.no_grad():
        targets = build_system_targets(probes, x, y, params)
        op = HOperator(x=x, params=params, kind=kind, backend=cfg.backend,
                       bm=cfg.bm, bn=cfg.bn)
        best = grid[0]
        for lr in grid:
            res = solve(op, targets, None, replace(base, learning_rate=lr),
                        batch_idx=batch_idx)
            if trials is not None:
                trials.append((lr, res))
            r = float(res.res_y) + float(res.res_z)
            if np.isfinite(r) and r < divergence_threshold:
                best = lr
            else:
                break
    return best / 2.0 if halve else best


def nearest_rows(x: torch.Tensor, i: int, size: int) -> torch.Tensor:
    """Indices of the ``size`` rows of ``x`` nearest row ``i`` by squared
    distance, nearest first; a stable sort, so ties keep row order (the
    reference's ``argsort(sum((x - x[i])**2, axis=1))[:size]``)."""
    dist = torch.sum((x - x[i]) ** 2, dim=1)
    return torch.argsort(dist, stable=True)[:size]


def init_hypers_heuristic(
    generator: Optional[torch.Generator],
    x: torch.Tensor,
    y: torch.Tensor,
    subset_size: int = 10_000,
    num_centroids: int = 10,
    num_steps: int = 30,
    adam_lr: float = 0.1,
    kind: str = "matern32",
    centroids: Optional[Sequence[int]] = None,
) -> HyperParams:
    """Large-dataset initialisation heuristic (paper Appendix B / Lin et al.).

    For each of ``num_centroids`` centroid rows: take its ``subset_size``
    nearest rows (:func:`nearest_rows`), start from the paper's initial
    hyperparameters and run ``num_steps`` Adam ascent steps on the EXACT
    subset MLL; return the mean of the results' raw leaves. The centroids
    are ``centroids`` when given (how a test hands over the reference's
    ``randint`` draws), else drawn uniformly from ``generator``. Runs on
    ``x``'s device.
    """
    n, d = x.shape
    subset_size = min(subset_size, n)
    if centroids is None:
        centroids = torch.randint(0, n, (num_centroids,), generator=generator,
                                  device=x.device).tolist()
    if len(centroids) != num_centroids:
        raise ValueError(f"{len(centroids)} centroids given, "
                         f"num_centroids={num_centroids}")
    cfg = AdamConfig(learning_rate=adam_lr)
    acc = None
    for i in centroids:
        idx = nearest_rows(x, i, subset_size)
        xc, yc = x[idx], y[idx]
        params = HyperParams.create(d, dtype=x.dtype, kernel=kind,
                                    device=x.device)
        adam = adam_init(params)
        for _ in range(num_steps):
            leaves = [p.detach().requires_grad_(True) for p in params.leaves]
            with torch.enable_grad():
                mll = exact_mll(xc, yc, params.with_leaves(leaves), kind=kind)
                grads = torch.autograd.grad(mll, leaves)
            with torch.no_grad():
                params, adam = adam_update(params.with_leaves(grads), adam,
                                           params, cfg, maximize=True)
        acc = params.leaves if acc is None else [
            a + p for a, p in zip(acc, params.leaves)]
    return params.with_leaves([a / num_centroids for a in acc])


def evaluate(
    x: torch.Tensor,
    state: OuterState,
    cfg: OuterConfig,
    x_test: torch.Tensor,
    y_test: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    eval_probes: Optional[ProbeState] = None,
    batch_idx: Optional[Sequence[int]] = None,
) -> dict:
    """Test RMSE / mean predictive LLH, and the H MVMs the eval solves took.

    Pathwise estimator: zero extra solves (eq. 16) from the current carry.
    Standard estimator: the s pathwise eval solves the paper charges to the
    standard path (Fig. 1), from zero, with eval probes drawn from
    ``generator`` unless given (``eval_probes``), and SGD's schedule from
    it unless given (``batch_idx``); ``v_y`` comes from the carry.
    """
    kind = effective_kind(cfg, state.params)
    with torch.no_grad():
        if cfg.estimator == PATHWISE:
            v, probes, mvms = state.carry_v, state.probes, 0
        else:
            n, d = x.shape
            if eval_probes is None:
                eval_probes = init_probes(
                    generator, PATHWISE, n, d, state.carry_v.shape[1] - 1,
                    cfg.num_rff_pairs, kind=kind, dtype=x.dtype,
                    device=x.device)
            targets = build_system_targets(
                eval_probes, x, torch.zeros((n,), dtype=x.dtype,
                                            device=x.device), state.params)
            op = HOperator(x=x, params=state.params, kind=kind,
                           backend=cfg.backend, bm=cfg.bm, bn=cfg.bn)
            scfg = (cfg.solver if cfg.solver.kind == kind
                    else replace(cfg.solver, kind=kind))
            res = solve(op, targets[:, 1:], None, scfg, batch_idx=batch_idx,
                        generator=generator)
            v = torch.cat([state.carry_v[:, :1], res.v], dim=1)
            probes, mvms = eval_probes, res.mvms
        pred = pathwise_predict(x, x_test, v, probes, state.params, kind=kind)
        m = predictive_metrics(y_test, pred, state.params)
    return {"rmse": float(m["rmse"]), "llh": float(m["llh"]), "mvms": mvms}
