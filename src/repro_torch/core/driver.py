"""The fit loop (fragment of ``repro.core.driver``).

Runs ``cfg.num_steps`` outer steps one at a time and keeps the per-step
history. Checkpoints, the budget policy and the eval cadence arrive with
the training slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.outer import (
    OuterConfig,
    OuterState,
    init_outer_state,
    outer_step,
)
from repro_torch.gp.hyperparams import HyperParams

HISTORY_KEYS = ("res_y", "res_z", "iters", "epochs", "mvms", "host_syncs",
                "hypers", "grad_norm", "data_fit", "step_time_s")


@dataclass
class FitResult:
    """What `fit` returns: final state + per-step history."""

    state: OuterState
    history: dict  # str -> np.ndarray over steps
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
    verbose: bool = False,
) -> FitResult:
    """Run ``cfg.num_steps`` outer MLL steps from ``state`` (or a fresh one).

    ``generator`` draws the probes of a fresh state; ``state`` resumes from
    a given one (e.g. the reference's initial state carried across by
    :mod:`repro_torch.interop`). Each step's time is taken on the host
    after a device synchronise.
    """
    if state is None:
        state = init_outer_state(cfg, x, init_params=init_params,
                                 generator=generator)
    history = {k: [] for k in HISTORY_KEYS}
    t0 = time.perf_counter()
    while state.step < cfg.num_steps:
        ts = time.perf_counter()
        state, metrics = outer_step(state, x, y, cfg)
        _sync(state.carry_v)
        metrics["step_time_s"] = time.perf_counter() - ts
        for k in HISTORY_KEYS:
            history[k].append(metrics[k])
        if verbose:
            print(f"[fit] step {state.step}/{cfg.num_steps} "
                  f"res_y={metrics['res_y']:.4f} res_z={metrics['res_z']:.4f} "
                  f"iters={metrics['iters']} ({metrics['step_time_s']:.2f}s)",
                  flush=True)
    return FitResult(state=state,
                     history={k: np.asarray(v) for k, v in history.items()},
                     wall_time_s=time.perf_counter() - t0)
