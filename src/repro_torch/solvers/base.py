"""Shared solver types: config, result, normalisation, budget accounting.

Port of ``repro.solvers.base``. One solver epoch is every entry of H
computed once: CG's iteration is one epoch, an AP or SGD iteration with
block (batch) size b touches an (n x b) slab, b/n of an epoch, so
``max_iters = (n / b) * max_epochs``. Each system ``H u = b`` is solved
normalised, ``b~ = b / (||b|| + eps)``, and rescaled afterwards
(Appendix B). Termination: BOTH the mean-system residual norm and the probe
average must reach the tolerance; SGD also stops on divergence
(:func:`lane_diverged`).

The solvers run their loops on the host and read the stopping rule once
per iteration, so no iteration runs after the rule says stop. The
reference's per-lane freeze mask (``lane_active``/``freeze``) and its
traced ``SolverNumerics`` serve lane batching, where a loop runs on past
a converged lane; they arrive with the lanes slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

NORM_EPS = 1e-10

# Iteration cap for epoch budgets (the reference's int32-safe cap).
MAX_SOLVER_ITERS = 2**30

# "No epoch budget: run to tolerance" for ``max_epochs``; the iteration cap
# clamps it to MAX_SOLVER_ITERS.
NO_EPOCH_BUDGET = float("inf")


@dataclass(frozen=True)
class SolverConfig:
    """Solver configuration (the reference's fields and defaults)."""

    name: str = "cg"  # cg | ap | sgd
    tolerance: float = 0.01
    kind: Optional[str] = None
    max_epochs: float = 1e9
    # CG: pivoted-Cholesky rank; 0 disables, AUTO_RANK (-1) picks per kernel.
    precond_rank: int = 100
    # AP
    block_size: int = 1000
    # SGD
    batch_size: int = 500
    learning_rate: float = 30.0
    momentum: float = 0.9
    # SGD stops once res_y + res_z exceeds this or goes non-finite.
    divergence_threshold: float = float("inf")
    exact_final_residual: bool = False  # SGD: one more full MVM to report
    # Keep the last ``record_history`` per-iteration (res_y, res_z) pairs in
    # a ring (SolveResult.res_history); 0 records nothing.
    record_history: int = 0


def max_iters_from_epochs(max_epochs: float, iters_per_epoch: float) -> int:
    """Iteration cap ``iters_per_epoch * max_epochs``, clamped like the
    reference (float32 product, capped at :data:`MAX_SOLVER_ITERS`)."""
    cap = torch.tensor(iters_per_epoch, dtype=torch.float32) * torch.tensor(
        max_epochs, dtype=torch.float32)
    return int(torch.clamp_max(cap, float(MAX_SOLVER_ITERS)).item())


class SolveResult(NamedTuple):
    """What every solver returns: solutions + residuals + budget spent."""

    v: torch.Tensor  # (n, t) solutions [v_y | v_1 .. v_s]
    res_y: torch.Tensor  # final relative residual of the mean system
    res_z: torch.Tensor  # mean relative residual over probe systems
    iters: int  # inner iterations executed
    epochs: float  # solver epochs consumed (budget units)
    mvms: int = 0  # full H @ V products (CG: iters + 1; AP: 1; SGD: 0 or 1)
    host_syncs: int = 0  # device -> host reads of the stopping rule
    # (H, 2) ring of [res_y, res_z] after each iteration when
    # SolverConfig.record_history = H > 0, else None. Slot ``j % H`` holds
    # the residuals after iteration ``j + 1``; unfilled slots are NaN
    # (:func:`unroll_history` restores time order).
    res_history: Optional[torch.Tensor] = None


def history_init(cfg: SolverConfig, dtype=torch.float32,
                 device=None) -> Optional[torch.Tensor]:
    """Fresh NaN-filled ``(record_history, 2)`` ring, or None when off."""
    if cfg.record_history <= 0:
        return None
    return torch.full((cfg.record_history, 2), float("nan"), dtype=dtype,
                      device=device)


def history_record(hist: Optional[torch.Tensor], t: int, res_y: torch.Tensor,
                   res_z: torch.Tensor) -> None:
    """Write ``[res_y, res_z]`` into ring slot ``t % H`` in place (``t`` is
    the iteration counter before the increment, as in the reference)."""
    if hist is not None:
        hist[t % hist.shape[0]] = torch.stack([res_y, res_z]).to(hist.dtype)


def unroll_history(hist, iters) -> Optional[np.ndarray]:
    """Host-side: ring -> time-ordered ``(H, 2)`` residual history.

    Row k holds the residuals after iteration ``iters - H + 1 + k`` (NaN
    where the solve finished in fewer than H iterations).
    """
    if hist is None:
        return None
    hist = hist.cpu().numpy() if isinstance(hist, torch.Tensor) else np.asarray(hist)
    n = int(iters)
    if n <= hist.shape[0]:
        return hist
    return np.roll(hist, -(n % hist.shape[0]), axis=0)


class NormalisedSystem(NamedTuple):
    """Per-column normalised system (Appendix B): b~ = b / (||b|| + eps)."""

    b: torch.Tensor
    v0: torch.Tensor
    scale: torch.Tensor  # (t,) ||b|| + eps per column


def normalise_system(b: torch.Tensor,
                     v0: Optional[torch.Tensor]) -> NormalisedSystem:
    """Normalise each column of ``b`` (and ``v0``) by ``||b|| + eps``."""
    scale = torch.linalg.vector_norm(b, dim=0) + NORM_EPS
    v0n = torch.zeros_like(b) if v0 is None else v0 / scale
    return NormalisedSystem(b=b / scale, v0=v0n, scale=scale)


def denormalise(v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Undo :func:`normalise_system`."""
    return v * scale


def residual_norms(r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(||r_y||, mean_j ||r_j||) for the normalised batched system."""
    norms = torch.linalg.vector_norm(r, dim=0)
    res_z = torch.mean(norms[1:]) if r.shape[1] > 1 else norms[0]
    return norms[0], res_z


def not_converged(res_y: torch.Tensor, res_z: torch.Tensor,
                  tol: float) -> torch.Tensor:
    """Continue while EITHER system family is above tolerance."""
    return torch.logical_or(res_y > tol, res_z > tol)


def lane_diverged(res_y: torch.Tensor, res_z: torch.Tensor,
                  threshold: float) -> torch.Tensor:
    """The summed residual went past ``threshold`` or is non-finite. With
    the default ``threshold=inf`` only the non-finite arm can fire, and a
    non-finite iterate never recovers."""
    total = res_y + res_z
    return torch.logical_or(~torch.isfinite(total), total > threshold)

