"""Shared solver types: config, result, normalisation, budget accounting.

Port of the fragment of ``repro.solvers.base`` that CG needs. One solver
epoch is every entry of H computed once (CG: one iteration = one epoch).
Each system ``H u = b`` is solved normalised, ``b~ = b / (||b|| + eps)``,
and rescaled afterwards (Appendix B). Termination: BOTH the mean-system
residual norm and the probe average must reach the tolerance.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

NORM_EPS = 1e-10

# Iteration cap for epoch budgets (the reference's int32-safe cap).
MAX_SOLVER_ITERS = 2**30


@dataclass(frozen=True)
class SolverConfig:
    """Solver configuration (the fields of the reference's SolverConfig
    that the ported solvers read).

    ``precond_rank`` > 0 selects pivoted Cholesky, which is not ported yet
    (see :func:`repro_torch.solvers.precond.build_preconditioner`).
    """

    name: str = "cg"  # cg | ap | sgd (only cg is ported)
    tolerance: float = 0.01
    kind: Optional[str] = None
    max_epochs: float = 1e9
    precond_rank: int = 100


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
    mvms: int = 0  # full H @ V products (CG: iters + 1 for the residual)
    host_syncs: int = 0  # device -> host reads of the stopping rule


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
