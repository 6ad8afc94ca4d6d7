"""CG preconditioner interface (fragment of ``repro.solvers.precond``).

``P = L L^T + sigma^2 I`` applied by Woodbury. Only the rank-0 identity
stand-in is ported: the serve path runs CG with ``precond_rank=0``. The
pivoted-Cholesky factor is ROADMAP Queue 1, training slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Preconditioner(NamedTuple):
    """Partial pivoted-Cholesky preconditioner ``P = LL^T + sigma^2 I``."""

    l: torch.Tensor  # (n, k) factor of K
    chol_inner: torch.Tensor  # (k, k) Cholesky of sigma^2 I_k + L^T L
    noise_var: torch.Tensor  # sigma^2

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """P^{-1} @ r for r of shape (n, t)."""
        inner = torch.cholesky_solve(self.l.T @ r, self.chol_inner)
        return (r - self.l @ inner) / self.noise_var


def identity_preconditioner(n: int, dtype=torch.float32,
                            device="cpu") -> Preconditioner:
    """Rank-0 stand-in: apply() reduces to the identity (L = 0)."""
    return Preconditioner(
        l=torch.zeros((n, 1), dtype=dtype, device=device),
        chol_inner=torch.eye(1, dtype=dtype, device=device),
        noise_var=torch.ones((), dtype=dtype, device=device),
    )


def build_preconditioner(op, rank: int) -> Preconditioner:
    """Rank-``rank`` preconditioner; only rank 0 (identity) is ported."""
    if rank != 0:
        raise NotImplementedError(
            f"precond_rank={rank}: the pivoted-Cholesky preconditioner is not "
            "ported yet (ROADMAP Queue 1, training slice); use precond_rank=0")
    return identity_preconditioner(op.n, dtype=op.x.dtype, device=op.x.device)
