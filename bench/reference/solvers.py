"""What the plain solvers of ``H V = B`` share (paper App. B).

Each solver is ``bench/reference/solve_<name>.py``, found by the traffic's
``solver.name`` (:func:`bench.reference.solver`). Each column is solved
normalised, ``b / (|b| + 1e-10)``, and rescaled after. A solve stops when
the mean system's residual norm and the probes' mean residual norm are
both at most the tolerance, or when its iteration budget, ``epochs x
iterations per epoch`` formed in float32, is spent. CG's preconditioner is
a rank-k pivoted Cholesky factor of K (greedy pivots, ``(L L^T + sigma^2
I)^-1`` by Woodbury).
"""
from __future__ import annotations

import torch

from bench.reference.gp import Arith, constrained, matern32, scaled, sqdist

PRECOND_JITTER = 1e-10
MAX_ITERS = 2**30


def iteration_cap(max_epochs, iters_per_epoch: float) -> int:
    if max_epochs is None:
        return MAX_ITERS
    cap = torch.tensor(iters_per_epoch, dtype=torch.float32) * torch.tensor(
        float(max_epochs), dtype=torch.float32)
    return int(min(float(cap), float(MAX_ITERS)))


def norms(r: torch.Tensor) -> tuple:
    norms = torch.linalg.vector_norm(r, dim=0)
    return float(norms[0]), float(torch.mean(norms[1:]))


def pivoted_cholesky(x: torch.Tensor, raw: list, rank: int) -> torch.Tensor:
    """(n, rank) greedy pivoted Cholesky factor of K = s^2 kappa(x, x)."""
    ell, sig, _ = constrained(raw)
    u = scaled(x, ell)
    n = x.shape[0]
    rank = min(rank, n)
    l = torch.zeros((n, rank), dtype=x.dtype, device=x.device)
    diag = (sig * sig).expand(n).clone()
    for j in range(rank):
        i = int(torch.argmax(diag))
        row = (sig * sig) * matern32(sqdist(u[i:i + 1], u))[0] - l @ l[i]
        col = row / torch.sqrt(torch.clamp_min(diag[i], PRECOND_JITTER))
        l[:, j] = col
        diag = torch.clamp_min(diag - col * col, 0.0)
        diag[i] = 0.0
    return l


class Preconditioner:
    """P^-1 r = (r - L (sigma^2 I + L^T L + jitter I)^-1 L^T r) / sigma^2."""

    def __init__(self, ar: Arith, x: torch.Tensor, raw: list, rank: int):
        self.ar = ar
        self.l = pivoted_cholesky(x, raw, rank)
        self.noise_var = constrained(raw)[2] ** 2
        k = self.l.shape[1]
        eye = torch.eye(k, dtype=x.dtype, device=x.device)
        inner = self.noise_var * eye + ar.mm(self.l.T, self.l) \
            + PRECOND_JITTER * eye
        self.chol = torch.linalg.cholesky(inner)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        inner = torch.cholesky_solve(self.ar.mm(self.l.T, r), self.chol)
        return (r - self.ar.mm(self.l, inner)) / self.noise_var


def guarded(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, torch.ones_like(den)),
                       torch.zeros_like(num))
