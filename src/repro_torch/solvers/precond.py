"""Rank-k pivoted Cholesky preconditioner for CG (paper Appendix B, following
Wang et al. / GPyTorch); port of ``repro.solvers.precond``.

Builds a partial pivoted Cholesky factor L (n x k) of the *kernel* matrix K
(without noise) with k greedy pivots, then applies

    P^{-1} r = (L L^T + sigma^2 I)^{-1} r
             = (r - L (sigma^2 I_k + L^T L)^{-1} L^T r) / sigma^2      (Woodbury)

Each pivot step reads one kernel row K[i, :] (the plain dense
``kernel_matrix`` of one row, as in the reference: no tile kernel). The
pivot index stays a 0-d device tensor (``argmax`` then ``index_select``), so
the k pivot steps never sync the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_JITTER = 1e-10

# Sentinel for SolverConfig.precond_rank: resolve rank/jitter from the
# per-kernel table below instead of a hand-picked number.
AUTO_RANK = -1


class PrecondDefaults(NamedTuple):
    """Per-kernel pivoted-Cholesky settings (see PRECOND_DEFAULTS)."""

    rank: int
    jitter: float


# Per-kernel defaults (the reference's table): rank tracks the kernel's
# eigendecay (RBF super-exponential, Matérn polynomial in nu); Matérn-1/2
# also gets a larger inner jitter. Unregistered kernels fall back to the
# paper's rank 100.
PRECOND_DEFAULTS: dict[str, PrecondDefaults] = {
    "rbf": PrecondDefaults(rank=20, jitter=_JITTER),
    "matern12": PrecondDefaults(rank=150, jitter=1e-8),
    "matern32": PrecondDefaults(rank=100, jitter=_JITTER),
    "matern52": PrecondDefaults(rank=60, jitter=_JITTER),
}

_FALLBACK = PrecondDefaults(rank=100, jitter=_JITTER)


def default_precond(kind: str) -> PrecondDefaults:
    """The rank/jitter defaults for a registered kernel name."""
    return PRECOND_DEFAULTS.get(kind, _FALLBACK)


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


def pivoted_cholesky(op, rank: int) -> torch.Tensor:
    """Partial pivoted Cholesky of K (kernel only, no noise): (n, rank).

    Greedy pivot = argmax of the running diagonal of the Schur complement
    (the first maximum on ties, as ``jnp.argmax``).
    """
    x = op.x
    l = torch.zeros((op.n, rank), dtype=x.dtype, device=x.device)
    d = op.kernel_diag()
    for j in range(rank):
        i = torch.argmax(d).reshape(1)
        row = op.kernel_row(i) - l @ l.index_select(0, i)[0]
        col = row / torch.sqrt(torch.clamp_min(d.index_select(0, i), _JITTER))
        l[:, j] = col
        d = torch.clamp_min(d - col**2, 0.0).index_fill(0, i, 0.0)
    return l


def build_preconditioner(op, rank: int) -> Preconditioner:
    """Rank-``rank`` preconditioner; 0 disables, AUTO_RANK (< 0) resolves the
    rank and jitter from the per-kernel :data:`PRECOND_DEFAULTS` table."""
    jitter = _JITTER
    if rank < 0:
        defaults = default_precond(op.kernel_kind)
        rank, jitter = defaults.rank, defaults.jitter
    rank = min(rank, op.n)
    x = op.x
    if rank <= 0:
        return identity_preconditioner(op.n, dtype=x.dtype, device=x.device)
    l = pivoted_cholesky(op, rank)
    eye = torch.eye(rank, dtype=l.dtype, device=l.device)
    inner = op.noise_var * eye + l.T @ l + jitter * eye
    return Preconditioner(l=l, chol_inner=torch.linalg.cholesky(inner),
                          noise_var=op.noise_var)
