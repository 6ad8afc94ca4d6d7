"""Rank-k pivoted Cholesky preconditioner for CG (paper Appendix B, following
Wang et al. / GPyTorch); port of ``repro.solvers.precond``.

Builds a partial pivoted Cholesky factor L (n x k) of the *kernel* matrix K
(without noise) with k greedy pivots, then applies

    P^{-1} r = (L L^T + sigma^2 I)^{-1} r
             = (r - L (sigma^2 I_k + L^T L)^{-1} L^T r) / sigma^2      (Woodbury)

Each pivot step reads one kernel row K[i, :] (the plain dense
``kernel_matrix`` of one row, as in the reference: no tile kernel). The
pivot index stays on the device (``argmax`` then a gather), so the k pivot
steps never sync the host. Lanes follow their own pivots in one batched
loop: the k steps run once for all B lanes, each reading its own kernel row
(:meth:`HOperator.kernel_row` with a (B,) pivot).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

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
    """Partial pivoted-Cholesky preconditioner ``P = LL^T + sigma^2 I``;
    lane-stacked with a leading B axis on every field."""

    l: torch.Tensor  # (n, k) factor of K
    chol_inner: torch.Tensor  # (k, k) Cholesky of sigma^2 I_k + L^T L
    noise_var: torch.Tensor  # sigma^2

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """P^{-1} @ r for r of shape (n, t), or (B, n, t) for lanes (with
        the (B, 1, 1) noise of :meth:`lifted`)."""
        inner = cholesky_solve(self.l.transpose(-1, -2) @ r, self.chol_inner)
        return (r - self.l @ inner) / self.noise_var

    def lifted(self) -> "Preconditioner":
        """Lane-stacked fields (B = 1 for one system's), the noise shaped
        (B, 1, 1) to divide (B, n, t) residuals."""
        if self.l.ndim == 2:
            return Preconditioner(self.l[None], self.chol_inner[None],
                                  self.noise_var.reshape(1, 1, 1))
        return self._replace(noise_var=self.noise_var.reshape(-1, 1, 1))


def cholesky_solve(b: torch.Tensor, chol: torch.Tensor) -> torch.Tensor:
    """``(L L^T)^{-1} b`` for lower Cholesky factors ``chol`` (batched):
    two triangular solves, as LAPACK's potrs and the reference's
    ``cho_solve`` compute it, each one batched call for all lanes (a
    batched ``torch.cholesky_solve`` on CUDA matrices held the host: an AP
    iteration of 4 lanes idled the card 86 %). One system takes
    ``torch.cholesky_solve`` on its matrix."""
    if chol.shape[0] == 1:  # one system: LAPACK's / cuSOLVER's potrs
        return torch.cholesky_solve(b[0], chol[0])[None]
    y = torch.linalg.solve_triangular(chol, b, upper=False)
    return torch.linalg.solve_triangular(chol.transpose(-1, -2), y, upper=True)


def identity_preconditioner(n: int, dtype=torch.float32, device="cpu",
                            lanes: Optional[int] = None) -> Preconditioner:
    """Rank-0 stand-in: apply() reduces to the identity (L = 0)."""
    lead = () if lanes is None else (lanes,)
    return Preconditioner(
        l=torch.zeros((*lead, n, 1), dtype=dtype, device=device),
        chol_inner=torch.eye(1, dtype=dtype, device=device).expand(
            *lead, 1, 1).clone(),
        noise_var=torch.ones(lead, dtype=dtype, device=device),
    )


def pivoted_cholesky(op, rank: int) -> torch.Tensor:
    """Partial pivoted Cholesky of K (kernel only, no noise): (n, rank), or
    (B, n, rank) for a lane-stacked operator, every lane on its own pivots
    in one loop.

    Greedy pivot = argmax of the running diagonal of the Schur complement
    (the first maximum on ties, as ``jnp.argmax``).
    """
    if op.lanes == 1:
        return pivoted_cholesky(op.lane(0), rank)[None]
    x = op.x
    if op.lanes is None:  # one system: fewer ops a pivot than the lanes'
        l = torch.zeros((op.n, rank), dtype=x.dtype, device=x.device)
        d = op.kernel_diag()
        for j in range(rank):
            i = torch.argmax(d).reshape(1)
            row = op.kernel_row(i) - l @ l.index_select(0, i)[0]
            col = row / torch.sqrt(torch.clamp_min(d.index_select(0, i),
                                                   _JITTER))
            l[:, j] = col
            d = torch.clamp_min(d - col**2, 0.0).index_fill(0, i, 0.0)
        return l
    lanes, n = op.lanes, op.n
    l = torch.zeros((lanes, n, rank), dtype=x.dtype, device=x.device)
    l_rows = l.view(lanes * n, rank)  # each lane's rows, one after another
    d = op.kernel_diag()
    base = torch.arange(0, lanes * n, n, device=x.device)
    for j in range(rank):
        i = torch.argmax(d, dim=1)
        flat = i + base  # each lane's pivot among the (B * n) rows
        li = l_rows.index_select(0, flat).unsqueeze(-1)  # (B, rank, 1)
        row = op.kernel_row(i) - torch.matmul(l, li).squeeze(-1)
        col = row / torch.sqrt(torch.clamp_min(
            d.view(-1).index_select(0, flat), _JITTER)).unsqueeze(-1)
        l[:, :, j] = col
        d = torch.clamp_min(d - col**2, 0.0).view(-1).index_fill(
            0, flat, 0.0).view(lanes, n)
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
        return identity_preconditioner(op.n, dtype=x.dtype, device=x.device,
                                       lanes=op.lanes)
    l = pivoted_cholesky(op, rank)
    eye = torch.eye(rank, dtype=l.dtype, device=l.device)
    nv = op.noise_var
    inner = ((nv[:, None, None] if nv.ndim else nv) * eye
             + l.transpose(-1, -2) @ l + jitter * eye)
    return Preconditioner(l=l, chol_inner=torch.linalg.cholesky(inner),
                          noise_var=op.noise_var)
