"""Exact (Cholesky) GP computations; port of ``repro.gp.exact``.

The dense O(n^3) reference baseline: the exact marginal log-likelihood and
its gradient (the oracle of the tests), the exact posterior, and the
predictive metrics.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.gp.hyperparams import HyperParams
from repro_torch.gp.kernels_math import kernel_matrix, regularised_kernel_matrix

LOG2PI = math.log(2.0 * math.pi)


def exact_mll(x: torch.Tensor, y: torch.Tensor, params: HyperParams,
              kind: Optional[str] = None) -> torch.Tensor:
    """Marginal log-likelihood (paper eq. 4), exact via Cholesky."""
    n = x.shape[0]
    chol = torch.linalg.cholesky(regularised_kernel_matrix(x, params, kind=kind))
    alpha = torch.cholesky_solve(y[:, None], chol)[:, 0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    return -0.5 * (y @ alpha) - 0.5 * logdet - 0.5 * n * LOG2PI


def exact_mll_grad(x: torch.Tensor, y: torch.Tensor, params: HyperParams,
                   kind: Optional[str] = None
                   ) -> tuple[torch.Tensor, HyperParams]:
    """(mll, grad) wrt the raw hyperparameters via autograd (exact)."""
    leaves = [p.detach().requires_grad_(True) for p in params.leaves]
    with torch.enable_grad():
        mll = exact_mll(x, y, params.with_leaves(leaves), kind=kind)
        grads = torch.autograd.grad(mll, leaves)
    return mll.detach(), params.with_leaves(grads)


class ExactPosterior(NamedTuple):
    """Exact posterior at test inputs."""

    mean: torch.Tensor  # (m,)
    var: torch.Tensor  # (m,) latent-function variance (without noise)


def exact_posterior(x: torch.Tensor, y: torch.Tensor, xs: torch.Tensor,
                    params: HyperParams,
                    kind: Optional[str] = None) -> ExactPosterior:
    """Exact posterior mean/variance at test inputs xs (paper eqs. 1-2)."""
    chol = torch.linalg.cholesky(regularised_kernel_matrix(x, params, kind=kind))
    kxs = kernel_matrix(x, xs, params, kind=kind)  # (n, m)
    alpha = torch.cholesky_solve(y[:, None], chol)[:, 0]
    tmp = torch.linalg.solve_triangular(chol, kxs, upper=False)
    var = torch.clamp_min(params.signal**2 - torch.sum(tmp * tmp, dim=0), 1e-12)
    return ExactPosterior(mean=kxs.T @ alpha, var=var)


def gaussian_loglik(y: torch.Tensor, mean: torch.Tensor,
                    var_plus_noise: torch.Tensor) -> torch.Tensor:
    """Mean predictive log density (the paper's 'test log-likelihood')."""
    return torch.mean(
        -0.5 * (LOG2PI + torch.log(var_plus_noise))
        - 0.5 * (y - mean) ** 2 / var_plus_noise
    )


def rmse(y: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """Root-mean-square error of the predictive mean."""
    return torch.sqrt(torch.mean((y - mean) ** 2))
