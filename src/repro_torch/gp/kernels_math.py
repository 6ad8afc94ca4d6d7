"""Dense kernel mathematics over the registered stationary kernels.

Port of ``repro.gp.kernels_math`` (the fragment the serve path uses):
``k(a, b) = s^2 * kappa(r^2)`` with ``r = ||(a - b) / ell||``, and the
regularised matrix ``H = K(x, x) + sigma^2 I``. These are the dense oracles
and the building blocks of the plain tiled MVM the gradient differentiates.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.gp.hyperparams import HyperParams, resolve_kind
from repro_torch.kernels.registry import get_kernel


def scaled_sqdist(x1: torch.Tensor, x2: torch.Tensor,
                  lengthscales: torch.Tensor) -> torch.Tensor:
    """(n, m) squared distances of lengthscale-scaled inputs, clamped >= 0.

    Expanded quadratic form ``uu + vv - 2 u v^T`` (one GEMM for the cross
    term), as in the reference.
    """
    u = x1 / lengthscales
    v = x2 / lengthscales
    uu = torch.sum(u * u, dim=-1)
    vv = torch.sum(v * v, dim=-1)
    r2 = uu[:, None] + vv[None, :] - 2.0 * (u @ v.T)
    return torch.clamp_min(r2, 0.0)


def profile_from_r2(kind: str) -> Callable:
    """Signal-scaled profile ``(r2, signal) -> s^2 kappa(r2)`` for ``kind``."""
    spec = get_kernel(kind)

    def profile(r2: torch.Tensor, signal: torch.Tensor) -> torch.Tensor:
        return (signal**2) * spec.kappa_from_r2(r2)

    return profile


def kernel_matrix(x1: torch.Tensor, x2: torch.Tensor, params: HyperParams,
                  kind: Optional[str] = None) -> torch.Tensor:
    """Dense cross-kernel matrix K(x1, x2; theta) of shape (n, m)."""
    kind = resolve_kind(kind, params)
    r2 = scaled_sqdist(x1, x2, params.lengthscales)
    return profile_from_r2(kind)(r2, params.signal)


def regularised_kernel_matrix(x: torch.Tensor, params: HyperParams,
                              kind: Optional[str] = None) -> torch.Tensor:
    """H_theta = K(x, x) + sigma^2 I (dense; reference/small-n only)."""
    k = kernel_matrix(x, x, params, kind=kind)
    eye = torch.eye(x.shape[0], dtype=k.dtype, device=k.device)
    return k + (params.noise**2) * eye
