"""Dense kernel mathematics over the registered stationary kernels.

Port of ``repro.gp.kernels_math``: ``k(a, b) = s^2 * kappa(r^2)`` with
``r = ||(a - b) / ell||``, the regularised matrix ``H = K(x, x) + sigma^2
I``, and H @ v dense or streamed over row blocks. These are the dense
oracles and the building blocks of the plain tiled MVM the gradient
differentiates.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.gp.hyperparams import HyperParams, resolve_kind
from repro_torch.kernels.registry import available_kernels, get_kernel


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
        """``s^2 kappa(r2)`` of this kernel, elementwise over ``r2``."""
        return (signal**2) * spec.kappa_from_r2(r2)

    return profile


# Signal-scaled profiles, one per registered kernel, built at import;
# kernels registered later are reached through profile_from_r2.
PROFILES: dict[str, Callable] = {
    name: profile_from_r2(name) for name in available_kernels()
}
_PROFILES = PROFILES  # the reference's older name

# Named profiles of the built-in family.
rbf_from_r2 = PROFILES["rbf"]
matern12_from_r2 = PROFILES["matern12"]
matern32_from_r2 = PROFILES["matern32"]
matern52_from_r2 = PROFILES["matern52"]


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


def kernel_mvm_streamed(x1: torch.Tensor, x2: torch.Tensor, v: torch.Tensor,
                        params: HyperParams, kind: Optional[str] = None,
                        block_rows: int = 1024) -> torch.Tensor:
    """K(x1, x2) @ v without materialising K: O(block_rows * m) memory.

    Streams over row blocks of x1; each block builds its distance tile (the
    expanded form of :func:`scaled_sqdist`), applies the profile and
    contracts against ``v``. The plain analogue of the distance-tile
    kernel, and the single-device form of the ring MVM
    (:mod:`repro_torch.distributed.ring`).

    Args:
      x1: (n, d); x2: (m, d); v: (m, s) or (m,).
    Returns:
      (n, s) or (n,): K @ v.
    """
    kind = resolve_kind(kind, params)
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    profile = profile_from_r2(kind)
    blocks = [profile(scaled_sqdist(x1[i:i + block_rows], x2,
                                    params.lengthscales), params.signal) @ v
              for i in range(0, x1.shape[0], block_rows)]
    out = torch.cat(blocks) if blocks else v.new_zeros((0, v.shape[1]))
    return out[:, 0] if squeeze else out


def h_mvm_dense(x: torch.Tensor, v: torch.Tensor, params: HyperParams,
                kind: Optional[str] = None) -> torch.Tensor:
    """H_theta @ v via the dense kernel matrix (reference)."""
    return regularised_kernel_matrix(x, params, kind=kind) @ v


def h_mvm_streamed(x: torch.Tensor, v: torch.Tensor, params: HyperParams,
                   kind: Optional[str] = None,
                   block_rows: int = 1024) -> torch.Tensor:
    """H_theta @ v = K @ v + sigma^2 v, streamed (no n x n matrix)."""
    kv = kernel_mvm_streamed(x, x, v, params, kind=kind,
                             block_rows=block_rows)
    return kv + (params.noise**2) * v
