"""Matrix-free access to H_theta = K(x, x) + sigma^2 I.

Port of ``repro.solvers.operator``: the full MVM, the kernel row and
diagonal that pivoted Cholesky reads, and the dense matrix for tests.
Backends of the full MVM:

  * ``dense``    — materialise K (reference; small n only).
  * ``streamed`` — :func:`kernel_mvm_tiled`, the plain two-level tiling.
  * ``cuda``     — the forward distance-tile kernel through
                   :func:`repro_torch.kernels.ops.kernel_mvm`; the
                   counterpart of the reference's ``pallas`` backend (on CPU
                   tensors it runs the kernel's plain version).

The block methods (``row_block_mvm``, ``col_block_mvm``, ``block``,
``all_block_cholesky``) arrive with the AP/SGD slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.gp.hyperparams import HyperParams, resolve_kind
from repro_torch.gp.kernels_math import (
    kernel_matrix,
    profile_from_r2,
    regularised_kernel_matrix,
    scaled_sqdist,
)

BACKENDS = ("dense", "streamed", "cuda")


def kernel_mvm_tiled(
    x1: torch.Tensor,
    x2: torch.Tensor,
    v: torch.Tensor,
    params: HyperParams,
    kind: Optional[str] = None,
    bm: int = 1024,
    bn: int = 1024,
) -> torch.Tensor:
    """K(x1, x2) @ v with two-level tiling; never materialises K.

    Outer loop over row tiles of x1, inner loop accumulating over column
    tiles of (x2, v). Differentiable: the hyper-gradient runs autograd
    through this function, as the reference runs ``jax.grad`` through its
    twin.
    """
    profile = profile_from_r2(resolve_kind(kind, params))
    ell, signal = params.lengthscales, params.signal
    n, m, s = x1.shape[0], x2.shape[0], v.shape[1]
    rows = []
    for i in range(0, n, bm):
        xr = x1[i:i + bm]
        acc = torch.zeros((xr.shape[0], s), dtype=v.dtype, device=v.device)
        for j in range(0, m, bn):
            kb = profile(scaled_sqdist(xr, x2[j:j + bn], ell), signal)
            acc = acc + kb @ v[j:j + bn]
        rows.append(acc)
    if not rows:
        return torch.zeros((0, s), dtype=v.dtype, device=v.device)
    return torch.cat(rows)


@dataclass(frozen=True)
class HOperator:
    """H_theta = K(x, x; theta) + sigma^2 I as a linear operator."""

    x: torch.Tensor  # (n, d) training inputs
    params: HyperParams
    kind: Optional[str] = None  # None => params.kernel
    backend: str = "streamed"  # dense | streamed | cuda
    bm: int = 1024
    bn: int = 1024

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown HOperator backend {self.backend!r}; "
                             f"options: {BACKENDS}")

    @property
    def n(self) -> int:
        """Number of training rows (the system dimension)."""
        return self.x.shape[0]

    @property
    def kernel_kind(self) -> str:
        """The effective kernel name (explicit kind wins over params.kernel)."""
        return resolve_kind(self.kind, self.params)

    @property
    def noise_var(self) -> torch.Tensor:
        """The regulariser sigma^2 added to the kernel diagonal."""
        return self.params.noise ** 2

    def _kernel_mvm(self, v: torch.Tensor) -> torch.Tensor:
        if self.backend == "dense":
            return kernel_matrix(self.x, self.x, self.params,
                                 kind=self.kind) @ v
        if self.backend == "cuda":
            from repro_torch.kernels.ops import kernel_mvm

            return kernel_mvm(self.x, self.x, v, self.params,
                              kind=self.kernel_kind)
        return kernel_mvm_tiled(self.x, self.x, v, self.params,
                                kind=self.kind, bm=self.bm, bn=self.bn)

    def mvm(self, v: torch.Tensor) -> torch.Tensor:
        """H @ v for v of shape (n, s) [or (n,)]."""
        squeeze = v.ndim == 1
        if squeeze:
            v = v[:, None]
        out = self._kernel_mvm(v) + self.noise_var * v
        return out[:, 0] if squeeze else out

    def kernel_row(self, i: torch.Tensor) -> torch.Tensor:
        """K[i, :] (WITHOUT noise) -> (n,) for a 0-d index tensor ``i``.

        The row is read with ``index_select``, so a device index never
        syncs the host; used by pivoted Cholesky. ``r2`` is taken by direct
        differences, so the pivot's own entry is exactly ``s^2``: the
        expanded form leaves ~1e-6 there in fp32, which Matérn-1/2's square
        root turns into an error of ~1e-3 in the pivot column.
        """
        u = self.x / self.params.lengthscales
        diff = u - u.index_select(0, i.reshape(1))
        profile = profile_from_r2(self.kernel_kind)
        return profile(torch.sum(diff * diff, dim=-1), self.params.signal)

    def kernel_diag(self) -> torch.Tensor:
        """diag(K) (WITHOUT noise) -> (n,); constant s^2 for stationary k."""
        return (self.params.signal ** 2).expand(self.n).to(self.x.dtype).clone()

    def dense(self) -> torch.Tensor:
        """Materialise H = K + sigma^2 I as an (n, n) tensor (tests only)."""
        return regularised_kernel_matrix(self.x, self.params, kind=self.kind)
