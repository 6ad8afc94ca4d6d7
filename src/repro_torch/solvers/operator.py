"""Matrix-free access to H_theta = K(x, x) + sigma^2 I.

Port of ``repro.solvers.operator``: the full MVM, the kernel row and
diagonal that pivoted Cholesky reads, the block methods of AP and SGD,
and the dense matrix for tests. Backends of the full MVM and the slabs:

  * ``dense``    — materialise K (reference; small n only).
  * ``streamed`` — :func:`kernel_mvm_tiled`, the plain two-level tiling.
  * ``cuda``     — the forward distance-tile kernel through
                   :func:`repro_torch.kernels.ops.kernel_mvm`; the
                   counterpart of the reference's ``pallas`` backend (on CPU
                   tensors it runs the kernel's plain version).

Block index convention: AP and SGD work on contiguous blocks
``[start, start + size)``; ``n`` must be a multiple of the block size (the
data pipeline pads with far-away phantom points whose kernel row against
every other point is exactly zero, see
:func:`repro_torch.data.synthetic.pad_to_block_multiple`). ``start`` is a
Python int or a 0-d integer tensor on the device (AP's argmax): a tensor is
read through ``index_select``, so the host never waits for it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch

from repro_torch.gp.hyperparams import HyperParams, resolve_kind
from repro_torch.gp.kernels_math import (
    kernel_matrix,
    profile_from_r2,
    regularised_kernel_matrix,
    scaled_sqdist,
)

BACKENDS = ("dense", "streamed", "cuda")

# Rows of a diagonal block whose direct differences are formed at once in
# ``HOperator.block`` (a 128 x 1000 x 26 fp32 chunk is 13 MB).
BLOCK_ROW_CHUNK = 128

Start = Union[int, torch.Tensor]


def _sqdist_direct(u: torch.Tensor) -> torch.Tensor:
    """(b, b) squared distances of the rows of ``u`` by direct differences,
    in row chunks of :data:`BLOCK_ROW_CHUNK` (exact zero on the diagonal)."""
    return torch.cat([
        torch.sum((u[i:i + BLOCK_ROW_CHUNK, None, :] - u[None, :, :]) ** 2,
                  dim=-1)
        for i in range(0, u.shape[0], BLOCK_ROW_CHUNK)])


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

    def _slab_mvm(self, x1: torch.Tensor, x2: torch.Tensor, v: torch.Tensor,
                  bm: int, bn: int) -> torch.Tensor:
        """K(x1, x2) @ v for a slab: the forward kernel under ``cuda``, the
        plain tiled MVM under ``streamed`` and ``dense`` (as the reference's
        slabs)."""
        if self.backend == "cuda":
            from repro_torch.kernels.ops import kernel_mvm

            return kernel_mvm(x1, x2, v, self.params, kind=self.kernel_kind)
        return kernel_mvm_tiled(x1, x2, v, self.params, kind=self.kind,
                                bm=bm, bn=bn)

    def _rows(self, t: torch.Tensor, start: Start, size: int) -> torch.Tensor:
        """Rows ``[start, start + size)`` of ``t``: a view for an int start,
        ``index_select`` on the device for a tensor start."""
        if isinstance(start, torch.Tensor):
            idx = start + torch.arange(size, device=t.device)
            return t.index_select(0, idx)
        return t[start:start + size]

    def x_block(self, start: Start, size: int) -> torch.Tensor:
        """(size, d) slice of the training inputs starting at row ``start``."""
        return self._rows(self.x, start, size)

    def row_block_mvm(self, start: Start, size: int,
                      v: torch.Tensor) -> torch.Tensor:
        """H[blk, :] @ v -> (size, s): ``K(x_blk, x) @ v + sigma^2 v_blk``,
        one (size x n) slab (an SGD step's kernel evaluations)."""
        kv = self._slab_mvm(self.x_block(start, size), self.x, v, size, self.bn)
        return kv + self.noise_var * self._rows(v, start, size)

    def col_block_mvm(self, start: Start, size: int,
                      u: torch.Tensor) -> torch.Tensor:
        """H[:, blk] @ u -> (n, s) for u of shape (size, s):
        ``K(x, x_blk) @ u + sigma^2 pad(u)``, one (n x size) slab (an AP
        step's residual update)."""
        ku = self._slab_mvm(self.x, self.x_block(start, size), u, self.bm, size)
        if isinstance(start, torch.Tensor):
            idx = start + torch.arange(size, device=u.device)
            pad_u = torch.zeros((self.n, u.shape[1]), dtype=u.dtype,
                                device=u.device).index_copy(0, idx, u)
        else:
            pad_u = torch.nn.functional.pad(
                u, (0, 0, start, self.n - start - size))
        return ku + self.noise_var * pad_u

    def block(self, start: Start, size: int) -> torch.Tensor:
        """H[blk, blk] -> (size, size) dense tile (for AP's block Cholesky).

        ``r2`` is taken by direct differences, so the diagonal is exactly
        ``s^2 + sigma^2``: the matrix the forward kernel multiplies by. The
        reference's expanded form cancels catastrophically at the phantom
        padding points (inputs ~1e6), where it leaves a diagonal of
        ``sigma^2`` for some of them.
        """
        u = self.x_block(start, size) / self.params.lengthscales
        kb = profile_from_r2(self.kernel_kind)(_sqdist_direct(u),
                                               self.params.signal)
        return kb + self.noise_var * torch.eye(size, dtype=kb.dtype,
                                               device=kb.device)

    def all_block_cholesky(self, block_size: int) -> torch.Tensor:
        """Lower Cholesky factors of every diagonal block, (n/b, b, b);
        computed once per outer step and cached by AP (paper: "the Cholesky
        factorisation of every block is computed once and cached")."""
        blocks = torch.stack([self.block(i, block_size)
                              for i in range(0, self.n, block_size)])
        # cholesky_ex: no error check, so the host does not wait for it.
        return torch.linalg.cholesky_ex(blocks).L

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
