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

``kernel_mvm_override`` replaces the full MVM (K @ v; the noise is still
added here), so a solver runs on, e.g., the ring MVM of
:mod:`repro_torch.distributed.ring`.

Block index convention: AP and SGD work on contiguous blocks
``[start, start + size)``; ``n`` must be a multiple of the block size (the
data pipeline pads with far-away phantom points whose kernel row against
every other point is exactly zero, see
:func:`repro_torch.data.synthetic.pad_to_block_multiple`). ``start`` is a
Python int or a 0-d integer tensor on the device (AP's argmax): a tensor is
read through ``index_select``, so the host never waits for it.

Lanes: with lane-stacked ``params`` ((B, d) lengthscales, (B,) signal and
noise; the training inputs ``x`` shared) the operator is B independent
systems. ``mvm`` takes (B, n, t); ``row_block_mvm``, ``col_block_mvm``,
``block`` and ``kernel_row`` take a per-lane start or pivot as a (B,)
tensor, so each lane's slab rows are gathered into one contiguous
(B, b, d) operand and the ``cuda`` backend makes one launch for all lanes.
The ``dense`` and ``streamed`` backends, plain references, run lane by
lane. :meth:`HOperator.lifted` is one system's operator as B = 1 lanes.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from functools import lru_cache
from typing import Callable, Optional, Union

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


@lru_cache(maxsize=64)
def _ranges(lanes: int, n: int, size: int, device: torch.device) -> tuple:
    """Each lane's first row in the (lanes * n) flattening of a
    lane-stacked tensor, and [0, size): built once per shape, so a slab's
    row indices cost one or two additions per iteration."""
    return (torch.arange(0, lanes * n, n, device=device),
            torch.arange(size, device=device))


def _sqdist_direct(u: torch.Tensor) -> torch.Tensor:
    """(..., b, b) squared distances of the rows of ``u`` (..., b, d) by
    direct differences, in row chunks of :data:`BLOCK_ROW_CHUNK` (exact
    zero on the diagonal)."""
    return torch.cat([
        torch.sum((u[..., i:i + BLOCK_ROW_CHUNK, None, :]
                   - u[..., None, :, :]) ** 2, dim=-1)
        for i in range(0, u.shape[-2], BLOCK_ROW_CHUNK)], dim=-2)


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

    # torch-lint: disable=config-static-array -- frozen for immutability; the operator is never hashed or used as a cache or group key
    x: torch.Tensor  # (n, d) training inputs
    params: HyperParams
    kind: Optional[str] = None  # None => params.kernel
    backend: str = "streamed"  # dense | streamed | cuda
    bm: int = 1024
    bn: int = 1024
    # Optional externally supplied full-MVM override (e.g. the ring MVM of
    # repro_torch.distributed.ring); (v: (n, s)) -> (n, s) for K @ v, the
    # noise added here; a solver's B = 1 lift calls it on its one lane. The
    # slabs and blocks still read ``x``.
    kernel_mvm_override: Optional[Callable] = None

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
        """The regulariser sigma^2 added to the kernel diagonal ((B,) for
        lanes)."""
        return self.params.noise ** 2

    @property
    def lanes(self) -> Optional[int]:
        """The lane count of lane-stacked params, or None for one system."""
        return self.params.lanes

    def lifted(self) -> "HOperator":
        """This operator with lane-stacked params (B = 1 for one system)."""
        if self.lanes is not None:
            return self
        return replace(self, params=self.params.lifted())

    def lane(self, index: int) -> "HOperator":
        """Lane ``index`` of a lane-stacked operator as one system's."""
        return replace(self, params=self.params.lane(index))

    def _per_lane(self, value: torch.Tensor, ndim: int) -> torch.Tensor:
        """A per-lane (B,) value shaped to broadcast over (B, ...) tensors of
        ``ndim`` dimensions; unchanged for one system."""
        if self.lanes is None:
            return value
        return value.reshape(-1, *([1] * (ndim - 1)))

    def _lengthscales(self) -> torch.Tensor:
        """Lengthscales shaped to divide (n, d) inputs: (d,), (B, 1, d)."""
        ell = self.params.lengthscales
        return ell if self.lanes is None else ell[:, None, :]

    def _lanewise(self, fn, *lane_args) -> torch.Tensor:
        """Stack ``fn(lane_operator, *args_of_lane)`` over the lanes: the
        plain backends' lane loop. A 3-D argument is indexed per lane, a
        2-D one is shared."""
        return torch.stack([
            fn(self.lane(l), *(a[l] if a.ndim == 3 else a for a in lane_args))
            for l in range(self.lanes)])

    def _kernel_mvm(self, v: torch.Tensor) -> torch.Tensor:
        if self.kernel_mvm_override is not None:
            if v.ndim == 2:
                return self.kernel_mvm_override(v)
            if v.shape[0] != 1:
                raise ValueError("kernel_mvm_override is one system's MVM; "
                                 f"got {v.shape[0]} lanes")
            return self.kernel_mvm_override(v[0])[None]
        if self.lanes is not None and self.backend != "cuda":
            return self._lanewise(HOperator._kernel_mvm, v)
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
        """H @ v for v of shape (n, s) [or (n,)]; (B, n, s) for lanes."""
        squeeze = v.ndim == 1
        if squeeze:
            v = v[:, None]
        out = self._kernel_mvm(v) + self._per_lane(self.noise_var, 3) * v
        return out[:, 0] if squeeze else out

    def _slab_mvm(self, x1: torch.Tensor, x2: torch.Tensor, v: torch.Tensor,
                  bm: int, bn: int) -> torch.Tensor:
        """K(x1, x2) @ v for a slab: the forward kernel under ``cuda``, the
        plain tiled MVM under ``streamed`` and ``dense`` (as the reference's
        slabs)."""
        if self.backend == "cuda":
            from repro_torch.kernels.ops import kernel_mvm

            return kernel_mvm(x1, x2, v, self.params, kind=self.kernel_kind)
        if self.lanes is not None:
            return self._lanewise(
                lambda op, a, b, c: op._slab_mvm(a, b, c, bm, bn), x1, x2, v)
        return kernel_mvm_tiled(x1, x2, v, self.params, kind=self.kind,
                                bm=bm, bn=bn)

    def row_index(self, start: torch.Tensor, size: int,
                  flat: bool = True) -> torch.Tensor:
        """Row indices ``start + [0, size)`` for a 0-d start: (size,). For
        per-lane (B,) starts, each lane's rows as one (B * size,) vector:
        into the (B * n) flattening of a lane-stacked tensor when ``flat``,
        else into a shared (n, k) one."""
        lanes = start.shape[0] if start.ndim else 1
        base, offsets = _ranges(lanes, self.n, size, start.device)
        if start.ndim == 0:
            return start + offsets
        if flat:
            start = start + base
        return (start[:, None] + offsets).reshape(-1)

    def _rows(self, t: torch.Tensor, start: Start, size: int) -> torch.Tensor:
        """Rows ``[start, start + size)`` of ``t`` (the row axis is -2 for a
        lane-stacked t): a view for an int start, ``index_select`` on the
        device for a tensor start. Per-lane (B,) starts take each lane's
        own rows of a shared (n, k) or per-lane (B, n, k) ``t``, as one
        contiguous (B, size, k) tensor."""
        if not isinstance(start, torch.Tensor):
            return t[..., start:start + size, :]
        if start.ndim == 0:
            return t.index_select(t.ndim - 2, self.row_index(start, size))
        lanes, k = start.shape[0], t.shape[-1]
        if t.ndim == 2:
            idx = self.row_index(start, size, flat=False)
            return t.index_select(0, idx).reshape(lanes, size, k)
        return t.reshape(-1, k).index_select(
            0, self.row_index(start, size)).reshape(lanes, size, k)

    def x_block(self, start: Start, size: int) -> torch.Tensor:
        """(size, d) slice of the training inputs starting at row ``start``."""
        return self._rows(self.x, start, size)

    def row_block_mvm(self, start: Start, size: int,
                      v: torch.Tensor) -> torch.Tensor:
        """H[blk, :] @ v -> (size, s): ``K(x_blk, x) @ v + sigma^2 v_blk``,
        one (size x n) slab (an SGD step's kernel evaluations)."""
        kv = self._slab_mvm(self.x_block(start, size), self.x, v, size, self.bn)
        return kv + self._per_lane(self.noise_var, 3) * self._rows(v, start,
                                                                   size)

    def col_block_mvm(self, start: Start, size: int,
                      u: torch.Tensor) -> torch.Tensor:
        """H[:, blk] @ u -> (n, s) for u of shape (size, s):
        ``K(x, x_blk) @ u + sigma^2 pad(u)``, one (n x size) slab (an AP
        step's residual update)."""
        ku = self._slab_mvm(self.x, self.x_block(start, size), u, self.bm, size)
        if isinstance(start, torch.Tensor):
            t = u.shape[-1]
            pad_u = torch.zeros((*u.shape[:-2], self.n, t), dtype=u.dtype,
                                device=u.device)
            pad_u = pad_u.reshape(-1, t).index_copy(
                0, self.row_index(start, size), u.reshape(-1, t)
            ).reshape(pad_u.shape)
        else:
            pad_u = torch.nn.functional.pad(
                u, (0, 0, start, self.n - start - size))
        return ku + self._per_lane(self.noise_var, 3) * pad_u

    def block(self, start: Start, size: int) -> torch.Tensor:
        """H[blk, blk] -> (size, size) dense tile (for AP's block Cholesky).

        ``r2`` is taken by direct differences, so the diagonal is exactly
        ``s^2 + sigma^2``: the matrix the forward kernel multiplies by. The
        reference's expanded form cancels catastrophically at the phantom
        padding points (inputs ~1e6), where it leaves a diagonal of
        ``sigma^2`` for some of them.
        """
        u = self.x_block(start, size) / self._lengthscales()
        kb = profile_from_r2(self.kernel_kind)(
            _sqdist_direct(u), self._per_lane(self.params.signal, 3))
        return kb + self._per_lane(self.noise_var, 3) * torch.eye(
            size, dtype=kb.dtype, device=kb.device)

    def all_block_cholesky(self, block_size: int) -> torch.Tensor:
        """Lower Cholesky factors of every diagonal block, (n/b, b, b), or
        (B, n/b, b, b) for lanes; computed once per outer step and cached by
        AP (paper: "the Cholesky factorisation of every block is computed
        once and cached")."""
        blocks = torch.stack([self.block(i, block_size)
                              for i in range(0, self.n, block_size)], dim=-3)
        # cholesky_ex: no error check, so the host does not wait for it.
        return torch.linalg.cholesky_ex(blocks).L

    def kernel_row(self, i: torch.Tensor) -> torch.Tensor:
        """K[i, :] (WITHOUT noise) -> (n,) for a 0-d index tensor ``i``.

        The row is read with ``index_select``, so a device index never
        syncs the host; used by pivoted Cholesky. ``r2`` is taken by direct
        differences, so the pivot's own entry is exactly ``s^2``: the
        expanded form leaves ~1e-6 there in fp32, which Matérn-1/2's square
        root turns into an error of ~1e-3 in the pivot column. Lanes take a
        (B,) pivot tensor and give (B, n).
        """
        u = self.x / self._lengthscales()
        if self.lanes is None:
            diff = u - u.index_select(0, i.reshape(1))
        else:
            base = _ranges(self.lanes, self.n, 1, i.device)[0]
            diff = u - u.reshape(-1, u.shape[-1]).index_select(
                0, i + base)[:, None, :]
        profile = profile_from_r2(self.kernel_kind)
        return profile(torch.sum(diff * diff, dim=-1),
                       self._per_lane(self.params.signal, 2))

    def kernel_diag(self) -> torch.Tensor:
        """diag(K) (WITHOUT noise) -> (n,), or (B, n) for lanes; constant
        s^2 for stationary k."""
        sig2 = self._per_lane(self.params.signal ** 2, 2)
        return sig2.expand(*sig2.shape[:-1], self.n).to(self.x.dtype).clone()

    def dense(self) -> torch.Tensor:
        """Materialise H = K + sigma^2 I as an (n, n) tensor, (B, n, n) for
        lanes (tests only)."""
        if self.lanes is not None:
            return torch.stack([self.lane(l).dense() for l in range(self.lanes)])
        return regularised_kernel_matrix(self.x, self.params, kind=self.kind)
