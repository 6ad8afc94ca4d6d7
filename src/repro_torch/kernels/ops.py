"""Public op around the forward distance-tile MVM; port of ``repro.kernels.ops``.

``kernel_mvm(x1, x2, v, params, kind=...)`` computes ``K(x1, x2; theta) @ v``
for any registered kernel: inputs are pre-scaled by ``1/ell``, the unit
kernel runs through :func:`repro_torch.kernels.tiled.kernel_mvm_unit` (the
CUDA kernel on CUDA tensors, its plain version on CPU tensors), and
``signal**2`` is applied after. ``h_mvm`` adds ``sigma^2 v``.

Forward only: on CUDA, inputs that require grad raise (the backward kernel
arrives as a ``torch.autograd.Function`` with the training slice). The
hyper-gradient differentiates the plain ``solvers.operator.kernel_mvm_tiled``
instead, as the reference does. Ragged n, m and s are masked inside the
kernel, so nothing is padded here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.gp.hyperparams import HyperParams, resolve_kind
from repro_torch.kernels.tiled import kernel_mvm_unit


def kernel_mvm(x1: torch.Tensor, x2: torch.Tensor, v: torch.Tensor,
               params: HyperParams, kind: Optional[str] = None) -> torch.Tensor:
    """K(x1, x2; theta) @ v via the forward tile kernel.

    Args:
      x1: (n, d); x2: (m, d); v: (m, s) or (m,).
      kind: registered kernel name; defaults to ``params.kernel``.
    Returns:
      (n, s) or (n,) in x1.dtype.
    """
    kind = resolve_kind(kind, params)
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    ell = params.lengthscales
    u = (x1 / ell).to(torch.float32).contiguous()
    w = (x2 / ell).to(torch.float32).contiguous()
    out = kernel_mvm_unit(u, w, v.to(torch.float32).contiguous(), kind)
    out = ((params.signal**2) * out).to(x1.dtype)
    return out[:, 0] if squeeze else out


def h_mvm(x: torch.Tensor, v: torch.Tensor, params: HyperParams,
          kind: Optional[str] = None) -> torch.Tensor:
    """H_theta @ v = K @ v + sigma^2 v via the forward tile kernel."""
    return kernel_mvm(x, x, v, params, kind=kind) + (params.noise**2) * v
