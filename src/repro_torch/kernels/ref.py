"""Dense oracle for the kernel MVM (small n only); port of ``repro.kernels.ref``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.gp.hyperparams import HyperParams, resolve_kind
from repro_torch.gp.kernels_math import kernel_matrix


def kernel_mvm_ref(x1: torch.Tensor, x2: torch.Tensor, v: torch.Tensor,
                   params: HyperParams,
                   kind: Optional[str] = None) -> torch.Tensor:
    """Dense K(x1, x2) @ v — the correctness oracle."""
    kind = resolve_kind(kind, params)
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    out = kernel_matrix(x1, x2, params, kind=kind) @ v
    return out[:, 0] if squeeze else out


def h_mvm_ref(x: torch.Tensor, v: torch.Tensor, params: HyperParams,
              kind: Optional[str] = None) -> torch.Tensor:
    """Dense H @ v = K(x, x) @ v + sigma^2 v."""
    return kernel_mvm_ref(x, x, v, params, kind=kind) + (params.noise**2) * v


def matern_mvm_ref(x1: torch.Tensor, x2: torch.Tensor, v: torch.Tensor,
                   params: HyperParams) -> torch.Tensor:
    """The reference's original Matérn-3/2 oracle: :func:`kernel_mvm_ref`
    with ``kind="matern32"``."""
    return kernel_mvm_ref(x1, x2, v, params, kind="matern32")
