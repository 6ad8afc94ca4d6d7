"""Public differentiable op around the distance-tile kernels; port of
``repro.kernels.ops``.

``kernel_mvm(x1, x2, v, params, kind=...)`` computes ``K(x1, x2; theta) @ v``
for any registered kernel: inputs are pre-scaled by ``1/ell``, the unit
kernel runs through :class:`_UnitMVM`, and ``signal**2`` is applied after.
``h_mvm`` adds ``sigma^2 v``.

:class:`_UnitMVM` is the counterpart of the reference's ``_unit_mvm``
custom VJP: its forward is :func:`repro_torch.kernels.tiled.kernel_mvm_unit`
and its backward computes ``du`` and ``dw`` with the backward tile kernel
(``dw`` by the (u, w) / (g, v) symmetry) and ``dv`` with the forward kernel,
roles swapped, each only where autograd asks for it. When ``x2 is x1`` (the
GP case) one pre-scaled tensor is both ``u`` and ``w``, and ``du + dw`` is
one call of the backward tile kernel on ``(u, u, [g | v], [v | g])``
(:func:`repro_torch.kernels.tiled.kernel_mvm_bwd_fused_unit`); autograd
gives it to the tensor passed twice. On CUDA tensors these
are the hand-written kernels, on CPU tensors their plain versions. The
lengthscale and signal gradients flow through the plain pre-scaling
``x / ell`` and post-scaling ``signal**2 * out``, as in the reference: one
sweep over distance tiles serves every hyperparameter. Ragged n, m and s are
masked inside the kernels, so nothing is padded here. Lane-stacked
hyperparameters give lane-stacked operands (B, n, d): one launch of each
kernel for all B lanes, and each lane's gradient flows to its own leaves.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from repro_torch.gp.hyperparams import HyperParams, resolve_kind
from repro_torch.kernels.tiled import (kernel_mvm_bwd_fused_unit,
                                      kernel_mvm_bwd_unit, kernel_mvm_unit)


class _UnitMVM(torch.autograd.Function):
    """``kappa(u, w) @ v`` on pre-scaled fp32 inputs, with the kernel pair
    as its forward and backward."""

    @staticmethod
    def forward(ctx, u, w, v, kind):
        ctx.kind = kind
        # Tensors unpacked from saved_tensors need not keep their identity.
        ctx.same = u is w
        ctx.save_for_backward(u, w, v)
        return kernel_mvm_unit(u.detach(), w.detach(), v.detach(), kind)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        u, w, v = (t.detach() for t in ctx.saved_tensors)
        g = g.to(torch.float32).contiguous()
        need_u, need_w, need_v, _ = ctx.needs_input_grad
        dv = kernel_mvm_unit(w, u, g, ctx.kind) if need_v else None
        if ctx.same:
            du = kernel_mvm_bwd_fused_unit(u, g, v, ctx.kind) if need_u else None
            return du, None, dv, None
        du = kernel_mvm_bwd_unit(u, w, g, v, ctx.kind) if need_u else None
        dw = kernel_mvm_bwd_unit(w, u, v, g, ctx.kind) if need_w else None
        return du, dw, dv, None


def kernel_mvm(x1: torch.Tensor, x2: torch.Tensor, v: torch.Tensor,
               params: HyperParams, kind: Optional[str] = None) -> torch.Tensor:
    """K(x1, x2; theta) @ v via the distance-tile kernels, differentiable in
    ``x1``, ``x2``, ``v`` and the hyperparameters.

    Args:
      x1: (n, d); x2: (m, d); v: (m, s) or (m,). With lane-stacked
        ``params`` ((B, d) lengthscales, (B,) signal) v is (B, m, s) and x1,
        x2 are shared (n, d) or per lane (B, n, d): one launch of each
        kernel serves all B lanes.
      kind: registered kernel name; defaults to ``params.kernel``.
    Returns:
      (n, s) or (n,) in x1.dtype; (B, n, s) for lanes.
    """
    kind = resolve_kind(kind, params)
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    ell, sig2 = params.lengthscales, params.signal**2
    if params.lanes is not None:
        ell, sig2 = ell.unsqueeze(-2), sig2.view(-1, 1, 1)
    u = (x1 / ell).to(torch.float32).contiguous()
    w = u if x2 is x1 else (x2 / ell).to(torch.float32).contiguous()
    out = _UnitMVM.apply(u, w, v.to(torch.float32).contiguous(), kind)
    out = (sig2 * out).to(x1.dtype)
    return out[:, 0] if squeeze else out


def h_mvm(x: torch.Tensor, v: torch.Tensor, params: HyperParams,
          kind: Optional[str] = None) -> torch.Tensor:
    """H_theta @ v = K @ v + sigma^2 v via the distance-tile kernels."""
    noise_var = params.noise**2
    if params.lanes is not None:
        noise_var = noise_var[:, None, None]
    return kernel_mvm(x, x, v, params, kind=kind) + noise_var * v


def matern_mvm(x1: torch.Tensor, x2: torch.Tensor, v: torch.Tensor,
               params: HyperParams) -> torch.Tensor:
    """The reference's original Matérn-3/2 entry point: :func:`kernel_mvm`
    with ``kind="matern32"`` (the kernels tile on their own, so there is no
    ``bm``/``bn``/``interpret``)."""
    return kernel_mvm(x1, x2, v, params, kind="matern32")
