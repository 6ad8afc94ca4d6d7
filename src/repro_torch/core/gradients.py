"""Assembly of the stochastic marginal-likelihood gradient (paper eq. 5).

Port of ``repro.core.gradients``. With the solves ``V = [v_y, v_1..v_s]``
held fixed, every hyperparameter's gradient is the gradient of the scalar

    S(theta) = sum_t c_t * a_t^T H(theta) b_t

(``c = [1/2, -1/(2s), ...]``; ``b = a`` for pathwise, ``b = [v_y | z]`` for
standard). One reverse pass of ``torch.autograd`` gives all of them, as the
reference runs ``jax.value_and_grad``. The MVM differentiated follows the
operator's backend:

* ``cuda``: :func:`repro_torch.kernels.ops.kernel_mvm`, whose
  ``autograd.Function`` runs the forward tile kernel once and, since x is
  both arguments, the backward tile kernel once for ``du + dw`` (the fused
  call on ``[g | v]`` and ``[v | g]``) on CUDA tensors, and their plain
  versions on CPU tensors. Nothing of size n^2 is kept.
* ``streamed`` and ``dense``: the plain tiled MVM
  :func:`repro_torch.solvers.operator.kernel_mvm_tiled`, as the reference
  differentiates its twin for every backend. Autograd keeps a few (bm, bn)
  tiles per block pair, i.e. a few n^2 * 4 bytes.

Lanes: with lane-stacked params, solutions and targets (B, n, 1+s) the
surrogate is the sum of the lanes' own, so one reverse pass gives every
lane its own gradient; under ``cuda`` that is one forward launch and one
fused backward launch for all B lanes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.estimators import PATHWISE, STANDARD
from repro_torch.gp.hyperparams import HyperParams
from repro_torch.kernels.ops import kernel_mvm
from repro_torch.solvers.operator import kernel_mvm_tiled


class GradAux(NamedTuple):
    """Diagnostics returned alongside the MLL gradient estimate."""

    data_fit: torch.Tensor  # -1/2 y^T v_y
    quad_value: torch.Tensor  # value of the surrogate S


def _weighted_quadratic(params, x, a, b, weights, kind, bm, bn, backend):
    """The surrogate S per lane ((B,), or 0-d for one system)."""
    noise_var = params.noise**2
    if backend == "cuda":
        kb = kernel_mvm(x, x, b, params, kind=kind)
    elif params.lanes is not None:
        kb = torch.stack([kernel_mvm_tiled(x, x, b[l], params.lane(l),
                                           kind=kind, bm=bm, bn=bn)
                          for l in range(params.lanes)])
    else:
        kb = kernel_mvm_tiled(x, x, b, params, kind=kind, bm=bm, bn=bn)
    if params.lanes is not None:
        noise_var = noise_var[:, None, None]
    hb = kb + noise_var * b
    return torch.sum(weights * torch.sum(a * hb, dim=-2), dim=-1)


def mll_grad_estimate(
    x: torch.Tensor,
    y: torch.Tensor,
    params: HyperParams,
    v: torch.Tensor,
    targets: torch.Tensor,
    estimator: str,
    kind: Optional[str] = None,
    bm: int = 1024,
    bn: int = 1024,
    backend: str = "streamed",
) -> tuple[HyperParams, GradAux]:
    """Stochastic gradient of L wrt the raw hyperparameters.

    Args:
      v: (n, 1+s) solver solutions [v_y | v_1..v_s]; (B, n, 1+s) with
        lane-stacked params.
      targets: right-hand sides [y | b_1..b_s], shaped like ``v``.
      backend: the operator's backend; ``cuda`` differentiates the kernel
        pair, any other the plain tiled MVM (tiles ``bm`` x ``bn``).
    Returns:
      (grads as a `HyperParams` of raw-leaf gradients, `GradAux`)
    """
    s = v.shape[-1] - 1
    v = v.detach()
    targets = targets.detach()
    if estimator == STANDARD:
        a = v
        b = torch.cat([v[..., :1], targets[..., 1:]], dim=-1)
    elif estimator == PATHWISE:
        a = b = v
    else:
        raise ValueError(f"unknown estimator {estimator!r}")
    weights = torch.cat([
        torch.full((1,), 0.5, dtype=v.dtype, device=v.device),
        torch.full((s,), -0.5 / s, dtype=v.dtype, device=v.device),
    ])
    leaves = [p.detach().requires_grad_(True) for p in params.leaves]
    with torch.enable_grad():
        quad = _weighted_quadratic(params.with_leaves(leaves), x, a, b,
                                   weights, kind, bm, bn, backend)
        grads = torch.autograd.grad(quad.sum(), leaves)
    data_fit = -0.5 * torch.sum(y * v[..., 0], dim=-1)
    return params.with_leaves(grads), GradAux(data_fit=data_fit,
                                              quad_value=quad.detach())


def exact_grad_reference(x: torch.Tensor, y: torch.Tensor,
                         params: HyperParams,
                         kind: Optional[str] = None) -> HyperParams:
    """Dense-Cholesky exact gradient of the MLL (the paper's reference;
    tests only)."""
    from repro_torch.gp.exact import exact_mll_grad

    return exact_mll_grad(x, y, params, kind=kind)[1]
