"""Preconditioned conjugate gradients for batched GP systems (Algorithm 1).

Port of ``repro.solvers.cg``. Solves ``H [v_y, v_1..v_s] = [y, b_1..b_s]``
with one shared MVM per iteration and per-column step sizes. The recursion
is the standard PCG ``d <- p`` (the paper's ``d <- b`` would break warm
starting), and both 0/0 guards of the reference are kept.

The reference runs the loop under ``lax.while_loop`` on the device; here
the host reads the stopping rule once per iteration (one device sync each,
counted in ``SolveResult.host_syncs``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.solvers.base import (
    SolveResult,
    SolverConfig,
    denormalise,
    history_init,
    history_record,
    max_iters_from_epochs,
    normalise_system,
    not_converged,
    residual_norms,
)
from repro_torch.solvers.operator import HOperator
from repro_torch.solvers.precond import Preconditioner, build_preconditioner


def _guarded_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den where den > 0, else 0 (converged columns: 0/0 guard)."""
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def solve_cg(
    op: HOperator,
    b: torch.Tensor,
    v0: Optional[torch.Tensor],
    cfg: SolverConfig,
    precond: Optional[Preconditioner] = None,
) -> SolveResult:
    """Preconditioned CG on the batched system ``H V = b``.

    Args:
      op: matrix-free `HOperator` for ``H = K(x, x) + sigma^2 I``.
      b: (n, t) right-hand sides ``[y | b_1..b_s]``.
      v0: (n, t) warm start, or None for the zero cold start.
      cfg: solver config (tolerance, epoch budget, preconditioner rank).
      precond: pre-built preconditioner (built from ``cfg`` when None).
    Returns:
      `SolveResult` with (n, t) solutions; ``epochs == iters``.
    """
    if precond is None:
        precond = build_preconditioner(op, cfg.precond_rank)
    sysn = normalise_system(b, v0)
    max_iters = max_iters_from_epochs(cfg.max_epochs, 1.0)
    hist = history_init(cfg, dtype=b.dtype, device=b.device)

    v = sysn.v0
    r = sysn.b - op.mvm(v)
    d = precond.apply(r)
    gamma = torch.sum(r * d, dim=0)
    res_y, res_z = residual_norms(r)
    t, mvms, syncs = 0, 1, 0
    while t < max_iters:
        syncs += 1
        if not bool(not_converged(res_y, res_z, cfg.tolerance)):
            break
        hd = op.mvm(d)
        mvms += 1
        alpha = _guarded_div(gamma, torch.sum(d * hd, dim=0))
        v = v + alpha * d
        r = r - alpha * hd
        p = precond.apply(r)
        gamma_new = torch.sum(r * p, dim=0)
        d = p + _guarded_div(gamma_new, gamma) * d
        gamma = gamma_new
        res_y, res_z = residual_norms(r)
        history_record(hist, t, res_y, res_z)
        t += 1
    return SolveResult(
        v=denormalise(v, sysn.scale), res_y=res_y, res_z=res_z,
        iters=t, epochs=float(t), mvms=mvms, host_syncs=syncs,
        res_history=hist,
    )
