"""Preconditioned conjugate gradients for batched GP systems (Algorithm 1).

Port of ``repro.solvers.cg``. Solves ``H [v_y, v_1..v_s] = [y, b_1..b_s]``
with one shared MVM per iteration and per-column step sizes. The recursion
is the standard PCG ``d <- p`` (the paper's ``d <- b`` would break warm
starting), and both 0/0 guards of the reference are kept.

The reference runs the loop under ``lax.while_loop`` on the device; here
the host reads "any lane active" once per iteration (one device sync for
all lanes, counted in ``SolveResult.host_syncs``), and each iteration's MVM
is one lane-stacked product: one kernel launch for all B lanes.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.obs.trace import stage
from repro_torch.solvers.base import (
    SolveResult,
    SolverConfig,
    SolverNumerics,
    as_lanes,
    denormalise,
    finish,
    history_init,
    history_record,
    keep_going,
    masked,
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
    numerics: Optional[SolverNumerics] = None,
) -> SolveResult:
    """Preconditioned CG on the batched system ``H V = b``.

    Args:
      op: matrix-free `HOperator` for ``H = K(x, x) + sigma^2 I`` (lane-
        stacked params for lanes).
      b: (n, t) right-hand sides ``[y | b_1..b_s]``, or (B, n, t) lanes.
      v0: warm start shaped like ``b``, or None for the zero cold start.
      cfg: solver config (preconditioner rank, ring length).
      precond: pre-built preconditioner (built from ``cfg`` when None).
      numerics: tolerance and epoch budget, scalar or per lane (the
        config's when None).
    Returns:
      `SolveResult`; ``epochs == iters``.
    """
    sysl = as_lanes(op, b, v0, cfg, numerics)
    op, lanes = sysl.op, sysl.lanes
    if precond is None:
        with stage("solve.precond"):
            precond = build_preconditioner(op, cfg.precond_rank)
    precond = precond.lifted()
    sysn = normalise_system(sysl.b, sysl.v0)
    max_iters, cap = sysl.caps(1.0)
    tol = sysl.num.tolerance
    hist = history_init(cfg, lanes, dtype=b.dtype, device=b.device)

    v = sysn.v0
    r = sysn.b - op.mvm(v)
    d = precond.apply(r)
    gamma = torch.sum(r * d, dim=-2, keepdim=True)  # (B, 1, t)
    res_y, res_z = residual_norms(r)
    t = torch.zeros(lanes, dtype=torch.int32, device=b.device)
    steps, mvms, syncs = 0, 1, 0
    while steps < cap:
        # torch-lint: disable=trace-host-sync -- the one stopping read per iteration (any lane active)
        active, run = keep_going(not_converged(res_y, res_z, tol), t,
                                 max_iters)
        syncs += 1
        if not run:
            break
        with stage("solve.iter"):
            keep = masked(active, lanes)
            hd = op.mvm(d)
            mvms += 1
            alpha = _guarded_div(gamma,
                                 torch.sum(d * hd, dim=-2, keepdim=True))
            v_new = v + alpha * d
            r_new = r - alpha * hd
            p = precond.apply(r_new)
            gamma_new = torch.sum(r_new * p, dim=-2, keepdim=True)
            d_new = p + _guarded_div(gamma_new, gamma) * d
            ry, rz = residual_norms(r_new)
            history_record(hist, steps, ry, rz, keep)
            v, r, d = keep(v_new, v), keep(r_new, r), keep(d_new, d)
            gamma, res_y, res_z = keep(gamma_new, gamma), keep(ry, res_y), \
                keep(rz, res_z)
            if lanes > 1:
                t = t + active.to(torch.int32)
            steps += 1
    return finish(sysl, v=denormalise(v, sysn.scale), res_y=res_y,
                  res_z=res_z, t=t, epochs_per_iter=1.0, steps=steps,
                  mvms=mvms, syncs=syncs, hist=hist)
