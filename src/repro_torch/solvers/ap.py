"""Alternating projections for batched GP systems (Algorithm 2, Wu et al.).

Port of ``repro.solvers.ap``. Per iteration: pick the block with the
largest Frobenius norm of the block residual (across all t systems), solve
the (b x b) diagonal block against the block residual with its cached
Cholesky factor, update the solution block and the FULL residual through
one (n x b) column slab of H. One iteration is b/n of an epoch.

Each lane picks its own block: the block indices stay on the device
(``argmax`` per lane), the lanes' rows are gathered into one (B, b, t)
operand and the slab is one lane-stacked launch. The host reads "any lane
active" once per iteration (counted in ``SolveResult.host_syncs``).
"""
from __future__ import annotations

from typing import Optional

import torch

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
from repro_torch.solvers.precond import cholesky_solve


def solve_ap(
    op: HOperator,
    b: torch.Tensor,
    v0: Optional[torch.Tensor],
    cfg: SolverConfig,
    block_chols: Optional[torch.Tensor] = None,
    numerics: Optional[SolverNumerics] = None,
) -> SolveResult:
    """Alternating projections over row blocks of the system ``H V = b``.

    Args:
      op: matrix-free `HOperator` for ``H = K(x, x) + sigma^2 I`` (n x n;
        lane-stacked params for lanes).
      b: (n, t) right-hand sides ``[y | b_1..b_s]``, or (B, n, t) lanes.
      v0: warm start shaped like ``b``, or None for the zero cold start.
      cfg: solver config; ``block_size`` must divide n (pad with
        :func:`repro_torch.data.synthetic.pad_to_block_multiple`).
      block_chols: per-block Cholesky factors (n/b, b, b), (B, n/b, b, b)
        for lanes; computed here when None.
      numerics: tolerance and epoch budget, scalar or per lane.
    Returns:
      `SolveResult`; ``epochs = iters * block_size / n``, ``mvms`` 1 (the
      initial residual).
    """
    n, bs = op.n, cfg.block_size
    if n % bs != 0:
        raise ValueError(f"n={n} must be a multiple of block_size={bs}")
    nb = n // bs
    sysl = as_lanes(op, b, v0, cfg, numerics)
    op, lanes = sysl.op, sysl.lanes
    if block_chols is None:
        block_chols = op.all_block_cholesky(bs)
    elif sysl.single:
        block_chols = block_chols[None]
    sysn = normalise_system(sysl.b, sysl.v0)
    max_iters, cap = sysl.caps(float(nb))
    tol = sysl.num.tolerance
    hist = history_init(cfg, lanes, dtype=b.dtype, device=b.device)

    v = sysn.v0
    r = sysn.b - op.mvm(v)
    res_y, res_z = residual_norms(r)
    t = torch.zeros(lanes, dtype=torch.int32, device=b.device)
    steps = syncs = 0
    chols = block_chols.reshape(lanes * nb, bs, bs)
    block_base = torch.arange(0, lanes * nb, nb, device=b.device)
    t_dim = sysn.b.shape[-1]
    while steps < cap:
        # torch-lint: disable=trace-host-sync -- the one stopping read per iteration (any lane active)
        active, run = keep_going(not_converged(res_y, res_z, tol), t,
                                 max_iters)
        syncs += 1
        if not run:
            break
        keep = masked(active, lanes)
        i = torch.argmax(torch.sum(r.reshape(lanes, nb, bs, -1) ** 2,
                                   dim=(2, 3)), dim=1)
        start = i * bs
        rows = op.row_index(start, bs)  # each lane's block in (B * n) rows
        delta = cholesky_solve(
            r.reshape(-1, t_dim).index_select(0, rows).reshape(lanes, bs, -1),
            chols.index_select(0, i + block_base))
        v_new = v.reshape(-1, t_dim).index_add(
            0, rows, delta.reshape(-1, t_dim)).reshape(v.shape)
        r_new = r - op.col_block_mvm(start, bs, delta)
        ry, rz = residual_norms(r_new)
        history_record(hist, steps, ry, rz, keep)
        v, r = keep(v_new, v), keep(r_new, r)
        res_y, res_z = keep(ry, res_y), keep(rz, res_z)
        if lanes > 1:
            t = t + active.to(torch.int32)
        steps += 1
    return finish(sysl, v=denormalise(v, sysn.scale), res_y=res_y,
                  res_z=res_z, t=t, epochs_per_iter=bs / n, steps=steps,
                  mvms=1, syncs=syncs, hist=hist)
