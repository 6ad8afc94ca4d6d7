"""Alternating projections for batched GP systems (Algorithm 2, Wu et al.).

Port of ``repro.solvers.ap``. Per iteration: pick the block with the
largest Frobenius norm of the block residual (across all t systems), solve
the (b x b) diagonal block against the block residual with its cached
Cholesky factor, update the solution block and the FULL residual through
one (n x b) column slab of H. One iteration is b/n of an epoch.

The block index stays on the device (``argmax`` feeds ``index_select``);
the host reads the stopping rule once per iteration, as the port's CG does
(counted in ``SolveResult.host_syncs``).
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


def solve_ap(
    op: HOperator,
    b: torch.Tensor,
    v0: Optional[torch.Tensor],
    cfg: SolverConfig,
    block_chols: Optional[torch.Tensor] = None,
) -> SolveResult:
    """Alternating projections over row blocks of the system ``H V = b``.

    Args:
      op: matrix-free `HOperator` for ``H = K(x, x) + sigma^2 I`` (n x n).
      b: (n, t) right-hand sides ``[y | b_1..b_s]``.
      v0: (n, t) warm start, or None for the zero cold start.
      cfg: solver config; ``block_size`` must divide n (pad with
        :func:`repro_torch.data.synthetic.pad_to_block_multiple`).
      block_chols: per-block Cholesky factors (n/b, b, b); computed here
        when None.
    Returns:
      `SolveResult`; ``epochs = iters * block_size / n``, ``mvms`` 1 (the
      initial residual).
    """
    n, bs = op.n, cfg.block_size
    if n % bs != 0:
        raise ValueError(f"n={n} must be a multiple of block_size={bs}")
    nb = n // bs
    if block_chols is None:
        block_chols = op.all_block_cholesky(bs)
    sysn = normalise_system(b, v0)
    max_iters = max_iters_from_epochs(cfg.max_epochs, float(nb))
    hist = history_init(cfg, dtype=b.dtype, device=b.device)

    v = sysn.v0
    r = sysn.b - op.mvm(v)
    res_y, res_z = residual_norms(r)
    offsets = torch.arange(bs, device=b.device)
    t = syncs = 0
    while t < max_iters:
        syncs += 1
        if not bool(not_converged(res_y, res_z, cfg.tolerance)):
            break
        i = torch.argmax(torch.sum(r.reshape(nb, bs, -1) ** 2, dim=(1, 2)))
        start = i * bs
        idx = start + offsets
        delta = torch.cholesky_solve(r.index_select(0, idx),
                                     block_chols.index_select(0, i[None])[0])
        v = v.index_add(0, idx, delta)
        r = r - op.col_block_mvm(start, bs, delta)
        res_y, res_z = residual_norms(r)
        history_record(hist, t, res_y, res_z)
        t += 1
    return SolveResult(
        v=denormalise(v, sysn.scale), res_y=res_y, res_z=res_z, iters=t,
        epochs=t * bs / n, mvms=1, host_syncs=syncs, res_history=hist)
