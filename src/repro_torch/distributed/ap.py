"""Distributed alternating projections with per-shard greedy block
selection; port of ``repro.distributed.ap``.

The paper's AP (Alg. 2) picks the single globally worst block per
iteration. The distributed variant applies the greedy rule within each
shard: every position solves its own worst local block at once, then the
residual is updated globally with one ring sweep over the (block, delta)
pairs. Simultaneous disjoint block updates are one sweep of damped block
Jacobi over the selected blocks, not the paper's sequential AP, and the
raw simultaneous update diverges when the blocks are kernel-coupled; each
shard's correction is therefore scaled by ``omega / P`` (the additive
Schwarz safeguard: for SPD H the scaled update converges on any mesh of P
shards whenever ``omega < 2``). Epoch accounting is ``b * P / n`` of an
epoch per iteration.

Per position: the Cholesky factors of its diagonal blocks
(:meth:`repro_torch.solvers.operator.HOperator.all_block_cholesky`), the
block chosen on the device (``argmax`` of the blocks' Frobenius norms, read
with ``index_select``: the host never waits for it), and every residual
update a ring sweep of ``K(x_loc, x_blk_j) @ delta_j`` slabs on the forward
kernel (:func:`repro_torch.kernels.ops.kernel_mvm`), plus the own block's
noise term. A call launches the forward kernel P^2 times for the initial
residual and P^2 times per iteration.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.ring import params_on, ring_sweep
from repro_torch.distributed.sharding import RowSharded, as_row_sharded
from repro_torch.gp.hyperparams import HyperParams
from repro_torch.kernels.ops import kernel_mvm
from repro_torch.launch.mesh import Mesh
from repro_torch.solvers.operator import HOperator
from repro_torch.solvers.precond import cholesky_solve


def distributed_ap_sweeps(x, b_rhs, v0, params: HyperParams, mesh: Mesh,
                          block_size: int, num_iters: int,
                          kind: str = "matern32",
                          omega: float = 0.3) -> tuple:
    """Run ``num_iters`` per-shard-greedy AP iterations on ``H v = b_rhs``.

    Args:
      x: (n, d), b_rhs: (n, t) targets, v0: (n, t) warm start; each a
        :class:`RowSharded` over the mesh's row axes (tensors are split so
        first). ``block_size`` must divide every shard's rows.
    Returns:
      ``(v, r)``: the solution and the tracked residual ``b - H v``, both
      :class:`RowSharded`.
    """
    x, b, v = (as_row_sharded(t, mesh) for t in (x, b_rhs, v0))
    n_loc = x.pieces[0].shape[0]
    if n_loc % block_size != 0:
        raise ValueError(f"block_size={block_size} does not divide the "
                         f"{n_loc} rows of a shard")
    nb = n_loc // block_size
    # Additive-Schwarz safeguard: P simultaneous block corrections can each
    # overshoot along shared kernel-coupled directions; 1/P scaling bounds
    # the combined step (spectral radius < 1 for omega < 2, any mesh).
    omega_eff = omega / x.num_shards
    at = [params_on(params, dev) for dev in mesh.devices]
    xs = x.pieces

    def slab(p, bufs, home):
        return kernel_mvm(xs[p], bufs[0], bufs[1], at[p], kind=kind)

    with torch.no_grad():
        chols = [HOperator(x=xp, params=ap_, kind=kind, backend="cuda")
                 .all_block_cholesky(block_size) for xp, ap_ in zip(xs, at)]
        noise_var = [ap_.noise**2 for ap_ in at]
        v_loc = list(v.pieces)
        # Initial local residual: r_loc = b_loc - H[loc, :] v (one sweep).
        kv = ring_sweep(mesh, [(xp, vp) for xp, vp in zip(xs, v_loc)], slab,
                        axes=x.axes)
        r = [bp - (kvp + nv * vp) for bp, kvp, nv, vp in
             zip(b.pieces, kv, noise_var, v_loc)]
        offsets = torch.arange(block_size, device=xs[0].device)
        for _ in range(num_iters):
            rows, deltas, pairs = [], [], []
            for p, (xp, rp) in enumerate(zip(xs, r)):
                # Per-shard greedy: worst local block by Frobenius norm.
                i = torch.argmax(torch.sum(
                    rp.reshape(nb, block_size, -1) ** 2, dim=(1, 2)))
                idx = i * block_size + offsets.to(xp.device)
                delta = omega_eff * cholesky_solve(
                    rp.index_select(0, idx)[None],
                    chols[p].index_select(0, i.reshape(1)))[0]
                v_loc[p] = v_loc[p].index_add(0, idx, delta)
                rows.append(idx)
                deltas.append(delta)
                pairs.append((xp.index_select(0, idx), delta))
            # Global residual update: every shard's (x_blk, delta) rides
            # the ring once; each position subtracts K(x_loc, x_blk_j)
            # delta_j (+ the noise term for its own rows).
            upd = ring_sweep(mesh, pairs, slab, axes=x.axes)
            r = [(rp - up).index_add(0, idx, nv * dp, alpha=-1.0)
                 for rp, up, idx, nv, dp in
                 zip(r, upd, rows, noise_var, deltas)]
    return (RowSharded(v_loc, mesh, x.axes), RowSharded(r, mesh, x.axes))
