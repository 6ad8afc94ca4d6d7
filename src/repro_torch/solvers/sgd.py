"""Stochastic gradient descent for batched GP systems (Algorithm 3, Lin et al.).

Port of ``repro.solvers.sgd``. Minimises the quadratic (paper eq. 8) with
minibatch gradients: pick a row block, compute the batch gradient
``g[blk] = H[blk, :] @ v - b[blk]`` (one (b x n) row slab of H), take a
momentum step on the full vector, and refresh the running residual
estimate ``r[blk] <- -g[blk]``. The estimate starts at ``b`` (stale under
warm starts until refreshed); ``exact_final_residual`` spends one more
epoch on an exact residual for reporting. A solve whose summed residual
goes past ``divergence_threshold`` (or non-finite) stops. Batch 500,
momentum 0.9, no Polyak averaging (the paper's settings).

The batch schedule is injectable: JAX's threefry draws cannot be replayed
in torch, so ``batch_idx`` hands over one block index per iteration (how a
test replays the reference's ``split``/``randint`` draws); otherwise the
indices come from a ``torch.Generator``, :data:`SCHEDULE_CHUNK` at a time.
With the index on the host the slab's ``start`` is a Python int, and the
host reads the stopping rule once per iteration.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence

import torch

from repro_torch.solvers.base import (
    SolveResult,
    SolverConfig,
    denormalise,
    history_init,
    history_record,
    lane_diverged,
    max_iters_from_epochs,
    normalise_system,
    not_converged,
    residual_norms,
)
from repro_torch.solvers.operator import HOperator

# Block indices drawn from a generator per device round trip. A solve to
# tolerance may run up to MAX_SOLVER_ITERS iterations, so the schedule is
# never drawn whole.
SCHEDULE_CHUNK = 1024


def draw_schedule(generator: Optional[torch.Generator], num_blocks: int,
                  count: int) -> list:
    """``count`` block indices in ``[0, num_blocks)`` from ``generator``
    (on its device), as Python ints."""
    device = generator.device if generator is not None else "cpu"
    return torch.randint(0, num_blocks, (count,), generator=generator,
                         device=device).tolist()


def _schedule(batch_idx: Optional[Sequence[int]],
              generator: Optional[torch.Generator], num_blocks: int,
              max_iters: int) -> Iterator[int]:
    if batch_idx is not None:
        yield from (int(i) for i in batch_idx)
        raise ValueError("batch_idx is shorter than the iterations run")
    drawn = 0
    while drawn < max_iters:
        chunk = draw_schedule(generator, num_blocks,
                              min(SCHEDULE_CHUNK, max_iters - drawn))
        drawn += len(chunk)
        yield from chunk


def solve_sgd(
    op: HOperator,
    b: torch.Tensor,
    v0: Optional[torch.Tensor],
    cfg: SolverConfig,
    batch_idx: Optional[Sequence[int]] = None,
    generator: Optional[torch.Generator] = None,
) -> SolveResult:
    """SGD with momentum on ``H V = b``.

    Args:
      op: matrix-free `HOperator` for ``H = K(x, x) + sigma^2 I`` (n x n).
      b: (n, t) right-hand sides ``[y | b_1..b_s]``.
      v0: (n, t) warm start, or None for the zero cold start.
      cfg: solver config; ``batch_size`` must divide n,
        ``learning_rate``/``momentum`` drive the update.
      batch_idx: block index (in ``[0, n / batch_size)``) of each iteration,
        in order; at least as many as the iterations run.
      generator: draws the schedule when ``batch_idx`` is None (torch's
        default generator when both are None).
    Returns:
      `SolveResult`; ``epochs = iters * batch_size / n`` (+1 with
      ``exact_final_residual``).
    """
    n, bs = op.n, cfg.batch_size
    if n % bs != 0:
        raise ValueError(f"n={n} must be a multiple of batch_size={bs}")
    nb = n // bs
    sysn = normalise_system(b, v0)
    max_iters = max_iters_from_epochs(cfg.max_epochs, float(nb))
    schedule = _schedule(batch_idx, generator, nb, max_iters)
    hist = history_init(cfg, dtype=b.dtype, device=b.device)
    step = cfg.learning_rate / bs

    bn = sysn.b
    v = sysn.v0
    m = torch.zeros_like(v)
    r = bn.clone()  # Alg. 3: r <- b
    res_y, res_z = residual_norms(r)
    t = syncs = 0
    while t < max_iters:
        syncs += 1
        go = not_converged(res_y, res_z, cfg.tolerance) & ~lane_diverged(
            res_y, res_z, cfg.divergence_threshold)
        if not bool(go):
            break
        start = next(schedule) * bs
        blk = slice(start, start + bs)
        g = op.row_block_mvm(start, bs, v) - bn[blk]
        # m <- rho m - (gamma / b) g on the full vector: outside the batch
        # the gradient is 0, so only the batch rows take the second term.
        m.mul_(cfg.momentum)
        m[blk] -= step * g
        v = v + m
        r[blk] = -g
        res_y, res_z = residual_norms(r)
        history_record(hist, t, res_y, res_z)
        t += 1
    epochs, mvms = t * bs / n, 0
    if cfg.exact_final_residual:
        res_y, res_z = residual_norms(bn - op.mvm(v))
        epochs, mvms = epochs + 1.0, 1
    return SolveResult(
        v=denormalise(v, sysn.scale), res_y=res_y, res_z=res_z, iters=t,
        epochs=epochs, mvms=mvms, host_syncs=syncs, res_history=hist)
