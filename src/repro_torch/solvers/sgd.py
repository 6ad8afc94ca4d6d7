"""Stochastic gradient descent for batched GP systems (Algorithm 3, Lin et al.).

Port of ``repro.solvers.sgd``. Minimises the quadratic (paper eq. 8) with
minibatch gradients: pick a row block, compute the batch gradient
``g[blk] = H[blk, :] @ v - b[blk]`` (one (b x n) row slab of H), take a
momentum step on the full vector, and refresh the running residual
estimate ``r[blk] <- -g[blk]``. The estimate starts at ``b`` (stale under
warm starts until refreshed); ``exact_final_residual`` spends one more
epoch on an exact residual for reporting. A lane whose summed residual
goes past its ``divergence_threshold`` (or non-finite) freezes. Batch 500,
momentum 0.9, no Polyak averaging (the paper's settings).

The batch schedule is injectable: JAX's threefry draws cannot be replayed
in torch, so ``batch_idx`` hands over one block index per iteration and
lane (how a test replays the reference's ``split``/``randint`` draws);
otherwise each lane's indices come from its own ``torch.Generator``,
:data:`SCHEDULE_CHUNK` at a time, and stay on the device. Each lane's rows
are gathered into one (B, b, d) operand: one slab launch for all lanes.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
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
    lane_diverged,
    masked,
    normalise_system,
    not_converged,
    residual_norms,
)
from repro_torch.solvers.operator import HOperator

# Block indices drawn from a generator per draw. A solve to tolerance may
# run up to MAX_SOLVER_ITERS iterations, so the schedule is never drawn
# whole.
SCHEDULE_CHUNK = 1024

Generators = Union[None, torch.Generator, Sequence[torch.Generator]]


def draw_schedule(generator: Optional[torch.Generator], num_blocks: int,
                  count: int) -> list:
    """``count`` block indices in ``[0, num_blocks)`` from ``generator``
    (on its device), as Python ints."""
    return _draw(generator, num_blocks, count).tolist()


def _draw(generator: Optional[torch.Generator], num_blocks: int,
          count: int) -> torch.Tensor:
    device = generator.device if generator is not None else "cpu"
    return torch.randint(0, num_blocks, (count,), generator=generator,
                         device=device)


class _Schedule:
    """Each lane's block index per iteration: handed over (``batch_idx``,
    (B, iters)) or drawn from the lanes' generators
    :data:`SCHEDULE_CHUNK` at a time. One lane's index is a Python int (its
    slab is then a view, as the host reads a chunk at a time); B lanes'
    are a (B,) device tensor."""

    def __init__(self, batch_idx, generators: list, num_blocks: int,
                 max_iters: int, device):
        self.lanes = len(generators)
        self.given = None
        if batch_idx is not None:
            given = torch.as_tensor(np.asarray(batch_idx), dtype=torch.int64)
            self.given = given.reshape(self.lanes, -1)
            if self.lanes > 1:
                self.given = self.given.to(device)
            else:
                self.given = self.given[0].tolist()
        self.gens, self.nb, self.max_iters = generators, num_blocks, max_iters
        self.device, self.chunk, self.lo = device, None, 0

    def __call__(self, j: int):
        if self.given is not None:
            if j >= len(self.given[0] if self.lanes > 1 else self.given):
                raise ValueError("batch_idx is shorter than the iterations run")
            return self.given[:, j] if self.lanes > 1 else self.given[j]
        if self.chunk is None or j >= self.lo + len(self.chunk[0]):
            self.lo = j
            count = min(SCHEDULE_CHUNK, self.max_iters - j)
            drawn = [_draw(g, self.nb, count) for g in self.gens]
            self.chunk = (torch.stack(drawn).to(self.device) if self.lanes > 1
                          else [drawn[0].tolist()])
        return (self.chunk[:, j - self.lo] if self.lanes > 1
                else self.chunk[0][j - self.lo])


def solve_sgd(
    op: HOperator,
    b: torch.Tensor,
    v0: Optional[torch.Tensor],
    cfg: SolverConfig,
    batch_idx=None,
    generator: Generators = None,
    numerics: Optional[SolverNumerics] = None,
) -> SolveResult:
    """SGD with momentum on ``H V = b``.

    Args:
      op: matrix-free `HOperator` for ``H = K(x, x) + sigma^2 I`` (n x n;
        lane-stacked params for lanes).
      b: (n, t) right-hand sides ``[y | b_1..b_s]``, or (B, n, t) lanes.
      v0: warm start shaped like ``b``, or None for the zero cold start.
      cfg: solver config; ``batch_size`` must divide n.
      batch_idx: block index (in ``[0, n / batch_size)``) of each
        iteration, in order ((B, iters) for lanes); at least as many as
        the iterations run.
      generator: draws the schedule when ``batch_idx`` is None: one
        generator, or one per lane (torch's default generator when None).
      numerics: tolerance, budget, learning rate, momentum and divergence
        threshold, scalar or per lane (the config's when None).
    Returns:
      `SolveResult`; ``epochs = iters * batch_size / n`` (+1 with
      ``exact_final_residual``).
    """
    n, bs = op.n, cfg.batch_size
    if n % bs != 0:
        raise ValueError(f"n={n} must be a multiple of batch_size={bs}")
    nb = n // bs
    sysl = as_lanes(op, b, v0, cfg, numerics)
    op, lanes, num = sysl.op, sysl.lanes, sysl.num
    max_iters, cap = sysl.caps(float(nb))
    gens = (list(generator) if isinstance(generator, (list, tuple))
            else [generator] * lanes)
    schedule = _Schedule(batch_idx, gens, nb, cap, b.device)
    hist = history_init(cfg, lanes, dtype=b.dtype, device=b.device)
    step = (num.learning_rate / bs).reshape(-1, 1, 1)
    momentum = num.momentum.reshape(-1, 1, 1)

    sysn = normalise_system(sysl.b, sysl.v0)
    bn = sysn.b
    v = sysn.v0
    m = torch.zeros_like(v)
    r = bn.clone()  # Alg. 3: r <- b
    res_y, res_z = residual_norms(r)
    t = torch.zeros(lanes, dtype=torch.int32, device=b.device)
    steps = syncs = 0
    t_dim = bn.shape[-1]
    while steps < cap:
        go = not_converged(res_y, res_z, num.tolerance) & ~lane_diverged(
            res_y, res_z, num.divergence_threshold)
        # torch-lint: disable=trace-host-sync -- the one stopping read per iteration (any lane active)
        active, run = keep_going(go, t, max_iters)
        syncs += 1
        if not run:
            break
        with stage("solve.iter"):
            # torch-lint: disable=freeze-mask -- generators advance on stopped lanes by design: a stopped lane never resumes and keep() drops its update
            start = schedule(steps) * bs
            g = op.row_block_mvm(start, bs, v) - op._rows(bn, start, bs)
            # m <- rho m - (gamma / b) g on the full vector: outside the batch
            # the gradient is 0, so only the batch rows take the second term.
            if lanes == 1:  # an int start: the rows are views, set in place
                blk = slice(start, start + bs)
                m.mul_(momentum)
                m[:, blk] -= step * g
                v = v + m
                r[:, blk] = -g
                res_y, res_z = residual_norms(r)
                history_record(hist, steps, res_y, res_z, masked(active, 1))
            else:
                keep = masked(active, lanes)
                rows = op.row_index(start, bs)
                m_new = (momentum * m).reshape(-1, t_dim)
                m_new = m_new.index_copy(
                    0, rows, m_new.index_select(0, rows)
                    - (step * g).reshape(-1, t_dim)).reshape(m.shape)
                v_new = v + m_new
                r_new = r.reshape(-1, t_dim).index_copy(
                    0, rows, -g.reshape(-1, t_dim)).reshape(r.shape)
                ry, rz = residual_norms(r_new)
                history_record(hist, steps, ry, rz, keep)
                v, m, r = keep(v_new, v), keep(m_new, m), keep(r_new, r)
                res_y, res_z = keep(ry, res_y), keep(rz, res_z)
                t = t + active.to(torch.int32)
            steps += 1
    extra, mvms = 0.0, 0
    if cfg.exact_final_residual:
        res_y, res_z = residual_norms(bn - op.mvm(v))
        extra, mvms = 1.0, 1
    return finish(sysl, v=denormalise(v, sysn.scale), res_y=res_y,
                  res_z=res_z, t=t, epochs_per_iter=bs / n, steps=steps,
                  mvms=mvms, syncs=syncs, hist=hist, extra_epochs=extra)
