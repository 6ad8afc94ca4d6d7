"""Distributed GP outer step on a mesh; port of ``repro.distributed.gp_step``.

Rows of (x, y, probes, solver carry) are sharded over every row axis of the
mesh (:class:`~repro_torch.distributed.sharding.RowSharded`); the H MVM is
the hierarchical ring of :mod:`repro_torch.distributed.ring`. One outer
step:

  1. pathwise targets xi = Phi(x_loc) w + sigma * w_eps, per shard
     (:func:`repro_torch.gp.rff.rff_features` with the handed-over RFF
     draws);
  2. warm-started CG for a FIXED iteration budget (1 iteration = 1 epoch;
     the global residual norms are tracked for reporting, not for
     termination, so the loop reads nothing back to the host);
  3. the solution detached, the pathwise quadratic
     ``sum_t c_t v_t^T H v_t`` differentiated through the ring with
     ``torch.autograd`` (the tiles' backward kernel);
  4. Adam ascent of the (replicated) hyperparameters
     (:func:`repro_torch.train.adam.adam_update`, ``maximize=True``).

The carry (solutions V, row-sharded) is the next step's warm start: the
paper's amortisation. Per step the forward kernel runs (epochs + 2) ring
sweeps of P^2 tiles (the initial residual, the CG iterations, the
gradient's forward) on a mesh of P positions; the gradient's backward
launches the backward kernel once per position for its own tile (the fused
call) and twice per other tile (du and dw).

:func:`lower_gp_outer_step` is the dry-run's counterpart of the
reference's AOT lowering: the step for a mesh, its state and inputs as
fake tensors with their placements (rows over the mesh's row axes, the
rest replicated), and the cell's model flops.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.distributed.ring import params_on, ring_h_mvm
from repro_torch.distributed.sharding import (NamedSharding, RowSharded,
                                              as_row_sharded, row_axes)
from repro_torch.gp.hyperparams import HyperParams
from repro_torch.gp.rff import RFFState, rff_features
from repro_torch.launch.mesh import Mesh
from repro_torch.train.adam import AdamConfig, AdamState, adam_update


class GPStepState(NamedTuple):
    params: HyperParams  # replicated: on the mesh's first device
    adam: AdamState
    carry_v: RowSharded  # (n, 1 + s)
    res_y: torch.Tensor
    res_z: torch.Tensor


def _rff_on(rff: RFFState, device) -> RFFState:
    return rff._replace(z=rff.z.to(device), u=rff.u.to(device),
                        w=rff.w.to(device))


def _targets(x: RowSharded, y: RowSharded, params: HyperParams,
             rff: RFFState, w_eps: RowSharded) -> RowSharded:
    """``[y | f + sigma w_eps]`` per shard, f the RFF prior samples."""
    def one(x_loc, y_loc, w_loc):
        p, r = params_on(params, x_loc.device), _rff_on(rff, x_loc.device)
        xi = rff_features(x_loc, r, p) @ r.w + p.noise * w_loc
        return torch.cat([y_loc[:, None], xi], dim=1)

    return x.map(one, y, w_eps)


def _cg_budget(x: RowSharded, b: RowSharded, v0: RowSharded,
               params: HyperParams, mesh: Mesh, iters: int, kind: str,
               tile_dtype=torch.float32) -> tuple:
    """Unpreconditioned CG for a fixed iteration budget (1 iteration = 1
    epoch) on row-sharded vectors; column dots are global reductions.
    Returns (v, relative residual norms per column)."""
    def h(w):
        return ring_h_mvm(x, w, params, mesh, kind=kind, tile_dtype=tile_dtype)

    scale = torch.sqrt((b * b).col_sum()) + 1e-10
    v = v0 / scale
    r = b / scale - h(v)
    d = r
    gamma = (r * r).col_sum()
    for _ in range(iters):
        hd = h(d)
        denom = (d * hd).col_sum()
        alpha = torch.where(denom > 0,
                            gamma / torch.where(denom > 0, denom, 1.0), 0.0)
        v = v + d * alpha
        r = r - hd * alpha
        gamma_new = (r * r).col_sum()
        beta = torch.where(gamma > 0,
                           gamma_new / torch.where(gamma > 0, gamma, 1.0), 0.0)
        d = r + d * beta
        gamma = gamma_new
    res = torch.sqrt((r * r).col_sum())  # relative (b normalised)
    return v * scale, res


def make_gp_outer_step(mesh: Mesh, num_probes: int, solver_epochs: int,
                       kind: str = "matern32", adam_lr: float = 0.03,
                       tile_dtype=torch.float32):
    """``outer_step(state, x, y, rff, w_eps) -> GPStepState`` on ``mesh``.

    ``x`` (n, d), ``y`` (n,) and ``w_eps`` (n, s) are :class:`RowSharded`
    over the mesh's row axes (tensors are split so first); ``rff`` holds
    the fixed draws ``(z, u, w)`` (replicated); ``state.carry_v`` is the
    (n, 1 + s) warm start.
    """
    adam_cfg = AdamConfig(learning_rate=adam_lr)

    def outer_step(state: GPStepState, x, y, rff: RFFState,
                   w_eps) -> GPStepState:
        x, y, w_eps = (as_row_sharded(t, mesh) for t in (x, y, w_eps))
        params = state.params
        with torch.no_grad():
            targets = _targets(x, y, params, rff, w_eps)
            v, res = _cg_budget(x, targets, state.carry_v, params, mesh,
                                solver_epochs, kind, tile_dtype=tile_dtype)
        v = v.detach()

        # Pathwise gradient: 1/2 v_y^T dH v_y - 1/(2s) sum_j v_j^T dH v_j
        s = num_probes
        home = mesh.devices[0]
        weights = torch.cat([
            torch.full((1,), 0.5, dtype=v.dtype, device=home),
            torch.full((s,), -0.5 / s, dtype=v.dtype, device=home)])
        p = params.with_leaves([leaf.detach().requires_grad_(True)
                                for leaf in params.leaves])
        with torch.enable_grad():
            hv = ring_h_mvm(x, v, p, mesh, kind=kind, tile_dtype=tile_dtype)
            quad = torch.sum(weights * (v * hv).col_sum())
            grads = torch.autograd.grad(quad, p.leaves)
        with torch.no_grad():
            new_params, new_adam = adam_update(
                params.with_leaves(grads), state.adam, params, adam_cfg,
                maximize=True)
        return GPStepState(params=new_params, adam=new_adam, carry_v=v,
                           res_y=res[0], res_z=torch.mean(res[1:]))

    return outer_step


class LoweredGPStep(NamedTuple):
    """``lower_gp_outer_step``'s result. ``state`` and ``inputs`` (x, y,
    rff, w_eps) are fake tensors; ``state_shardings`` /
    ``input_shardings`` their placements, leaf for leaf; the state is
    donated (its buffers become the next state's)."""

    step: object
    state: GPStepState
    inputs: tuple
    state_shardings: GPStepState
    input_shardings: tuple
    model_flops: float
    notes: str


def lower_gp_outer_step(shape, mesh: Mesh, tile_dtype=torch.float32
                        ) -> LoweredGPStep:
    """One distributed outer step for the dry-run, with abstract inputs.

    On a mesh of real devices ``step`` runs: shard real tensors of the
    fake inputs' shapes with ``shard_rows`` and call it."""
    from repro_torch.configs.gp_iterative import CONFIG as GP_CFG
    from repro_torch.models.transformer import fake_mode

    n, d, s = shape.n, shape.d, shape.num_probes
    m = GP_CFG.num_rff_pairs
    axes = row_axes(mesh)
    row = NamedSharding(mesh, (axes, None))
    row1 = NamedSharding(mesh, (axes,))
    repl = NamedSharding(mesh, ())

    f32 = torch.float32
    with fake_mode():
        params = HyperParams.create(d, kernel=GP_CFG.kind)
        moments = [params.with_leaves([torch.zeros_like(p) for p in
                                       params.leaves]) for _ in range(2)]
        state = GPStepState(
            params=params,
            adam=AdamState(step=torch.zeros((), dtype=torch.int32),
                           mu=moments[0], nu=moments[1]),
            carry_v=torch.empty((n, 1 + s), dtype=f32),
            res_y=torch.empty((), dtype=f32),
            res_z=torch.empty((), dtype=f32),
        )
        inputs = (torch.empty((n, d), dtype=f32),
                  torch.empty((n,), dtype=f32),
                  RFFState(z=torch.empty((m, d), dtype=f32),
                           u=torch.empty((m,), dtype=f32),
                           w=torch.empty((2 * m, s), dtype=f32),
                           kind=GP_CFG.kind),
                  torch.empty((n, s), dtype=f32))
    hp_repl = params.with_leaves([repl] * 3)
    state_sh = GPStepState(params=hp_repl,
                           adam=AdamState(step=repl, mu=hp_repl, nu=hp_repl),
                           carry_v=row, res_y=repl, res_z=repl)
    input_sh = (row, row1, RFFState(z=repl, u=repl, w=repl,
                                    kind=GP_CFG.kind), row)
    step = make_gp_outer_step(mesh, s, shape.solver_epochs, GP_CFG.kind,
                              tile_dtype=tile_dtype)

    # MODEL_FLOPS for the GP cell: the paper's epoch accounting — one epoch
    # touches every H entry once: kernel eval ~ (3d+8) flops/entry + MVM
    # 2(1+s) flops/entry. (epochs+2 ring sweeps: +1 initial residual, +1
    # gradient pass.)
    per_entry = 3 * d + 8 + 2 * (1 + s)
    model_flops = float(n) * n * per_entry * (shape.solver_epochs + 2)
    return LoweredGPStep(step, state, inputs, state_sh, input_sh,
                         model_flops, f"cg_epochs={shape.solver_epochs}")
