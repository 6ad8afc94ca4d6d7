"""Linear-system solvers of the port (CG, AP, SGD), their single dispatch
entry point and the lane-batched one."""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch

from repro_torch.gp.hyperparams import HyperParams
from repro_torch.solvers.adaptive import (
    AUTO_HORIZON,
    BudgetPolicy,
    DecayFit,
    broadcast_policy,
    budget_allocate,
    budget_observe,
    fit_decay,
    make_budget_policy,
    noise_probe,
    predict_epochs,
    resolve_horizon,
)
from repro_torch.solvers.ap import solve_ap
from repro_torch.solvers.base import (
    NO_EPOCH_BUDGET,
    SolveResult,
    SolverConfig,
    SolverNumerics,
    broadcast_numerics,
    numerics_of,
    stack_numerics,
    strip_numerics,
)
from repro_torch.solvers.cg import solve_cg
from repro_torch.solvers.operator import HOperator, kernel_mvm_tiled
from repro_torch.solvers.precond import (
    AUTO_RANK,
    PRECOND_DEFAULTS,
    Preconditioner,
    PrecondDefaults,
    build_preconditioner,
    default_precond,
    pivoted_cholesky,
)
from repro_torch.solvers.sgd import Generators, solve_sgd

SOLVERS = {"cg": solve_cg, "ap": solve_ap, "sgd": solve_sgd}


def solve(op: HOperator, b: torch.Tensor, v0: Optional[torch.Tensor],
          cfg: SolverConfig, batch_idx=None, generator: Generators = None,
          numerics: Optional[SolverNumerics] = None) -> SolveResult:
    """Solve H [v_y, v_1..v_s] = b with the configured solver.

    ``v0=None`` is the cold start. ``cfg.kind`` (when set) must agree with
    the operator's effective kernel. SGD takes its batch schedule from
    ``batch_idx`` or draws it from ``generator``; CG and AP draw nothing.
    ``numerics`` overrides the config's tolerance, epoch budget, learning
    rate, momentum and divergence threshold (scalar or per lane). A
    lane-stacked operator and (B, n, t) right-hand sides solve B systems at
    once (see :func:`solve_lanes`).
    """
    if cfg.kind is not None:
        if cfg.kind != op.kernel_kind:
            raise ValueError(
                f"SolverConfig.kind={cfg.kind!r} conflicts with the "
                f"operator's kernel {op.kernel_kind!r}")
        if op.kind is None:
            op = replace(op, kind=cfg.kind)
    if cfg.name == "cg":
        return solve_cg(op, b, v0, cfg, numerics=numerics)
    if cfg.name == "ap":
        return solve_ap(op, b, v0, cfg, numerics=numerics)
    if cfg.name == "sgd":
        return solve_sgd(op, b, v0, cfg, batch_idx=batch_idx,
                         generator=generator, numerics=numerics)
    raise ValueError(f"unknown solver {cfg.name!r}")


def solve_lanes(
    x: torch.Tensor,
    params: HyperParams,
    b: torch.Tensor,
    v0: Optional[torch.Tensor],
    cfg: SolverConfig,
    *,
    kind: Optional[str] = None,
    backend: str = "streamed",
    bm: int = 1024,
    bn: int = 1024,
    batch_idx=None,
    generators: Generators = None,
    numerics: Optional[SolverNumerics] = None,
) -> SolveResult:
    """Solve B independent scenario lanes in one lane-stacked solve.

    Each lane is a full batched GP system ``H(theta_l) V_l = B_l`` sharing
    the training inputs ``x`` and the static solver config, with its own
    hyperparameters, right-hand sides and (optionally) warm start. The loop
    runs while ANY lane is active; the freeze mask keeps lane l's
    trajectory, iterates, residuals and counters, a single solve's.

    Args:
      x: (n, d) training inputs shared by all lanes.
      params: lane-stacked `HyperParams` ((B,) signal), or one system's,
        shared by every lane.
      b: (B, n, t) right-hand sides; v0: (B, n, t) warm starts or None.
      batch_idx: (B, iters) SGD block indices, or None to draw them from
        ``generators`` (one per lane, or one shared).
      numerics: scalar or (B,) leaves; None reads the config's values.
    Returns:
      `SolveResult` with a leading lane axis on every tensor field.
    """
    lanes = b.shape[0]
    if params.lanes is None:
        params = params.with_leaves(
            [p.expand(lanes, *p.shape) for p in params.leaves])
    op = HOperator(x=x, params=params, kind=kind, backend=backend, bm=bm,
                   bn=bn)
    return solve(op, b, v0, cfg, batch_idx=batch_idx, generator=generators,
                 numerics=numerics)


__all__ = ["SOLVERS", "NO_EPOCH_BUDGET", "AUTO_HORIZON", "BudgetPolicy",
           "DecayFit", "broadcast_policy", "budget_allocate",
           "budget_observe", "fit_decay", "make_budget_policy",
           "noise_probe", "predict_epochs", "resolve_horizon", "solve",
           "solve_lanes", "solve_cg", "solve_ap", "solve_sgd", "SolveResult",
           "SolverConfig", "SolverNumerics", "numerics_of", "strip_numerics",
           "stack_numerics", "broadcast_numerics", "HOperator",
           "kernel_mvm_tiled", "AUTO_RANK", "PRECOND_DEFAULTS",
           "Preconditioner", "PrecondDefaults", "build_preconditioner",
           "default_precond", "pivoted_cholesky"]
