"""Linear-system solvers of the port (CG, AP, SGD) and their single dispatch
entry point."""
from __future__ import annotations

from dataclasses import replace
from typing import Optional, Sequence

import torch

from repro_torch.solvers.ap import solve_ap
from repro_torch.solvers.base import NO_EPOCH_BUDGET, SolveResult, SolverConfig
from repro_torch.solvers.cg import solve_cg
from repro_torch.solvers.operator import HOperator, kernel_mvm_tiled
from repro_torch.solvers.sgd import solve_sgd

SOLVERS = {"cg": solve_cg, "ap": solve_ap, "sgd": solve_sgd}


def solve(op: HOperator, b: torch.Tensor, v0: Optional[torch.Tensor],
          cfg: SolverConfig, batch_idx: Optional[Sequence[int]] = None,
          generator: Optional[torch.Generator] = None) -> SolveResult:
    """Solve H [v_y, v_1..v_s] = b with the configured solver.

    ``v0=None`` is the cold start. ``cfg.kind`` (when set) must agree with
    the operator's effective kernel. SGD takes its batch schedule from
    ``batch_idx`` or draws it from ``generator``; CG and AP draw nothing.
    """
    if cfg.kind is not None:
        if cfg.kind != op.kernel_kind:
            raise ValueError(
                f"SolverConfig.kind={cfg.kind!r} conflicts with the "
                f"operator's kernel {op.kernel_kind!r}")
        if op.kind is None:
            op = replace(op, kind=cfg.kind)
    if cfg.name == "cg":
        return solve_cg(op, b, v0, cfg)
    if cfg.name == "ap":
        return solve_ap(op, b, v0, cfg)
    if cfg.name == "sgd":
        return solve_sgd(op, b, v0, cfg, batch_idx=batch_idx,
                         generator=generator)
    raise ValueError(f"unknown solver {cfg.name!r}")


__all__ = ["SOLVERS", "NO_EPOCH_BUDGET", "solve", "solve_cg", "solve_ap",
           "solve_sgd", "SolveResult", "SolverConfig", "HOperator",
           "kernel_mvm_tiled"]
