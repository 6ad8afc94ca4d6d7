"""Linear-system solvers of the port and their single dispatch entry point.

Only CG is ported; ``ap`` and ``sgd`` raise until the AP/SGD slice
(ROADMAP Queue 1).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch

from repro_torch.solvers.base import SolveResult, SolverConfig
from repro_torch.solvers.cg import solve_cg
from repro_torch.solvers.operator import HOperator, kernel_mvm_tiled


def solve(op: HOperator, b: torch.Tensor, v0: Optional[torch.Tensor],
          cfg: SolverConfig) -> SolveResult:
    """Solve H [v_y, v_1..v_s] = b with the configured solver.

    ``cfg.kind`` (when set) must agree with the operator's effective kernel.
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
    if cfg.name in ("ap", "sgd"):
        raise NotImplementedError(
            f"solver {cfg.name!r} is not ported yet (ROADMAP Queue 1, "
            "AP/SGD slice); use name='cg'")
    raise ValueError(f"unknown solver {cfg.name!r}")


__all__ = ["solve", "solve_cg", "SolveResult", "SolverConfig", "HOperator",
           "kernel_mvm_tiled"]
