"""Plain preconditioned CG for ``H V = B`` (paper Algorithm 1), and the
forward products it takes.

Run as a traffic's ``solver`` with ``name`` "cg": ``tolerance``,
``max_epochs`` (None: to tolerance; one iteration an epoch) and
``precond_rank``.
"""
from __future__ import annotations

import torch

from bench.reference.gp import NORM_EPS, Arith, h_product
from bench.reference.solvers import (Preconditioner, guarded, iteration_cap,
                                     norms)


def solve(ar: Arith, x: torch.Tensor, b: torch.Tensor, v0, raw: list,
          cfg: dict) -> tuple:
    """CG from ``v0`` (None: zero); returns (V, iterations, the final
    recurrence residual B - H V)."""
    tolerance = cfg["tolerance"]
    scale = torch.linalg.vector_norm(b, dim=0) + NORM_EPS
    bn = b / scale
    v = torch.zeros_like(b) if v0 is None else v0 / scale
    pre = Preconditioner(ar, x, raw, cfg["precond_rank"])
    cap = iteration_cap(cfg["max_epochs"], 1.0)
    r = bn - h_product(ar, x, v, raw)
    d = pre.apply(r)
    gamma = torch.sum(r * d, dim=0)
    res_y, res_z = norms(r)
    steps = 0
    while steps < cap and (res_y > tolerance or res_z > tolerance):
        hd = h_product(ar, x, d, raw)
        alpha = guarded(gamma, torch.sum(d * hd, dim=0))
        v = v + alpha * d
        r = r - alpha * hd
        p = pre.apply(r)
        gamma_new = torch.sum(r * p, dim=0)
        d = p + guarded(gamma_new, gamma) * d
        gamma = gamma_new
        res_y, res_z = norms(r)
        steps += 1
    return v * scale, steps, r * scale


def forward_products(n: int, d: int, t: int, cfg: dict, solves: int,
                     iters: float) -> list:
    """[(count, rows, cols, d, t)] of ``solves`` solves that took ``iters``
    iterations in all. ``src/repro_torch/solvers/cg.py``: ``r = sysn.b -
    op.mvm(v)``, the initial residual, then ``hd = op.mvm(d)`` once per
    iteration: (iters + 1) full n x n x t products a solve."""
    return [(iters + solves, n, n, d, t)]
