"""Plain alternating projections for ``H V = B`` (paper Algorithm 2), and
the forward products they take.

Run as a traffic's ``solver`` with ``name`` "ap": ``tolerance``,
``max_epochs`` (None: to tolerance; n / block iterations an epoch) and
``block_size``. Each iteration solves the block of rows whose residual
has the largest Frobenius norm with that block's Cholesky factor and
updates the whole residual through one column slab of H.
"""
from __future__ import annotations

import torch

from bench.reference.gp import (NORM_EPS, Arith, constrained, h_product,
                                kernel_product, matern32, scaled, sqdist)
from bench.reference.solvers import iteration_cap, norms


def solve(ar: Arith, x: torch.Tensor, b: torch.Tensor, v0, raw: list,
          cfg: dict) -> tuple:
    """AP from ``v0`` (None: zero) over contiguous blocks; returns (V,
    iterations, the final tracked residual B - H V)."""
    tolerance, block = cfg["tolerance"], cfg["block_size"]
    n, t = b.shape
    if n % block:
        raise ValueError(f"n={n} is not a multiple of the block {block}")
    nb = n // block
    ell, sig, noise = constrained(raw)
    u = scaled(x, ell)
    eye = torch.eye(block, dtype=x.dtype, device=x.device)
    chols = torch.stack([
        torch.linalg.cholesky((sig * sig) * matern32(sqdist(
            u[i:i + block], u[i:i + block])) + (noise * noise) * eye)
        for i in range(0, n, block)])
    scale = torch.linalg.vector_norm(b, dim=0) + NORM_EPS
    bn = b / scale
    v = torch.zeros_like(b) if v0 is None else v0 / scale
    cap = iteration_cap(cfg["max_epochs"], float(nb))
    r = bn - h_product(ar, x, v, raw)
    res_y, res_z = norms(r)
    steps = 0
    while steps < cap and (res_y > tolerance or res_z > tolerance):
        i = int(torch.argmax(torch.sum(r.reshape(nb, block * t) ** 2, dim=1)))
        rows = slice(i * block, (i + 1) * block)
        delta = torch.cholesky_solve(r[rows], chols[i])
        v[rows] += delta
        r = r - (sig * sig) * kernel_product(ar, u, u[rows], delta,
                                             diag=-i * block)
        r[rows] -= (noise * noise) * delta
        res_y, res_z = norms(r)
        steps += 1
    return v * scale, steps, r * scale


def forward_products(n: int, d: int, t: int, cfg: dict, solves: int,
                     iters: float) -> list:
    """[(count, rows, cols, d, t)] of ``solves`` solves that took ``iters``
    iterations in all. ``src/repro_torch/solvers/ap.py``: ``r = sysn.b -
    op.mvm(v)`` once, then ``op.col_block_mvm(start, bs, delta)`` once per
    iteration: one full product and iters column slabs of n x block x t."""
    return [(solves, n, n, d, t), (iters, n, cfg["block_size"], d, t)]
