"""Seeded freeze-mask violations (exact lines asserted in tests)."""
import torch

from repro_torch.solvers.base import keep_going, masked


def solve(b: torch.Tensor, tol: torch.Tensor, cap: int, generator=None):
    lanes = b.shape[0]
    v = torch.zeros_like(b)
    res = b.norm(dim=-1)
    t = torch.zeros(lanes, dtype=torch.int32)
    steps = 0
    while steps < cap:
        active, run = keep_going(res > tol, t, torch.full_like(t, cap))
        if not run:
            break
        keep = masked(active, lanes)
        noise = torch.randn(b.shape, generator=generator)  # LINE 18: draw
        v_new = v + 0.5 * (b - v) + 1e-3 * noise
        v = keep(v_new, v)
        res = (b - v).norm(dim=-1)  # LINE 21: freeze-mask (not frozen)
        t = t + active.to(torch.int32)
        steps += 1
    return v, res, t
