"""Freeze-clean twin of bad_freeze.py: every update masked or gated; the
one-lane branch needs no mask (its body runs only while the lane is
active)."""
import torch

from repro_torch.solvers.base import keep_going, masked


def solve(b: torch.Tensor, tol: torch.Tensor, cap: int):
    lanes = b.shape[0]
    v = torch.zeros_like(b)
    res = b.norm(dim=-1)
    t = torch.zeros(lanes, dtype=torch.int32)
    steps = 0
    while steps < cap:
        active, run = keep_going(res > tol, t, torch.full_like(t, cap))
        if not run:
            break
        if lanes == 1:
            v = v + 0.5 * (b - v)
            res = (b - v).norm(dim=-1)
        else:
            keep = masked(active, lanes)
            v_new = v + 0.5 * (b - v)
            v = keep(v_new, v)
            res = keep((b - v_new).norm(dim=-1), res)
            t = t + active.to(torch.int32)
        steps += 1
    return v, res, t
