"""Seeded host-sync violations (exact lines asserted in tests)."""
import torch


def any_active(go: torch.Tensor) -> bool:
    return bool(go.any())  # a host read, outside any loop: not flagged


def solve(b: torch.Tensor, steps: int):
    r = b.clone()
    norms = []
    for _ in range(steps):
        r = r * 0.5
        if r.abs().max() < 1e-3:  # LINE 14: trace-python-branch
            break
        norms.append(r.norm().item())  # LINE 16: trace-host-sync
        scale = float(r.sum())  # LINE 17: trace-host-sync
        torch.cuda.synchronize()  # LINE 18: trace-host-sync
        if not any_active(r > scale):  # LINE 19: trace-host-sync (callee)
            break
    return r, norms
