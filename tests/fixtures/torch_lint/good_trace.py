"""Host-sync-clean twin of bad_trace.py: the loop issues work only; the
reads happen once, after it."""
import torch


def any_active(go: torch.Tensor) -> bool:
    return bool(go.any())


def solve(b: torch.Tensor, steps: int):
    r = b.clone()
    norms = []
    for _ in range(steps):
        r = torch.where(r.abs().max() < 1e-3, r, r * 0.5)  # no branch
        norms.append(r.norm())  # stays a tensor
        n = r.shape[0]  # host metadata, not a read
        del n
    done = not any_active(r.abs() > 1e-3)  # one read, after the loop
    return r, torch.stack(norms).tolist(), done
