"""Batched acquisition scoring for the online BO loop; port of
``repro.online.acquisition``.

Both acquisitions are pure functions of the engine's pathwise posterior
``(mean, var)`` at the candidate set, so the acquire step is one bucketed
engine predict plus one call to :func:`acquisition_argmax`, on the device
of the predictions. All scores follow the maximisation convention.
"""
from __future__ import annotations

import math

import torch

# Variance estimates from a finite pathwise sample set can brush zero (or
# dip microscopically negative); clamp before sqrt so EI/UCB stay finite.
MIN_VARIANCE = 1e-12

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def ucb(mean: torch.Tensor, var: torch.Tensor, beta=2.0) -> torch.Tensor:
    """Upper confidence bound ``mean + beta * sqrt(var)`` ((m,) scores)."""
    return mean + beta * torch.sqrt(torch.clamp_min(var, MIN_VARIANCE))


def expected_improvement(mean: torch.Tensor, var: torch.Tensor, best=0.0,
                         xi=0.01) -> torch.Tensor:
    """Expected improvement over the incumbent, ``E[max(f - best - xi, 0)]``,
    in the closed form ``d * Phi(d / s) + s * phi(d / s)`` with ``d = mean -
    best - xi`` and ``s = sqrt(var)`` (clamped, so ``s > 0``)."""
    s = torch.sqrt(torch.clamp_min(var, MIN_VARIANCE))
    d = mean - best - xi
    z = d / s
    pdf = torch.exp(-0.5 * z * z) * _INV_SQRT_2PI
    return d * torch.special.ndtr(z) + s * pdf


ACQUISITIONS = {"ucb": ucb, "ei": expected_improvement}


def acquisition_argmax(mean: torch.Tensor, var: torch.Tensor,
                       name: str = "ucb", best=0.0, beta=2.0,
                       xi=0.01) -> tuple[torch.Tensor, torch.Tensor]:
    """Score every candidate and pick the argmax (first on ties).

    Returns ``(idx, score)``: the winning candidate's index and its score,
    as 0-d tensors on the device of ``mean``. ``best`` is EI's incumbent,
    ``beta`` UCB's exploration weight, ``xi`` EI's margin.
    """
    if name not in ACQUISITIONS:
        raise ValueError(
            f"unknown acquisition {name!r}; have {sorted(ACQUISITIONS)}")
    if name == "ucb":
        scores = ucb(mean, var, beta=beta)
    else:
        scores = expected_improvement(mean, var, best=best, xi=xi)
    idx = torch.argmax(scores)
    return idx, scores[idx]
