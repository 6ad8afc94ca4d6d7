"""Adam (Kingma & Ba) on `HyperParams` leaves; port of ``repro.train.adam``.

Written out by hand rather than through ``torch.optim.Adam`` so the order of
operations matches the reference step for step. Lane-stacked leaves update
elementwise, each lane as its own run (the step count is shared, and the
gradient clip takes each lane's own norm).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.gp.hyperparams import HyperParams


class AdamState(NamedTuple):
    """Step count and first/second moments (same structure as the params)."""

    step: int
    mu: HyperParams
    nu: HyperParams


class AdamConfig(NamedTuple):
    """Adam hyperparameters (reference defaults)."""

    learning_rate: float = 0.1
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0  # decoupled (AdamW); 0 disables
    grad_clip_norm: float = 0.0  # global-norm clip; 0 disables


def adam_init(params: HyperParams) -> AdamState:
    """Zero moments shaped like ``params``' leaves (fp32)."""
    def zeros():
        return params.with_leaves(
            [torch.zeros_like(p, dtype=torch.float32) for p in params.leaves])

    return AdamState(step=0, mu=zeros(), nu=zeros())


def global_norm(leaves, lanes: bool = False) -> torch.Tensor:
    """sqrt of the sum of squares over all leaves; per lane ((B,)) for
    lane-stacked leaves when ``lanes``."""
    def sq(g):
        g = torch.square(g.float())
        return torch.sum(g, dim=tuple(range(1, g.ndim))) if lanes else torch.sum(g)

    return torch.sqrt(sum(sq(g) for g in leaves))


def adam_update(grads: HyperParams, state: AdamState, params: HyperParams,
                cfg: AdamConfig, *, maximize: bool = False):
    """One Adam step. Returns (new_params, new_state).

    ``maximize=True`` ascends (the MLL outer loop maximises L).
    """
    g_leaves = list(grads.leaves)
    if maximize:
        g_leaves = [-g for g in g_leaves]
    if cfg.grad_clip_norm > 0.0:
        norm = global_norm(g_leaves, grads.lanes is not None)
        scale = torch.clamp_max(cfg.grad_clip_norm / (norm + 1e-12), 1.0)
        g_leaves = [g * scale.reshape(scale.shape + (1,) * (g.ndim - scale.ndim))
                    for g in g_leaves]

    step = state.step + 1
    ref = params.raw_signal
    step_f = torch.tensor(float(step), dtype=torch.float32, device=ref.device)
    b1t = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32, device=ref.device) ** step_f
    b2t = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32, device=ref.device) ** step_f

    new_p, new_m, new_v = [], [], []
    for g, m, v, p in zip(g_leaves, state.mu.leaves, state.nu.leaves,
                          params.leaves):
        g32 = g.float()
        m = cfg.b1 * m + (1.0 - cfg.b1) * g32
        v = cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g32)
        delta = cfg.learning_rate * (m / b1t) / (torch.sqrt(v / b2t) + cfg.eps)
        if cfg.weight_decay > 0.0:
            delta = delta + cfg.learning_rate * cfg.weight_decay * p.float()
        new_p.append((p.float() - delta).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return params.with_leaves(new_p), AdamState(
        step=step, mu=params.with_leaves(new_m), nu=params.with_leaves(new_v))
