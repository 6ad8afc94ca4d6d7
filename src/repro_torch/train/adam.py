"""Adam (Kingma & Ba); port of ``repro.train.adam``.

Written out by hand rather than through ``torch.optim.Adam`` so the order of
operations matches the reference step for step. It updates either
`HyperParams` (the GP outer loop) or a nested dict of tensors (the LM
substrate's parameter tree, bf16 or fp32 leaves with fp32 moments).
Lane-stacked `HyperParams` leaves update elementwise, each lane as its own
run (the step count is shared, and the gradient clip takes each lane's own
norm).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.gp.hyperparams import HyperParams

Params = Union[HyperParams, dict]


class AdamState(NamedTuple):
    """Step count and first/second moments (same structure as the params)."""

    step: int
    mu: Any  # HyperParams or a dict tree like the params
    nu: Any


class AdamConfig(NamedTuple):
    """Adam hyperparameters (reference defaults)."""

    learning_rate: float = 0.1
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0  # decoupled (AdamW); 0 disables
    grad_clip_norm: float = 0.0  # global-norm clip; 0 disables


def tree_leaves(tree: dict) -> list:
    """The tensors of a nested dict, keys sorted at every level (the order
    of ``jax.tree.leaves`` on the same dict)."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        out.extend(tree_leaves(value) if isinstance(value, dict) else [value])
    return out


def tree_unflatten(like: dict, leaves) -> dict:
    """A nested dict shaped like ``like`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(node):
        return {key: build(node[key]) if isinstance(node[key], dict)
                else next(it) for key in sorted(node)}

    return build(like)


def _leaves(tree: Params) -> list:
    return list(tree.leaves) if isinstance(tree, HyperParams) \
        else tree_leaves(tree)


def _rebuild(like: Params) -> Callable[[list], Params]:
    if isinstance(like, HyperParams):
        return like.with_leaves
    return lambda leaves: tree_unflatten(like, leaves)


def adam_init(params: Params) -> AdamState:
    """Zero moments shaped like ``params``' leaves (fp32)."""
    def zeros():
        return _rebuild(params)(
            [torch.zeros_like(p, dtype=torch.float32) for p in _leaves(params)])

    return AdamState(step=0, mu=zeros(), nu=zeros())


def global_norm(tree, lanes: bool = False) -> torch.Tensor:
    """sqrt of the sum of squares over all leaves of ``tree`` (a list of
    tensors or a dict tree); per lane ((B,)) for lane-stacked leaves when
    ``lanes``."""
    leaves = tree_leaves(tree) if isinstance(tree, dict) else tree

    def sq(g):
        g = torch.square(g.float())
        return torch.sum(g, dim=tuple(range(1, g.ndim))) if lanes else torch.sum(g)

    return torch.sqrt(sum(sq(g) for g in leaves))


def adam_update(grads: Params, state: AdamState, params: Params,
                cfg: AdamConfig, *, maximize: bool = False):
    """One Adam step. Returns (new_params, new_state).

    ``maximize=True`` ascends (the MLL outer loop maximises L); LM training
    descends on the loss.
    """
    g_leaves = _leaves(grads)
    scale = None
    if cfg.grad_clip_norm > 0.0:
        lanes = isinstance(grads, HyperParams) and grads.lanes is not None
        norm = global_norm(g_leaves, lanes)  # -g has g's norm
        scale = torch.clamp_max(cfg.grad_clip_norm / (norm + 1e-12), 1.0)

    step = state.step + 1
    p_leaves = _leaves(params)
    device = p_leaves[0].device
    # Filled on the device: a copy from the host would wait for the stream.
    step_f = torch.full((), float(step), dtype=torch.float32, device=device)
    b1t = 1.0 - torch.full((), cfg.b1, dtype=torch.float32, device=device) ** step_f
    b2t = 1.0 - torch.full((), cfg.b2, dtype=torch.float32, device=device) ** step_f

    new_p, new_m, new_v = [], [], []
    for g, m, v, p in zip(g_leaves, _leaves(state.mu), _leaves(state.nu),
                          p_leaves):
        # Negated and clipped leaf by leaf, so that no second copy of the
        # whole gradient tree is alive at once.
        if maximize:
            g = -g
        if scale is not None:
            g = g * scale.reshape(scale.shape + (1,) * (g.ndim - scale.ndim))
        g32 = g.float()
        m = cfg.b1 * m + (1.0 - cfg.b1) * g32
        v = cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g32)
        delta = cfg.learning_rate * (m / b1t) / (torch.sqrt(v / b2t) + cfg.eps)
        if cfg.weight_decay > 0.0:
            delta = delta + cfg.learning_rate * cfg.weight_decay * p.float()
        new_p.append((p.float() - delta).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    rebuild = _rebuild(params)
    return rebuild(new_p), AdamState(step=step, mu=rebuild(new_m),
                                     nu=rebuild(new_v))
