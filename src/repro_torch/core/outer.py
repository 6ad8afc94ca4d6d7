"""The outer marginal-likelihood optimisation loop (paper Fig. 2, §2.1).

Port of the single-lane part of ``repro.core.outer``. One outer step:
build targets -> warm start from the carry -> inner solve -> gradient
assembly -> Adam ascent -> new carry. The reference's ``outer_scan`` is a
Python loop here (:func:`repro_torch.core.driver.fit`). Without warm
starting, each step draws fresh probes from the fit's ``torch.Generator``
(or takes them as given) and solves from zero. SGD's batch schedule comes
from the same generator unless handed over. Lanes, the adaptive budget
policy and ``extend_state`` arrive with later slices.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core.estimators import (
    PATHWISE,
    ProbeState,
    build_system_targets,
    init_probes,
    resample_probes,
)
from repro_torch.core.gradients import mll_grad_estimate
from repro_torch.gp.hyperparams import HyperParams
from repro_torch.solvers import HOperator, SolverConfig, solve
from repro_torch.train.adam import AdamConfig, AdamState, adam_init, adam_update


@dataclass(frozen=True)
class OuterConfig:
    """Configuration of the outer MLL loop (reference defaults)."""

    estimator: str = PATHWISE  # standard | pathwise
    warm_start: bool = True
    num_probes: int = 64
    num_rff_pairs: int = 1000
    kind: Optional[str] = None  # registered kernel; None => params.kernel
    solver: SolverConfig = field(default_factory=SolverConfig)
    adam: AdamConfig = field(default_factory=lambda: AdamConfig(learning_rate=0.1))
    num_steps: int = 100
    backend: str = "streamed"  # HOperator backend: dense | streamed | cuda
    bm: int = 1024
    bn: int = 1024


def effective_kind(cfg: OuterConfig, params: HyperParams) -> str:
    """Kernel precedence: OuterConfig.kind > SolverConfig.kind > params.kernel."""
    if cfg.kind is not None:
        return cfg.kind
    if cfg.solver.kind is not None:
        return cfg.solver.kind
    return params.kernel


class OuterState(NamedTuple):
    """Everything that evolves across outer steps."""

    params: HyperParams
    adam: AdamState
    probes: ProbeState
    carry_v: torch.Tensor  # (n, 1+s) previous solutions (warm-start carry)
    step: int


def init_outer_state(
    cfg: OuterConfig,
    x: torch.Tensor,
    init_params: Optional[HyperParams] = None,
    generator: Optional[torch.Generator] = None,
    probes: Optional[ProbeState] = None,
) -> OuterState:
    """Fresh `OuterState`: hyperparameters, Adam, probes, zero carry.

    Probes are drawn from ``generator`` unless given (``probes=``), which is
    how a test hands over the reference's draws.
    """
    n, d = x.shape
    if init_params is not None:
        params = init_params
    else:
        params = HyperParams.create(
            d, kernel=cfg.kind or cfg.solver.kind or "matern32",
            dtype=x.dtype, device=x.device)
    if probes is None:
        probes = init_probes(
            generator, cfg.estimator, n, d, cfg.num_probes, cfg.num_rff_pairs,
            kind=effective_kind(cfg, params), dtype=x.dtype, device=x.device)
    carry = torch.zeros((n, 1 + cfg.num_probes), dtype=x.dtype, device=x.device)
    return OuterState(params=params, adam=adam_init(params), probes=probes,
                      carry_v=carry, step=0)


def outer_step(state: OuterState, x: torch.Tensor, y: torch.Tensor,
               cfg: OuterConfig, generator: Optional[torch.Generator] = None,
               probes: Optional[ProbeState] = None,
               batch_idx: Optional[Sequence[int]] = None
               ) -> tuple[OuterState, dict]:
    """One outer MLL step: solve -> gradient -> Adam -> carry.

    With ``cfg.warm_start`` the probes of ``state`` are kept and the solve
    starts from the carry. Without it the step solves from zero with fresh
    probes: ``probes`` when given (how a test hands over the reference's
    per-step draws), else drawn from ``generator``. SGD's block schedule is
    ``batch_idx`` when given (the reference's ``ksolve`` draws), else drawn
    from ``generator`` after the probes.
    """
    kind = effective_kind(cfg, state.params)
    if cfg.warm_start:
        probes, v0 = state.probes, state.carry_v
    else:
        if probes is None:
            probes = resample_probes(generator, state.probes, x)
        v0 = None
    with torch.no_grad():
        targets = build_system_targets(probes, x, y, state.params)
        op = HOperator(x=x, params=state.params, kind=kind,
                       backend=cfg.backend, bm=cfg.bm, bn=cfg.bn)
        scfg = (cfg.solver if cfg.solver.kind == kind
                else replace(cfg.solver, kind=kind))
        res = solve(op, targets, v0, scfg, batch_idx=batch_idx,
                    generator=generator)

    grads, aux = mll_grad_estimate(
        x, y, state.params, res.v, targets, cfg.estimator,
        kind=kind, bm=cfg.bm, bn=cfg.bn, backend=cfg.backend,
    )
    with torch.no_grad():
        new_params, new_adam = adam_update(
            grads, state.adam, state.params, cfg.adam, maximize=True)
        grad_norm = torch.sqrt(sum(torch.sum(g**2) for g in grads.leaves))
    new_state = OuterState(
        params=new_params, adam=new_adam, probes=probes,
        carry_v=res.v, step=state.step + 1,
    )
    metrics = {
        "step": state.step,
        "res_y": float(res.res_y),
        "res_z": float(res.res_z),
        "iters": res.iters,
        "epochs": res.epochs,
        "mvms": res.mvms,
        "host_syncs": res.host_syncs,
        "data_fit": float(aux.data_fit),
        "hypers": new_params.flat().detach().cpu().numpy(),
        "grad_norm": float(grad_norm),
    }
    return new_state, metrics
