"""Standard and pathwise gradient-estimator probes (paper §2.1, §3).

Port of ``repro.core.estimators``. The right-hand sides of
``H [v_y, v_1..v_s] = [y, b_1..b_s]`` are ``b_j = z_j`` (standard) or
``b_j = f(x) + sigma * w_eps`` with ``f`` an RFF prior sample (pathwise).
Under warm starting the base draws are fixed once; only their
reparameterisation in theta changes; without warm starting
:func:`resample_probes` draws them afresh every outer step. A
:class:`ProbeState` built directly
from given draws is how the reference's draws are injected. Lanes carry a
lane-stacked ProbeState (every draw with a leading B axis): each lane has
its own base draws and its own hyperparameters, and its targets are built
lane by lane in the 4096-row chunks of the prior sample.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import lanes
from repro_torch.gp.hyperparams import HyperParams
from repro_torch.gp.rff import RFFState, init_rff, prior_sample_at

STANDARD = "standard"
PATHWISE = "pathwise"


class ProbeState(NamedTuple):
    """Fixed base randomness for either estimator.

    standard: ``z`` (n, s) probes. pathwise: ``rff`` prior-sample draws and
    ``w_eps`` (n, s) base noise.
    """

    estimator: str
    z: Optional[torch.Tensor]
    rff: Optional[RFFState]
    w_eps: Optional[torch.Tensor]


def init_probes(
    generator: Optional[torch.Generator],
    estimator: str,
    n: int,
    d: int,
    num_probes: int,
    num_rff_pairs: int = 1000,
    kind: str = "matern32",
    dtype=torch.float32,
    device="cpu",
) -> ProbeState:
    """Draw the probe randomness for one fit from ``generator``."""
    if estimator == STANDARD:
        z = torch.randn((n, num_probes), generator=generator, dtype=dtype,
                        device=device)
        return ProbeState(estimator=STANDARD, z=z, rff=None, w_eps=None)
    if estimator == PATHWISE:
        rff = init_rff(generator, num_rff_pairs, d, num_probes, kind=kind,
                       dtype=dtype, device=device)
        w_eps = torch.randn((n, num_probes), generator=generator, dtype=dtype,
                            device=device)
        return ProbeState(estimator=PATHWISE, z=None, rff=rff, w_eps=w_eps)
    raise ValueError(f"unknown estimator {estimator!r}")


def resample_probes(generator: Optional[torch.Generator], probes: ProbeState,
                    x: torch.Tensor) -> ProbeState:
    """Fresh base randomness with the shapes of ``probes`` (the
    non-warm-start regime; counterpart of the reference's
    ``_resample_probes``)."""
    n, d = x.shape
    if probes.estimator == STANDARD:
        return init_probes(generator, STANDARD, n, d, probes.z.shape[1],
                           dtype=x.dtype, device=x.device)
    return init_probes(generator, PATHWISE, n, d, probes.rff.w.shape[1],
                       num_rff_pairs=probes.rff.z.shape[0],
                       kind=probes.rff.kind, dtype=x.dtype, device=x.device)


def probe_targets(probes: ProbeState, x: torch.Tensor,
                  params: HyperParams) -> torch.Tensor:
    """Right-hand sides b_1..b_s (n, s) for the current hyperparameters;
    (B, n, s) for lane-stacked probes and params."""
    if params.lanes is not None:
        return torch.stack([probe_targets(lanes.lane(probes, l), x,
                                          params.lane(l))
                            for l in range(params.lanes)])
    if probes.estimator == STANDARD:
        return probes.z
    return prior_sample_at(x, probes.rff, params) + params.noise * probes.w_eps


def build_system_targets(probes: ProbeState, x: torch.Tensor,
                         y: torch.Tensor,
                         params: HyperParams) -> torch.Tensor:
    """Full batched RHS [y | b_1..b_s] of shape (n, 1+s); (B, n, 1+s) for
    lanes (y shared)."""
    b = probe_targets(probes, x, params)
    return torch.cat([y[:, None].expand(*b.shape[:-1], 1), b], dim=-1)


def expected_initial_sqdistance(probes: ProbeState,
                                h_dense: torch.Tensor) -> float:
    """Theory check (eqs. 14/15): E ||0 - u||_H^2 for a probe system:
    tr(H^-1) for the standard estimator, n for the pathwise one (tests
    only; needs a dense H)."""
    n = h_dense.shape[0]
    if probes.estimator == STANDARD:
        return float(torch.trace(torch.linalg.inv(h_dense)))
    return float(n)
