"""Random Fourier features for approximate GP prior function samples.

Port of ``repro.gp.rff``. A prior sample is ``f(.) = phi(.) @ w`` with
``phi`` built from ``m`` sin/cos frequency pairs ``omega = z * scale(u) /
ell``. Warm-start contract (paper Appendix B): the base draws ``(z, u, w)``
are drawn once and fixed; each outer step re-evaluates ``omega`` from them
and the current lengthscales. :class:`RFFState` can be built directly from
given draws, which is how tests inject the reference's draws.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.gp.hyperparams import HyperParams
from repro_torch.kernels.registry import get_kernel

# Per-kernel default sin/cos pair counts (Matérn-1/2's Cauchy spectrum
# needs 4x the features for the same covariance error).
DEFAULT_NUM_PAIRS = {
    "rbf": 1000,
    "matern32": 1000,
    "matern52": 1000,
    "matern12": 4000,
}
AUTO_NUM_PAIRS = -1

# Rows per chunk of :func:`prior_sample_at`: a chunk's features are
# 4096 x 2m fp32 (33 MB at 1000 pairs) at any n.
PRIOR_ROW_CHUNK = 4096


def default_num_pairs(kind: str) -> int:
    """The kernel's default feature-pair count (1000 for unlisted kernels)."""
    return DEFAULT_NUM_PAIRS.get(kind, 1000)


class RFFState(NamedTuple):
    """Fixed base randomness for RFF prior samples."""

    z: torch.Tensor  # (m, d) standard normal
    u: torch.Tensor  # (m,) spectral mixture draws (ones for rbf)
    w: torch.Tensor  # (2m, s) feature weights, one column per prior sample
    kind: str = "matern32"


def init_rff(
    generator: Optional[torch.Generator],
    num_pairs: Optional[int],
    d: int,
    num_samples: int,
    kind: str = "matern32",
    dtype=torch.float32,
    device="cpu",
) -> RFFState:
    """Draw ``(z, u, w)`` from ``generator`` (on ``device``)."""
    spec = get_kernel(kind)
    if num_pairs is None or num_pairs == AUTO_NUM_PAIRS:
        num_pairs = default_num_pairs(kind)
    z = torch.randn((num_pairs, d), generator=generator, dtype=dtype,
                    device=device)
    u = spec.mixture_sample(generator, num_pairs, dtype=dtype, device=device)
    w = torch.randn((2 * num_pairs, num_samples), generator=generator,
                    dtype=dtype, device=device)
    return RFFState(z=z, u=u, w=w, kind=kind)


def rff_frequencies(state: RFFState, params: HyperParams) -> torch.Tensor:
    """Frequencies (m, d) for the current lengthscales."""
    scale = get_kernel(state.kind).mixture_scale(state.u)[:, None]
    return state.z * scale / params.lengthscales


def rff_features(x: torch.Tensor, state: RFFState,
                 params: HyperParams) -> torch.Tensor:
    """Feature matrix phi(x) of shape (n, 2m); phi @ phi.T ~= K(x, x)."""
    proj = x @ rff_frequencies(state, params).T
    amp = params.signal * math.sqrt(1.0 / state.z.shape[0])
    return amp * torch.cat([torch.cos(proj), torch.sin(proj)], dim=-1)


def prior_sample_at(x: torch.Tensor, state: RFFState,
                    params: HyperParams) -> torch.Tensor:
    """Evaluate the s fixed prior function samples at x: (n, s).

    ``phi(x) @ w`` over chunks of :data:`PRIOR_ROW_CHUNK` rows, so the
    feature matrix never exists for all n rows at once (n x 2m fp32 is
    13 GB at 1.66 M rows and 1000 pairs); each row's arithmetic is the
    reference's.
    """
    chunk = PRIOR_ROW_CHUNK
    return torch.cat([rff_features(x[i:i + chunk], state, params) @ state.w
                      for i in range(0, max(x.shape[0], 1), chunk)])
