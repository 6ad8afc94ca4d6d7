"""Sequential decision-making on the port's serving stack (online BO).

  * :mod:`repro_torch.online.acquisition` — UCB / expected improvement
    scoring and argmax over a fixed-size candidate set;
  * :mod:`repro_torch.online.bo` — :func:`run_bo`, the acquire -> observe
    -> append -> refresh -> predict loop on `OnlineGP` + `BucketedEngine`,
    with cumulative epoch / escalation accounting and regret tracking.
"""
from repro_torch.online.acquisition import (
    ACQUISITIONS,
    acquisition_argmax,
    expected_improvement,
    ucb,
)
from repro_torch.online.bo import (
    BOConfig,
    BOResult,
    make_gaussian_bumps,
    run_bo,
)

__all__ = [
    "ACQUISITIONS", "acquisition_argmax", "expected_improvement", "ucb",
    "BOConfig", "BOResult", "make_gaussian_bumps", "run_bo",
]
