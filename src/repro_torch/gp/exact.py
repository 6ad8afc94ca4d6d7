"""Predictive metrics of the port (fragment of ``repro.gp.exact``)."""
from __future__ import annotations

import math

import torch

LOG2PI = math.log(2.0 * math.pi)


def gaussian_loglik(y: torch.Tensor, mean: torch.Tensor,
                    var_plus_noise: torch.Tensor) -> torch.Tensor:
    """Mean predictive log density (the paper's 'test log-likelihood')."""
    return torch.mean(
        -0.5 * (LOG2PI + torch.log(var_plus_noise))
        - 0.5 * (y - mean) ** 2 / var_plus_noise
    )


def rmse(y: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """Root-mean-square error of the predictive mean."""
    return torch.sqrt(torch.mean((y - mean) ** 2))
