"""A cell's inputs, made from the run's seed on the run's device: the data,
the base draws of the pathwise targets and the initial hyperparameters.
Both the program and the reference receive these same tensors.
"""
from __future__ import annotations

import math

import torch

# Phantom rows that pad a system to a multiple of AP's block sit at
# PAD_FAR * (1 + k) in every coordinate, so their kernel against every
# other row is exactly zero.
PAD_FAR = 1e6


def standard_gamma(gen: torch.Generator, conc: float, size: int,
                   device) -> torch.Tensor:
    return torch._standard_gamma(
        torch.full((size,), conc, dtype=torch.float32, device=device),
        generator=gen)


def make_data(gen: torch.Generator, n: int, d: int, device) -> tuple:
    """(x, y): x uniform in [-2, 2]^d, y a Matérn-3/2 RFF prior sample at
    lengthscale 1.6 sqrt(d) (512 feature pairs) plus noise 0.1, both
    z-scored.

    Copied from ``src/repro_torch/data/synthetic.py::make_gp_regression``
    and ``standardise`` (the port's stand-in for the UCI data), drawing on
    ``device`` and keeping all n rows as the training set.
    """
    lengthscale, noise, pairs = 1.6 * math.sqrt(d), 0.1, 512
    x = torch.rand((n, d), generator=gen, device=device) * 4.0 - 2.0
    z = torch.randn((pairs, d), generator=gen, device=device)
    u = 2.0 * standard_gamma(gen, 1.5, pairs, device)
    w = torch.randn((2 * pairs, 1), generator=gen, device=device)
    omega = z * torch.sqrt(3.0 / u)[:, None] / lengthscale
    f = torch.cat([
        math.sqrt(1.0 / pairs) * torch.cat(
            [torch.cos(p), torch.sin(p)], dim=1) @ w
        for p in (x[i:i + 4096] @ omega.T for i in range(0, n, 4096))])[:, 0]
    y = f + noise * torch.randn((n,), generator=gen, device=device)
    x = (x - x.mean(0)) / (x.std(0, unbiased=False) + 1e-8)
    y = (y - y.mean()) / (y.std(unbiased=False) + 1e-8)
    return x, y


def pad_rows(x: torch.Tensor, y: torch.Tensor, block: int) -> tuple:
    """(x, y) padded with phantom rows (y = 0) to a multiple of ``block``."""
    n, d = x.shape
    rem = (-n) % block
    if rem == 0:
        return x, y
    far = PAD_FAR * (1.0 + torch.arange(rem, dtype=x.dtype, device=x.device))
    return (torch.cat([x, far[:, None].expand(rem, d)]),
            torch.cat([y, torch.zeros((rem,), dtype=y.dtype, device=y.device)]))


def make_draws(gen: torch.Generator, n: int, d: int, probes: int,
               pairs: int, device) -> dict:
    """Base draws of one lane's pathwise targets: RFF directions ``z`` (m,
    d), chi^2_3 mixture draws ``u`` (m,), feature weights ``w`` (2m, s)
    and the noise draws ``w_eps`` (n, s)."""
    return {
        "z": torch.randn((pairs, d), generator=gen, device=device),
        "u": 2.0 * standard_gamma(gen, 1.5, pairs, device),
        "w": torch.randn((2 * pairs, probes), generator=gen, device=device),
        "w_eps": torch.randn((n, probes), generator=gen, device=device),
    }


def initial_raw(d: int, init: dict, device) -> list:
    """Raw leaves [lengthscales (d,), signal, noise] at the configuration's
    constrained initial values (softplus^-1)."""
    def raw(val, shape=()):
        return torch.full(shape, math.log(math.expm1(val)),
                          dtype=torch.float32, device=device)

    return [raw(init["lengthscale"], (d,)), raw(init["signal"]),
            raw(init["noise"])]
