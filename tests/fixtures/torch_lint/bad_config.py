"""Seeded config-discipline violations (exact lines asserted in tests)."""
from dataclasses import dataclass
from functools import lru_cache

import torch

from repro_torch.solvers.base import SolverNumerics


@dataclass(frozen=True)
class FrozenCfg:
    rank: int
    weights: torch.Tensor  # LINE 13: config-static-array


def cache_key(numerics: SolverNumerics):
    table = {numerics.tolerance: 1}  # LINE 17: config-static-traced
    return table, hash(numerics)  # LINE 18: config-static-traced


@lru_cache(maxsize=64)
def plan(n: int, numerics: SolverNumerics):  # LINE 22: config-static-traced
    return n * 2
