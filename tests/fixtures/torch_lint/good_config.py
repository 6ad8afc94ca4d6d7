"""Config-disciplined twin of bad_config.py: numerics stay per-lane tensors
beside a static key."""
from dataclasses import dataclass
from functools import lru_cache

from repro_torch.solvers.base import SolverConfig, SolverNumerics


@dataclass(frozen=True)
class FrozenCfg:
    rank: int
    tol_exponent: int  # scalars only: hashes by value


def cache_key(cfg: FrozenCfg):
    return {cfg: 1}, hash(cfg)  # the static config IS the key


@lru_cache(maxsize=64)
def plan(n: int, cfg: SolverConfig):
    return n * cfg.block_size


def step(x, numerics: SolverNumerics, cfg: SolverConfig):
    return x * numerics.learning_rate * plan(x.shape[0], cfg)
