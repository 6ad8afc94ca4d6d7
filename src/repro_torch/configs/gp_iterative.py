"""gp-iterative: the paper's own "architecture", as the port runs it.

Port of ``repro.configs.gp_iterative``: iterative GP marginal-likelihood
optimisation (pathwise estimator, warm starts, epoch budgets) over any
registered stationary kernel, on the port's kernel registry and RFF
defaults. ``KERNEL_SWEEP`` is the multi-kernel scenario grid that
``repro_torch.launch.batch`` runs as lanes.
"""
from dataclasses import dataclass

from repro_torch.gp.rff import default_num_pairs
from repro_torch.kernels.registry import get_kernel


@dataclass(frozen=True)
class GPArchConfig:
    """One GP configuration (the reference's fields and defaults)."""

    name: str = "gp-iterative"
    kind: str = "matern32"  # any registered kernel name
    num_probes: int = 64
    num_rff_pairs: int = 1000
    estimator: str = "pathwise"
    warm_start: bool = True
    solver: str = "cg"
    solver_epochs: int = 10  # budget per outer step (paper §5)
    precond_rank: int = 0  # preconditioner off, as the reference's sweep
    block_rows: int = 1024  # per-device row tile of the reference's ring MVM

    def __post_init__(self):
        get_kernel(self.kind)  # fail fast on unknown kernel names


CONFIG = GPArchConfig()

SMOKE = GPArchConfig(num_probes=8, num_rff_pairs=64, solver_epochs=5)


def _sweep_entry(kind: str) -> GPArchConfig:
    # Matérn-1/2's Cauchy-tailed spectrum needs 4x the RFF pairs of the
    # light-tailed kernels for the same covariance error.
    return GPArchConfig(name=f"gp-iterative-{kind}", kind=kind,
                        num_rff_pairs=default_num_pairs(kind))


# One sweep entry per registered kernel: the multi-kernel scenario grid.
KERNEL_SWEEP = tuple(
    _sweep_entry(k) for k in ("matern12", "matern32", "matern52", "rbf")
)
