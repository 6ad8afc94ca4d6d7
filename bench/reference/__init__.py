"""The benchmark's plain reference of one marginal-likelihood step.

Plain PyTorch, float32, written from the paper's equations (Lin et al.,
NeurIPS 2024, §2-§3 and App. B) and independent of the program: it imports
nothing of ``repro_torch`` and takes nothing the program derived. ``gp``
holds the Matérn-3/2 kernel, the pathwise targets, kernel products in row
blocks, the pathwise hyper-gradient and Adam; ``solvers`` what the solvers
share (the pivoted Cholesky preconditioner); ``solve_<name>`` each solver
and the forward products it takes; ``judge`` checks one step of the
program against them and runs the reference in the program's place.
"""
import importlib


def solver(name: str):
    """The module ``bench/reference/solve_<name>.py``: its ``solve`` and
    ``forward_products``."""
    return importlib.import_module(f"{__name__}.solve_{name}")
