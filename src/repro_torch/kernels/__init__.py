"""Kernel profiles, the dense oracle and the distance-tile kernels.

``registry`` holds the stationary kernel profiles (RBF, Matérn-1/2, -3/2,
-5/2: profile, derivative, spectral sampler); ``tiled`` the hand-written
CUDA kernels and their plain versions; ``ops`` the differentiable op around
them; ``ref`` the dense oracle. The names the reference's package exports
are exported here, the ``matern_*`` compatibility aliases among them; the
ops and the oracle are imported at first use, since ``ref`` builds on
``repro_torch.gp.kernels_math``, which imports the registry.
"""
from repro_torch.kernels.registry import (
    KERNELS,
    KernelSpec,
    available_kernels,
    get_kernel,
    register_kernel,
)

_LAZY = {"kernel_mvm": "ops", "h_mvm": "ops", "matern_mvm": "ops",
         "kernel_mvm_ref": "ref", "h_mvm_ref": "ref", "matern_mvm_ref": "ref"}

__all__ = [
    "KERNELS",
    "KernelSpec",
    "available_kernels",
    "get_kernel",
    "register_kernel",
    "kernel_mvm",
    "h_mvm",
    "kernel_mvm_ref",
    "h_mvm_ref",
    "matern_mvm",
    "matern_mvm_ref",
]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module = importlib.import_module(f"repro_torch.kernels.{_LAZY[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
