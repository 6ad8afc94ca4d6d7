"""Back-compat shim, as the reference's ``repro.kernels.matern``: the
Matérn-3/2 path is the ``matern32`` entry of ``repro_torch.kernels``
(registry + tiled + ops + ref), and these are its original names. Import
from there in new code."""
from repro_torch.kernels.ops import h_mvm, kernel_mvm, matern_mvm
from repro_torch.kernels.ref import h_mvm_ref, kernel_mvm_ref, matern_mvm_ref
from repro_torch.kernels.tiled import matern_mvm_bwd_pallas, matern_mvm_pallas

__all__ = [
    "matern_mvm",
    "h_mvm",
    "matern_mvm_ref",
    "h_mvm_ref",
    "kernel_mvm",
    "kernel_mvm_ref",
    "matern_mvm_pallas",
    "matern_mvm_bwd_pallas",
]
