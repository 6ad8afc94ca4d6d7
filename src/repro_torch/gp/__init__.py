"""GP maths of the port: hyperparameters, dense and streamed kernels, RFF
prior samples and the exact GP; exports the names of the reference's
``repro.gp``."""
from repro_torch.gp.hyperparams import HyperParams, softplus, softplus_inverse
from repro_torch.gp.kernels_math import (
    h_mvm_dense,
    h_mvm_streamed,
    kernel_matrix,
    kernel_mvm_streamed,
    regularised_kernel_matrix,
    scaled_sqdist,
)
from repro_torch.gp.rff import RFFState, init_rff, prior_sample_at, rff_features
from repro_torch.gp.exact import (
    exact_mll,
    exact_mll_grad,
    exact_posterior,
    gaussian_loglik,
    rmse,
)

__all__ = [
    "HyperParams",
    "softplus",
    "softplus_inverse",
    "h_mvm_dense",
    "h_mvm_streamed",
    "kernel_matrix",
    "kernel_mvm_streamed",
    "regularised_kernel_matrix",
    "scaled_sqdist",
    "RFFState",
    "init_rff",
    "prior_sample_at",
    "rff_features",
    "exact_mll",
    "exact_mll_grad",
    "exact_posterior",
    "gaussian_loglik",
    "rmse",
]
