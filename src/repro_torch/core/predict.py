"""Pathwise-conditioning predictions (paper eqs. 3, 16).

Port of ``repro.core.predict``. With the pathwise estimator the solved probe
systems are posterior samples:

    (f|y)(.) = f(.) + k(., x) (v_y - z_hat_j)        [eq. 16]

so a prediction costs one cross-kernel MVM (mean and all s corrections in
one product) plus one RFF feature evaluation, and zero solves. The
cross-MVM runs through :func:`repro_torch.kernels.ops.kernel_mvm`, i.e. the
forward tile kernel on CUDA tensors (the reference used its plain jnp tile).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.estimators import ProbeState
from repro_torch.gp.exact import gaussian_loglik, rmse
from repro_torch.gp.hyperparams import HyperParams
from repro_torch.gp.rff import RFFState, prior_sample_at
from repro_torch.kernels.ops import kernel_mvm


class Predictions(NamedTuple):
    """Posterior at query points: mean, variance, and sample paths."""

    mean: torch.Tensor  # (m,) latent posterior mean k(xs,x) v_y
    var: torch.Tensor  # (m,) latent variance (sample estimate over s paths)
    samples: torch.Tensor  # (m, s) posterior function samples at xs


def correction_matrix(v: torch.Tensor) -> torch.Tensor:
    """Pre-concatenated correction ``[v_y | v_y - z_hat_1..z_hat_s]``."""
    v_y = v[:, :1]
    return torch.cat([v_y, v_y - v[:, 1:]], dim=1)


def _sample_variance(samples: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """Unbiased per-row variance over the s posterior samples (s >= 2)."""
    s = samples.shape[1]
    if s < 2:
        raise ValueError(
            f"posterior variance needs >= 2 pathwise samples, got s={s}; "
            "fit with num_probes >= 2")
    var = torch.sum((samples - mean[:, None]) ** 2, dim=1) / (s - 1)
    return torch.clamp_min(var, 1e-12)


def pathwise_predict_from_correction(
    x: torch.Tensor,
    xs: torch.Tensor,
    correction: torch.Tensor,
    rff: RFFState,
    params: HyperParams,
    kind: Optional[str] = None,
) -> Predictions:
    """Eq. 16 evaluated from a precomputed correction matrix (serving path)."""
    s_corr, s_rff = correction.shape[1] - 1, rff.w.shape[1]
    if s_corr != s_rff:
        raise ValueError(
            f"correction carries {s_corr} sample columns but the RFF state "
            f"holds {s_rff} prior samples; they must come from the same fit")
    cross = kernel_mvm(xs, x, correction, params, kind=kind)
    mean = cross[:, 0]
    samples = prior_sample_at(xs, rff, params) + cross[:, 1:]
    return Predictions(mean=mean, var=_sample_variance(samples, mean),
                       samples=samples)


def pathwise_predict(
    x: torch.Tensor,
    xs: torch.Tensor,
    v: torch.Tensor,
    probes: ProbeState,
    params: HyperParams,
    kind: Optional[str] = None,
) -> Predictions:
    """Posterior mean/variance/samples at xs from pathwise solver output."""
    if probes.estimator != "pathwise":
        raise ValueError("pathwise_predict needs pathwise solver output")
    return pathwise_predict_from_correction(
        x, xs, correction_matrix(v), probes.rff, params, kind=kind)


def predictive_metrics(y_test: torch.Tensor, pred: Predictions,
                       params: HyperParams) -> dict:
    """Test RMSE and mean predictive log-likelihood (paper's metrics)."""
    var_y = pred.var + params.noise**2
    return {
        "rmse": rmse(y_test, pred.mean),
        "llh": gaussian_loglik(y_test, pred.mean, var_y),
    }


def mean_only_predict(x: torch.Tensor, xs: torch.Tensor, v_y: torch.Tensor,
                      params: HyperParams,
                      kind: Optional[str] = None) -> torch.Tensor:
    """``k(xs, x) @ v_y``: the posterior mean for either estimator (no
    variance), through the forward tile kernel."""
    return kernel_mvm(xs, x, v_y[:, None], params, kind=kind)[:, 0]
