"""`ServableGP` — a fitted iterative GP frozen into a serving artifact.

Port of the in-memory part of ``repro.serve.artifact`` (save/load wait).
The artifact stores the pre-concatenated correction ``[v_y | v_y - z_hat_j]``
(computed once at export), the training inputs, the fixed RFF base draws and
the hyperparameters; a prediction is one cross-kernel MVM plus one RFF
feature evaluation.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.outer import OuterState
from repro_torch.core.predict import (
    Predictions,
    correction_matrix,
    pathwise_predict_from_correction,
)
from repro_torch.gp.hyperparams import HyperParams
from repro_torch.gp.rff import RFFState


class ServableGP(NamedTuple):
    """Frozen servable model.

    Attributes:
      x: (n, d) training inputs.
      correction: (n, 1+s) pre-concatenated ``[v_y | v_y - z_hat_j]``.
      rff: fixed RFF base draws behind the s posterior samples.
      params: hyperparameters at export time.
      kind: effective kernel name.
    """

    x: torch.Tensor
    correction: torch.Tensor
    rff: RFFState
    params: HyperParams
    kind: str = "matern32"

    @property
    def n(self) -> int:
        """Training rows frozen into the artifact."""
        return self.x.shape[0]

    @property
    def num_samples(self) -> int:
        """Posterior sample paths s (correction columns minus the mean)."""
        return self.correction.shape[1] - 1


def export_servable(state: OuterState, x: torch.Tensor,
                    kind: Optional[str] = None) -> ServableGP:
    """Freeze a pathwise-fitted `OuterState` into a `ServableGP`."""
    if state.probes.estimator != "pathwise":
        raise ValueError(
            "export_servable needs a pathwise fit; the standard estimator "
            "has no posterior samples among its solver outputs")
    return ServableGP(
        x=x,
        correction=correction_matrix(state.carry_v),
        rff=state.probes.rff,
        params=state.params,
        kind=kind if kind is not None else state.params.kernel,
    )


def servable_predict(model: ServableGP, xq: torch.Tensor) -> Predictions:
    """Posterior at ``xq`` from the frozen artifact."""
    with torch.no_grad():
        return pathwise_predict_from_correction(
            model.x, xq, model.correction, model.rff, model.params,
            kind=model.kind)
