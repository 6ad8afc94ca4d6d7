"""`ServableGP` — a fitted iterative GP frozen into a serving artifact.

Port of ``repro.serve.artifact``. The artifact stores the pre-concatenated
correction ``[v_y | v_y - z_hat_j]`` (computed once at export), the
training inputs, the fixed RFF base draws and the hyperparameters; a
prediction is one cross-kernel MVM plus one RFF feature evaluation.

Persistence (:func:`save_servable` / :func:`load_servable`) writes the
reference's on-disk format through :mod:`repro_torch.checkpoint`:
``step_<k>.npz`` holds the leaves positionally as ``leaf_i`` in the
reference's pytree order

    x, correction, rff.z, rff.u, rff.w,
    params.raw_lengthscales, params.raw_signal, params.raw_noise

and the JSON sidecar records ``artifact: "ServableGP"``, the static kernel
names and the shapes, so either package loads what the other saved.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from repro_torch.checkpoint import load_leaves, load_metadata, save_checkpoint
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


def save_servable(ckpt_dir: str, model: ServableGP, step: int = 0,
                  keep: int = 3) -> str:
    """Atomically persist the artifact; returns the checkpoint path."""
    meta = {
        "artifact": "ServableGP",
        "kind": model.kind,
        "rff_kind": model.rff.kind,
        "kernel": model.params.kernel,
        "n": int(model.x.shape[0]),
        "d": int(model.x.shape[1]),
        "num_samples": int(model.num_samples),
        "num_rff_pairs": int(model.rff.z.shape[0]),
        "dtype": str(model.x.dtype).replace("torch.", ""),
    }
    return save_checkpoint(ckpt_dir, step, model, metadata=meta, keep=keep)


def load_servable(ckpt_dir: str, step: Optional[int] = None,
                  device="cuda") -> ServableGP:
    """Restore a `ServableGP` from disk using only the sidecar metadata,
    onto ``device`` (the card unless the caller asks for the CPU)."""
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    meta = load_metadata(ckpt_dir, step)
    if meta.get("artifact") != "ServableGP":
        raise ValueError(
            f"checkpoint under {ckpt_dir} is not a ServableGP artifact "
            f"(metadata: {meta})")
    leaves = load_leaves(os.path.join(ckpt_dir, f"step_{meta['step']}.npz"))
    if len(leaves) != 8:
        raise ValueError(f"{ckpt_dir}: a ServableGP has 8 leaves, the "
                         f"checkpoint {len(leaves)}")
    dtype = getattr(torch, meta["dtype"])
    n, d, s, m = meta["n"], meta["d"], meta["num_samples"], meta["num_rff_pairs"]
    shapes = [(n, d), (n, 1 + s), (m, d), (m,), (2 * m, s), (d,), (), ()]
    t = []
    for a, shape in zip(leaves, shapes):
        if tuple(a.shape) != shape:
            raise ValueError(f"{ckpt_dir}: leaf of shape {a.shape}, the "
                             f"sidecar says {shape}")
        t.append(torch.as_tensor(a, dtype=dtype, device=device))
    return ServableGP(
        x=t[0], correction=t[1],
        rff=RFFState(z=t[2], u=t[3], w=t[4], kind=meta["rff_kind"]),
        params=HyperParams(*t[5:8], kernel=meta["kernel"]),
        kind=meta["kind"])
