"""State carried across from the JAX reference as nested dicts of numpy arrays.

The caller flattens the reference's pytrees to numpy on its side (this
module never sees JAX). Layouts:

``outer_state_from_numpy``::

    {"params": {"raw_lengthscales", "raw_signal", "raw_noise", "kernel"},
     "adam": {"step", "mu": <params-like>, "nu": <params-like>},
     "probes": {"estimator", "z", "rff": {"z", "u", "w", "kind"} | None,
                "w_eps"},
     "carry_v", "step"}

A lane-stacked reference state (``init_outer_state_lanes``, ``vmap`` of
``outer_step``) has the same layout with a leading lane axis on every
array; its per-lane step counts must agree and become the port's shared
``step``. ``numerics_from_numpy`` and ``policy_from_numpy`` take the
fields of ``SolverNumerics`` and ``BudgetPolicy`` by name, scalar or
lane-stacked.

``servable_from_numpy``::

    {"x", "correction", "rff": {...}, "params": {...}, "kind"}

``gp_step_state_from_numpy`` (and ``gp_step_state_to_numpy``, its
inverse) carry the distributed step's ``GPStepState``::

    {"params": {...}, "adam": {"step", "mu", "nu"}, "carry_v" (n, 1 + s),
     "res_y", "res_z"}

``carry_v`` is split over the mesh's row axes; the rest sits on the mesh's
first device.

``outer_state_from_checkpoint`` reads a ``step_<k>.npz`` that the
reference's ``fit(ckpt_dir=...)`` wrote. Its leaves are those of
``jax.tree.leaves`` of the reference's ``OuterState``, in this order
(18 leaves for the standard estimator, 21 for pathwise):

    0-2    params: raw_lengthscales, raw_signal, raw_noise
    3      adam.step
    4-6    adam.mu (as params)
    7-9    adam.nu (as params)
    10     probes.z                                  (standard)
    10-13  probes.rff.z, probes.rff.u, probes.rff.w, probes.w_eps (pathwise)
    -7     carry_v
    -6     key          (JAX PRNG key; read and dropped)
    -5     step
    -4..-1 last_res_y, last_res_z, last_iters, last_epochs (dropped)

The kernel name is static in the reference (not a leaf), so the caller
names it.

``lm_params_from_numpy`` (and ``lm_params_to_numpy``, its inverse) carry
the LM substrate's parameter tree, a nested dict of arrays in the
reference's layout (``jax.tree.map(np.asarray, init_params(...))``);
``lm_adam_from_numpy`` / ``lm_adam_to_numpy`` its ``AdamState`` as
``{"step", "mu": <params-like>, "nu": <params-like>}``.

``lm_cache_from_numpy`` (and ``lm_cache_to_numpy``, its inverse) carry an
LM decode cache (``init_cache``'s tree). The reference hands bf16 leaves
over with numpy's ``bfloat16`` dtype (``ml_dtypes``, which the card's
machine lacks), which ``torch.from_numpy`` refuses: they move bit for bit
as 16-bit integers, and ``lm_cache_to_numpy`` gives bf16 leaves back as
``uint16`` bit patterns (``a.view(ml_dtypes.bfloat16)`` on the caller's
side).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import load_leaves
from repro_torch.core.estimators import ProbeState
from repro_torch.core.outer import OuterState
from repro_torch.distributed.gp_step import GPStepState
from repro_torch.distributed.sharding import shard_rows
from repro_torch.gp.hyperparams import HyperParams
from repro_torch.gp.rff import RFFState
from repro_torch.serve.artifact import ServableGP
from repro_torch.solvers.adaptive import BudgetPolicy
from repro_torch.solvers.base import SolverNumerics
from repro_torch.train.adam import AdamState


def _t(a, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.as_tensor(np.array(a), device=device)


def _params(tree: dict, device, kernel: Optional[str] = None) -> HyperParams:
    return HyperParams(
        raw_lengthscales=_t(tree["raw_lengthscales"], device),
        raw_signal=_t(tree["raw_signal"], device),
        raw_noise=_t(tree["raw_noise"], device),
        kernel=kernel if kernel is not None else tree["kernel"],
    )


def _rff(tree: Optional[dict], device) -> Optional[RFFState]:
    if tree is None:
        return None
    return RFFState(z=_t(tree["z"], device), u=_t(tree["u"], device),
                    w=_t(tree["w"], device), kind=tree["kind"])


def _step(a) -> int:
    """A step count: a scalar, or the lanes' equal counts."""
    steps = np.unique(np.asarray(a))
    if steps.size != 1:
        raise ValueError(f"lanes at different steps: {steps.tolist()}")
    return int(steps[0])


def outer_state_from_numpy(tree: dict, device="cpu") -> OuterState:
    """The reference's ``OuterState`` (as numpy dicts, scalar or
    lane-stacked) as the port's."""
    params = _params(tree["params"], device)
    adam = tree["adam"]
    probes = tree["probes"]
    return OuterState(
        params=params,
        adam=AdamState(
            step=_step(adam["step"]),
            mu=_params(adam["mu"], device, kernel=params.kernel),
            nu=_params(adam["nu"], device, kernel=params.kernel),
        ),
        probes=ProbeState(
            estimator=probes["estimator"], z=_t(probes.get("z"), device),
            rff=_rff(probes.get("rff"), device),
            w_eps=_t(probes.get("w_eps"), device),
        ),
        carry_v=_t(tree["carry_v"], device),
        step=_step(tree["step"]),
    )


def gp_step_state_from_numpy(tree: dict, mesh) -> GPStepState:
    """The reference's distributed ``GPStepState`` (as numpy dicts) as the
    port's on ``mesh``."""
    device = mesh.devices[0]
    params = _params(tree["params"], device)
    adam = tree["adam"]
    return GPStepState(
        params=params,
        adam=AdamState(step=_step(adam["step"]),
                       mu=_params(adam["mu"], device, kernel=params.kernel),
                       nu=_params(adam["nu"], device, kernel=params.kernel)),
        carry_v=shard_rows(_t(tree["carry_v"], device), mesh),
        res_y=_t(tree["res_y"], device), res_z=_t(tree["res_z"], device))


def gp_step_state_to_numpy(state: GPStepState) -> dict:
    """A port ``GPStepState`` in :func:`gp_step_state_from_numpy`'s layout
    (``carry_v`` gathered)."""
    def arr(t):
        return t.detach().cpu().numpy()

    def params(p):
        return {"raw_lengthscales": arr(p.raw_lengthscales),
                "raw_signal": arr(p.raw_signal),
                "raw_noise": arr(p.raw_noise), "kernel": p.kernel}

    return {"params": params(state.params),
            "adam": {"step": np.asarray(state.adam.step),
                     "mu": params(state.adam.mu),
                     "nu": params(state.adam.nu)},
            "carry_v": arr(state.carry_v.gather("cpu")),
            "res_y": arr(state.res_y), "res_z": arr(state.res_z)}


def numerics_from_numpy(tree: dict, device="cpu") -> SolverNumerics:
    """The reference's ``SolverNumerics`` (fields by name) as the port's."""
    return SolverNumerics(*(_t(tree[f], device).to(torch.float32)
                            for f in SolverNumerics._fields))


def policy_from_numpy(tree: dict, device="cpu") -> BudgetPolicy:
    """The reference's ``BudgetPolicy`` (fields by name) as the port's."""
    return BudgetPolicy(*(_t(tree[f], device) for f in BudgetPolicy._fields))


def servable_from_numpy(tree: dict, device="cpu") -> ServableGP:
    """The reference's ``ServableGP`` (as numpy dicts) as the port's."""
    return ServableGP(
        x=_t(tree["x"], device),
        correction=_t(tree["correction"], device),
        rff=_rff(tree["rff"], device),
        params=_params(tree["params"], device),
        kind=tree["kind"],
    )


_REF_ESTIMATOR_BY_LEAVES = {18: "standard", 21: "pathwise"}


def outer_state_from_checkpoint(npz_path: str, kernel: str = "matern32",
                                device="cpu") -> OuterState:
    """The port's `OuterState` from a checkpoint the reference wrote (leaf
    order in the module docstring); ``kernel`` names the params' and the
    RFF draws' kernel."""
    leaves = load_leaves(npz_path)
    estimator = _REF_ESTIMATOR_BY_LEAVES.get(len(leaves))
    if estimator is None:
        raise ValueError(f"{npz_path}: {len(leaves)} leaves is not a "
                         "reference OuterState (18 or 21)")

    def params(i):
        return {"raw_lengthscales": leaves[i], "raw_signal": leaves[i + 1],
                "raw_noise": leaves[i + 2], "kernel": kernel}

    if estimator == "standard":
        probes = {"estimator": estimator, "z": leaves[10], "rff": None,
                  "w_eps": None}
    else:
        probes = {"estimator": estimator, "z": None,
                  "rff": {"z": leaves[10], "u": leaves[11], "w": leaves[12],
                          "kind": kernel},
                  "w_eps": leaves[13]}
    return outer_state_from_numpy(
        {"params": params(0),
         "adam": {"step": leaves[3], "mu": params(4), "nu": params(7)},
         "probes": probes, "carry_v": leaves[-7], "step": leaves[-5]},
        device=device)


def lm_params_from_numpy(tree: dict, device="cpu") -> dict:
    """An LM parameter tree of numpy arrays as tensors on ``device``
    (dtype kept, values bit for bit)."""
    return {k: lm_params_from_numpy(v, device) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)).to(device)
            for k, v in tree.items()}


def lm_params_to_numpy(params: dict) -> dict:
    """The inverse of :func:`lm_params_from_numpy` (arrays on the host)."""
    return {k: lm_params_to_numpy(v) if isinstance(v, dict)
            else v.detach().cpu().numpy() for k, v in params.items()}


def lm_adam_from_numpy(tree: dict, device="cpu") -> AdamState:
    """The reference's LM ``AdamState`` (``{"step", "mu", "nu"}``) as the
    port's."""
    return AdamState(step=_step(tree["step"]),
                     mu=lm_params_from_numpy(tree["mu"], device),
                     nu=lm_params_from_numpy(tree["nu"], device))


def lm_adam_to_numpy(state: AdamState) -> dict:
    """The inverse of :func:`lm_adam_from_numpy`."""
    return {"step": np.asarray(state.step, dtype=np.int32),
            "mu": lm_params_to_numpy(state.mu),
            "nu": lm_params_to_numpy(state.nu)}


def lm_cache_from_numpy(tree: dict, device="cpu") -> dict:
    """An LM cache tree of numpy arrays as tensors on ``device``; bf16
    leaves (numpy's ``bfloat16``) move as their bit patterns."""
    def leaf(a):
        a = np.array(a)
        if a.dtype.name == "bfloat16":  # ml_dtypes' type, by name
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)

    return {k: lm_cache_from_numpy(v, device) if isinstance(v, dict)
            else leaf(v) for k, v in tree.items()}


def lm_cache_to_numpy(cache: dict) -> dict:
    """The inverse of :func:`lm_cache_from_numpy` (arrays on the host; bf16
    leaves as ``uint16`` bit patterns)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    return {k: lm_cache_to_numpy(v) if isinstance(v, dict) else leaf(v)
            for k, v in cache.items()}
