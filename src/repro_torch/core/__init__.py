"""The paper's outer loop in the port: probes, gradients, Adam, fit, the
lane-batched fit, predict.

The public names of ``repro.core`` are exported here, resolved on first
access: ``repro_torch.core.driver`` imports ``repro_torch.checkpoint``,
which imports this package's modules, so an eager import here would be
circular.
"""

_EXPORTS = {
    "PATHWISE": "estimators", "STANDARD": "estimators",
    "ProbeState": "estimators", "build_system_targets": "estimators",
    "expected_initial_sqdistance": "estimators", "init_probes": "estimators",
    "probe_targets": "estimators",
    "exact_grad_reference": "gradients", "mll_grad_estimate": "gradients",
    "OuterConfig": "outer", "OuterState": "outer", "effective_kind": "outer",
    "init_outer_state": "outer", "init_outer_state_lanes": "outer",
    "outer_step": "outer", "outer_step_lanes": "outer",
    "outer_step_budget": "outer", "outer_step_budget_lanes": "outer",
    "outer_scan": "outer", "stack_states": "outer", "unstack_state": "outer",
    "num_lanes": "outer", "extend_state": "outer", "grow_capacity": "outer",
    "exact_outer_step": "outer",
    "Predictions": "predict", "correction_matrix": "predict",
    "mean_only_predict": "predict", "pathwise_predict": "predict",
    "pathwise_predict_from_correction": "predict",
    "predictive_metrics": "predict",
    "GRAD_EPOCH_EQUIV": "driver", "SGD_DIVERGENCE_THRESHOLD": "driver",
    "FitResult": "driver", "fit": "driver", "fit_batch": "driver",
    "evaluate": "driver", "init_hypers_heuristic": "driver",
    "pick_sgd_learning_rate": "driver",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
