"""Prediction serving of the port on top of fitted iterative GPs.

The in-process half of ``repro.serve``:

  * :mod:`repro_torch.serve.artifact`   — frozen, checkpointable `ServableGP`
  * :mod:`repro_torch.serve.engine`     — shape-bucketed microbatching engine
    with its request queue
  * :mod:`repro_torch.serve.refresh`    — warm-started online model refresh
    (full re-solve, incremental ``mode="block"``, ``auto`` with the damped
    correction, geometric capacity growth)
  * :mod:`repro_torch.serve.multimodel` — several models behind one engine

The multi-process layer (HTTP transport, admission control, artifact
store, replicas, fleet monitor) is :mod:`repro_torch.serve.cluster`.
"""
from repro_torch.serve.artifact import (
    ServableGP,
    export_servable,
    load_servable,
    save_servable,
    servable_predict,
)
from repro_torch.serve.engine import BucketedEngine, EngineStats, pad_to_bucket
from repro_torch.serve.multimodel import MultiModelServer
from repro_torch.serve.refresh import (
    AUTO_COUPLING_FACTOR,
    GROWTH_EXACT,
    GROWTH_GEOMETRIC,
    OnlineGP,
    RefreshReport,
    merge_refined_state,
)

__all__ = [
    "ServableGP", "export_servable", "load_servable", "save_servable",
    "servable_predict",
    "BucketedEngine", "EngineStats", "pad_to_bucket",
    "MultiModelServer",
    "AUTO_COUPLING_FACTOR", "GROWTH_EXACT", "GROWTH_GEOMETRIC",
    "OnlineGP", "RefreshReport",
    "merge_refined_state",
]
