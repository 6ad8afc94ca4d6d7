"""Several `ServableGP`s (per kernel / per dataset) behind one engine; port
of ``repro.serve.multimodel``.

All compute goes through one `BucketedEngine`: a named model rides along
with each request, and its kernel name picks the forward kernel's profile
at launch time. Eager PyTorch keeps no executable cache, so
:meth:`MultiModelServer.warmup` returns None ("accounting unavailable").
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

import torch

from repro_torch.core.predict import Predictions
from repro_torch.serve.artifact import ServableGP
from repro_torch.serve.engine import DEFAULT_BUCKETS, BucketedEngine


class MultiModelServer:
    """Named-model registry delegating all compute to a shared engine."""

    def __init__(self, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 engine: Optional[BucketedEngine] = None):
        self.engine = engine if engine is not None else BucketedEngine(
            None, buckets=buckets)
        self._models: Dict[str, ServableGP] = {}  #: guarded by self._lock
        self._lock = threading.Lock()

    # -- registry -----------------------------------------------------------
    def register(self, name: str, model: ServableGP,
                 warmup: bool = False) -> None:
        """Add a named model (optionally running every bucket once)."""
        with self._lock:
            if name in self._models:
                raise ValueError(
                    f"model {name!r} already registered; use swap()")
            self._models[name] = model
        if warmup:
            self.engine.warmup(model)

    def swap(self, name: str, model: ServableGP) -> None:
        """Atomic replacement (the refresh handoff for named models)."""
        with self._lock:
            if name not in self._models:
                raise KeyError(f"unknown model {name!r}")
            self._models[name] = model

    def unregister(self, name: str) -> ServableGP:
        """Remove and return a named model (KeyError if absent)."""
        with self._lock:
            return self._models.pop(name)

    def get(self, name: str) -> ServableGP:
        """Look up a registered model by name (KeyError lists options)."""
        with self._lock:
            try:
                return self._models[name]
            except KeyError:
                raise KeyError(
                    f"unknown model {name!r}; registered: {sorted(self._models)}"
                ) from None

    def names(self) -> tuple:
        """Sorted names of all registered models."""
        with self._lock:
            return tuple(sorted(self._models))

    # -- serving ------------------------------------------------------------
    def warmup(self) -> Optional[int]:
        """Run every bucket once for every registered model; returns the
        engine's compile count (None: eager PyTorch)."""
        for name in self.names():
            self.engine.warmup(self.get(name))
        return self.engine.num_compiles()

    def submit(self, name: str, xq: torch.Tensor) -> Predictions:
        """Synchronous predict at ``xq`` through the named model."""
        return self.engine.submit(xq, model=self.get(name))

    def enqueue(self, name: str, xq: torch.Tensor):
        """Queued predict through the named model; returns a Future."""
        return self.engine.enqueue(xq, model=self.get(name))
