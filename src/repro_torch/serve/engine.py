"""Shape-bucketed prediction engine (synchronous path of ``repro.serve.engine``).

Every query batch is zero-padded to one of a few row buckets and answered
with one cross-kernel MVM (eq. 16); queries larger than the largest bucket
are chunked, and results are sliced back to the request's rows. PyTorch runs
eagerly, so there is no executable cache: :meth:`BucketedEngine.num_compiles`
returns None ("accounting unavailable"), as the reference's contract allows.
The queue worker and the Prometheus metrics arrive with a later slice.
"""
from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch

from repro_torch.core.predict import Predictions
from repro_torch.serve.artifact import ServableGP, servable_predict

DEFAULT_BUCKETS = (16, 64, 256)

STATS_SCHEMA_VERSION = 3

# Dispatch-latency histogram boundaries (seconds), as in the reference.
_LATENCY_BOUNDS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _quantile_from_buckets(bounds, cum_counts, q: float) -> float:
    """Prometheus ``histogram_quantile`` over cumulative bucket counts."""
    total = cum_counts[-1]
    if total <= 0:
        return math.nan
    target = q * total
    for i, bound in enumerate(bounds):
        if cum_counts[i] >= target:
            lo = bounds[i - 1] if i > 0 else 0.0
            below = cum_counts[i - 1] if i > 0 else 0.0
            in_bucket = cum_counts[i] - below
            if in_bucket <= 0:
                return bound
            return lo + (bound - lo) * (target - below) / in_bucket
    return bounds[-1]


def pad_to_bucket(xq: torch.Tensor, bucket: int) -> torch.Tensor:
    """Zero-pad query rows up to ``bucket`` (phantom rows are sliced off)."""
    m = xq.shape[0]
    if m == bucket:
        return xq
    if m > bucket:
        raise ValueError(f"query rows {m} exceed bucket {bucket}")
    pad = torch.zeros((bucket - m, xq.shape[1]), dtype=xq.dtype,
                      device=xq.device)
    return torch.cat([xq, pad])


def _slice_rows(pred: Predictions, lo: int, hi: int) -> Predictions:
    return Predictions(mean=pred.mean[lo:hi], var=pred.var[lo:hi],
                       samples=pred.samples[lo:hi])


@dataclass
class EngineStats:
    """Cumulative serving counters (padding waste is the bucketing tax)."""

    requests: int = 0  #: guarded by self._lock
    batches: int = 0  #: guarded by self._lock
    rows: int = 0  #: guarded by self._lock
    padded_rows: int = 0  #: guarded by self._lock
    coalesced: int = 0  #: guarded by self._lock
    per_bucket: dict = field(default_factory=dict)  #: guarded by self._lock
    latency_counts: list = field(
        default_factory=lambda: [0] * (len(_LATENCY_BOUNDS) + 1)
    )  #: guarded by self._lock
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def record(self, bucket: int, batch_rows: int, num_requests: int,
               dur_s: Optional[float] = None) -> None:
        """Count one engine dispatch (and its wall duration, when given)."""
        with self._lock:
            self.requests += num_requests
            self.batches += 1
            self.rows += batch_rows
            self.padded_rows += bucket - batch_rows
            if num_requests > 1:
                self.coalesced += num_requests
            self.per_bucket[bucket] = self.per_bucket.get(bucket, 0) + 1
            if dur_s is not None:
                for i, bound in enumerate(_LATENCY_BOUNDS):
                    if dur_s <= bound:
                        self.latency_counts[i] += 1
                        break
                else:
                    self.latency_counts[-1] += 1

    def as_dict(self, num_compiles: Optional[int] = None) -> dict:
        """JSON-serialisable snapshot in the reference's stats wire format."""
        with self._lock:
            executed = self.rows + self.padded_rows
            cum, running = [], 0
            for c in self.latency_counts:
                running += c
                cum.append(float(running))
            p50 = _quantile_from_buckets(_LATENCY_BOUNDS, cum, 0.5)
            p99 = _quantile_from_buckets(_LATENCY_BOUNDS, cum, 0.99)
            return {
                "ts": time.time(),
                "schema_version": STATS_SCHEMA_VERSION,
                "requests": self.requests,
                "batches": self.batches,
                "rows": self.rows,
                "padded_rows": self.padded_rows,
                "padding_waste": (self.padded_rows / executed) if executed else 0.0,
                "coalesced": self.coalesced,
                "per_bucket": {str(b): c for b, c in sorted(self.per_bucket.items())},
                "num_compiles": num_compiles,
                "latency_p50": None if math.isnan(p50) else p50,
                "latency_p99": None if math.isnan(p99) else p99,
            }


class BucketedEngine:
    """Serve `ServableGP` predictions with bucketed query shapes."""

    def __init__(self, model: Optional[ServableGP] = None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS):
        if not buckets:
            raise ValueError("need at least one bucket size")
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        self._model = model
        self.stats = EngineStats()

    @property
    def model(self) -> ServableGP:
        """The served artifact (raises when the engine was built without one)."""
        if self._model is None:
            raise RuntimeError("engine has no model; pass one to BucketedEngine")
        return self._model

    def warmup(self, model: Optional[ServableGP] = None) -> Optional[int]:
        """Run every bucket once (first-use allocations); returns None.

        These dispatches are not recorded in :attr:`stats`, as in the
        reference, but each one launches the cross-MVM kernel once.
        """
        model = model if model is not None else self.model
        for b in self.buckets:
            servable_predict(model, torch.zeros((b, model.x.shape[1]),
                                                dtype=model.x.dtype,
                                                device=model.x.device))
        return self.num_compiles()

    def num_compiles(self) -> Optional[int]:
        """None: eager PyTorch keeps no executable cache to count."""
        return None

    def stats_dict(self) -> dict:
        """`EngineStats.as_dict` with this engine's compile count."""
        return self.stats.as_dict(num_compiles=self.num_compiles())

    def bucket_for(self, m: int) -> int:
        """Smallest bucket covering ``m`` rows (largest bucket if none)."""
        for b in self.buckets:
            if m <= b:
                return b
        return self.buckets[-1]

    def submit(self, xq: torch.Tensor,
               model: Optional[ServableGP] = None) -> Predictions:
        """Predict at ``xq`` (m, d); pads to a bucket, slices back to m rows.

        Oversized queries are chunked into largest-bucket pieces.
        """
        model = model if model is not None else self.model
        m = xq.shape[0]
        bmax = self.buckets[-1]
        if m > bmax:
            parts = [self.submit(xq[lo:lo + bmax], model=model)
                     for lo in range(0, m, bmax)]
            return Predictions(
                mean=torch.cat([p.mean for p in parts]),
                var=torch.cat([p.var for p in parts]),
                samples=torch.cat([p.samples for p in parts]),
            )
        bucket = self.bucket_for(m)
        t0 = time.perf_counter()
        pred = servable_predict(model, pad_to_bucket(xq, bucket))
        self.stats.record(bucket, m, 1, dur_s=time.perf_counter() - t0)
        return _slice_rows(pred, 0, m)
