"""Shape-bucketed microbatching prediction engine; port of
``repro.serve.engine``.

Every query batch is zero-padded to one of a few row buckets and answered
with one cross-kernel MVM (eq. 16): on the card, one launch of the forward
tile kernel. Queries larger than the largest bucket are chunked, and
results are sliced back to the request's rows before they leave the
engine. Queued requests (:meth:`BucketedEngine.enqueue`) are coalesced by a
worker thread into shared bucket runs. PyTorch runs eagerly, so there is no
executable cache: :meth:`BucketedEngine.num_compiles` returns None
("accounting unavailable"), as the reference's contract allows.

Threads and the card: the worker launches on its current stream, which
for a new thread is the device's default stream, the one the caller's
thread launches on too. So a request's result (a CUDA tensor the Future
hands over, possibly still being computed) is ordered before anything its
consumer launches next, and a model swapped in by another thread on that
stream is fully written before the next dispatch reads it.
"""
from __future__ import annotations

import math
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch

from repro_torch.core.predict import Predictions
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.artifact import ServableGP, servable_predict

DEFAULT_BUCKETS = (16, 64, 256)

# Version of the stats wire format (`EngineStats.as_dict`), the reference's.
STATS_SCHEMA_VERSION = 3

# Batch-latency buckets for the in-process p50/p99 estimate: the boundaries
# the Prometheus histogram uses, so stats and scrape-side quantiles agree.
_LATENCY_BOUNDS = obs_metrics.DEFAULT_BUCKETS


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
    """Cumulative serving counters (padding waste is the bucketing tax).

    Updated from both the caller thread (sync `submit`) and the queue worker,
    so increments go through an internal lock.
    """

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
            p50 = obs_metrics.quantile_from_buckets(_LATENCY_BOUNDS, cum, 0.5)
            p99 = obs_metrics.quantile_from_buckets(_LATENCY_BOUNDS, cum, 0.99)
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
    """Serve `ServableGP` predictions with bucketed shapes and a request
    queue.

    Synchronous path: :meth:`submit` pads, runs, slices. Asynchronous path:
    :meth:`enqueue` returns a `Future`; a worker thread drains the queue,
    coalescing same-model requests into shared bucket runs. ``registry``
    (default: the process-wide one; ``obs.NULL_REGISTRY`` switches the
    instruments off) receives the six ``gp_engine_*`` instruments.
    """

    def __init__(self, model: Optional[ServableGP] = None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 registry: Optional[obs_metrics.MetricsRegistry] = None):
        if not buckets:
            raise ValueError("need at least one bucket size")
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        self._model = model  #: guarded by self._model_lock
        self._model_lock = threading.Lock()
        reg = obs_metrics.default_registry() if registry is None else registry
        self._m_requests = reg.counter(
            "gp_engine_requests_total", "Requests served by the engine")
        self._m_batches = reg.counter(
            "gp_engine_batches_total", "Jitted bucket executions",
            labelnames=("bucket",))
        self._m_rows = reg.counter(
            "gp_engine_rows_total", "Query rows executed by kind",
            labelnames=("kind",))  # kind: real | padded
        self._m_coalesced = reg.counter(
            "gp_engine_coalesced_total",
            "Requests that shared a microbatch with another")
        self._m_queue_depth = reg.gauge(
            "gp_engine_queue_depth", "Requests waiting in the engine queue")
        self._m_batch_seconds = reg.histogram(
            "gp_engine_batch_seconds", "Engine dispatch latency per bucket",
            labelnames=("bucket",))
        self.stats = EngineStats()
        self._queue: queue.Queue = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- model management ---------------------------------------------------
    @property
    def model(self) -> ServableGP:
        """The currently served artifact (raises before the first swap)."""
        with self._model_lock:
            if self._model is None:
                raise RuntimeError("engine has no model; pass one or swap_model")
            return self._model

    def swap_model(self, model: ServableGP) -> None:
        """Atomically replace the served model (the refresh handoff)."""
        with self._model_lock:
            self._model = model

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

    def _observe(self, bucket: int, batch_rows: int, num_requests: int,
                 dur_s: float) -> None:
        """Fold one dispatch into stats + metrics (both paths share this)."""
        self.stats.record(bucket, batch_rows, num_requests, dur_s=dur_s)
        self._m_requests.inc(num_requests)
        self._m_batches.inc(bucket=str(bucket))
        self._m_rows.inc(batch_rows, kind="real")
        self._m_rows.inc(bucket - batch_rows, kind="padded")
        if num_requests > 1:
            self._m_coalesced.inc(num_requests)
        self._m_batch_seconds.observe(dur_s, bucket=str(bucket))

    # -- synchronous serving ------------------------------------------------
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
        with obs_trace.span("engine.submit", bucket=bucket, rows=m):
            t0 = time.perf_counter()
            pred = servable_predict(model, pad_to_bucket(xq, bucket))
            self._observe(bucket, m, 1, time.perf_counter() - t0)
        return _slice_rows(pred, 0, m)

    # -- queued / microbatched serving --------------------------------------
    def enqueue(self, xq: torch.Tensor,
                model: Optional[ServableGP] = None) -> Future:
        """Queue a request; the worker thread resolves the returned Future."""
        fut: Future = Future()
        self._queue.put((xq, model, fut))
        self._m_queue_depth.set(self._queue.qsize())
        if self._worker is None:
            self.start()
        return fut

    def start(self) -> None:
        """Start the microbatching worker thread (idempotent)."""
        if self._worker is not None:
            return
        self._stop.clear()
        self._worker = threading.Thread(
            target=self._worker_loop, name="serve-engine", daemon=True)
        self._worker.start()

    def stop(self) -> None:
        """Stop the worker thread, draining the queue first."""
        if self._worker is None:
            return
        self._stop.set()
        self._queue.put(None)  # wake the worker
        self._worker.join(timeout=10.0)
        self._worker = None

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            item = self._queue.get()
            self._m_queue_depth.set(self._queue.qsize())
            if item is None:
                continue
            self._run_coalesced(item)

    def _run_coalesced(self, first) -> None:
        """One microbatch: the head request plus any queued same-model
        requests that still fit in the largest bucket. An error fails every
        request of the batch through its Future."""
        batch = [first]
        total = first[0].shape[0]
        bmax = self.buckets[-1]
        while total < bmax:
            try:
                nxt = self._queue.queue[0]  # peek
            except IndexError:
                break
            if nxt is None:
                break
            if nxt[1] is not first[1]:  # different explicit model: own batch
                break
            if total + nxt[0].shape[0] > bmax:
                break
            self._queue.get()
            batch.append(nxt)
            total += nxt[0].shape[0]
        self._m_queue_depth.set(self._queue.qsize())

        try:
            model = first[1] if first[1] is not None else self.model
            xq = (batch[0][0] if len(batch) == 1
                  else torch.cat([b[0] for b in batch]))
            bucket = self.bucket_for(total)
            if total > bucket:  # only when a single oversized request
                pred = self.submit(xq, model=model)
            else:
                t0 = time.perf_counter()
                pred = _slice_rows(
                    servable_predict(model, pad_to_bucket(xq, bucket)),
                    0, total)
                self._observe(bucket, total, len(batch),
                              time.perf_counter() - t0)
            lo = 0
            for xq_i, _, fut in batch:
                hi = lo + xq_i.shape[0]
                fut.set_result(_slice_rows(pred, lo, hi))
                lo = hi
        except Exception as e:  # surface errors through the futures
            for _, _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)
