"""Deadline-aware admission control for the serving front-end; the port's
own copy of ``repro.serve.cluster.admission`` (same decisions, retry hints
and ``gp_admission_*`` families).

Overload policy (the transport maps every rejection to ``429`` with a
``Retry-After`` header):

  * **per-bucket token buckets** — each engine row bucket gets its own
    refill rate, so one class of large queries cannot exhaust the budget
    of the cheap ones (the engine pads to the bucket anyway, so the bucket
    IS the cost class);
  * **bounded concurrency** — at most ``max_inflight`` requests may be
    inside compute at once; beyond that the request would only queue, so
    it is shed instead of parked;
  * **deadline-aware shedding** — a request whose deadline cannot be met
    given the current queue (estimated wait = inflight x EWMA service
    time) is rejected *immediately*: failing fast at admission is cheaper
    for everyone than timing out after burning a slot;
  * **priority classes** — refresh/admin traffic (model swaps, drains,
    health checks) bypasses the rate limiter and the inflight cap, so
    operational work is never starved by a prediction flood.

Everything is stdlib + a single lock; the clock is injectable so tests are
deterministic.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from enum import IntEnum
from typing import Dict, Optional, Sequence

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


class Priority(IntEnum):
    """Higher value = more important; ADMIN/REFRESH are never shed."""

    PREDICT = 0
    REFRESH = 1
    ADMIN = 2


def parse_priority(name: str) -> Priority:
    """Case-insensitive wire-string -> :class:`Priority` (ValueError lists options)."""
    try:
        return Priority[name.upper()]
    except KeyError:
        raise ValueError(
            f"unknown priority {name!r}; options: "
            f"{[p.name.lower() for p in Priority]}"
        ) from None


@dataclass
class Decision:
    """Admission verdict; ``retry_after_s`` is meaningful when shed."""

    admitted: bool
    reason: str = "ok"  # ok | rate | inflight | deadline | bypass
    retry_after_s: float = 0.0


# Closed label vocabulary for the decisions counter: a new shed reason
# cannot silently mint a new metric series without touching this table.
_SHED_LABELS = {
    "rate": "shed_rate",
    "inflight": "shed_inflight",
    "deadline": "shed_deadline",
}


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill, ``burst`` capacity.

    ``try_acquire`` never blocks; on refusal it reports how long until the
    requested tokens would be available (the Retry-After hint).
    """

    def __init__(self, rate: float, burst: float):
        if rate <= 0 or burst <= 0:
            raise ValueError(f"rate and burst must be positive, got "
                             f"rate={rate} burst={burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._t = None  # lazily pinned to the first observed clock

    def _refill(self, now: float) -> None:
        if self._t is None:
            self._t = now
        self._tokens = min(self.burst, self._tokens + (now - self._t) * self.rate)
        self._t = now

    def try_acquire(self, tokens: float = 1.0,
                    now: Optional[float] = None) -> tuple[bool, float]:
        """Returns (acquired, retry_after_s)."""
        now = time.monotonic() if now is None else now
        self._refill(now)
        if self._tokens >= tokens:
            self._tokens -= tokens
            return True, 0.0
        return False, (tokens - self._tokens) / self.rate

    def available(self, now: Optional[float] = None) -> float:
        """Current token fill after refill (the explainability export)."""
        now = time.monotonic() if now is None else now
        self._refill(now)
        return self._tokens


@dataclass
class AdmissionStats:
    """Cumulative admission counters (all monotone; lock held by caller)."""

    admitted: int = 0
    shed_rate: int = 0
    shed_inflight: int = 0
    shed_deadline: int = 0
    bypassed: int = 0  # REFRESH/ADMIN admissions that skipped the limits

    def as_dict(self) -> dict:
        """Counters as a JSON-ready dict (adds the aggregate ``shed``)."""
        shed = self.shed_rate + self.shed_inflight + self.shed_deadline
        return {
            "admitted": self.admitted,
            "bypassed": self.bypassed,
            "shed": shed,
            "shed_rate": self.shed_rate,
            "shed_inflight": self.shed_inflight,
            "shed_deadline": self.shed_deadline,
        }


class AdmissionController:
    """Gate in front of the engine; one instance per serving process.

    Args:
      buckets: engine row buckets (each gets its own token bucket).
      rate_qps: sustained admitted requests/s per bucket class (None
        disables rate limiting — the inflight cap still applies).
      burst: token-bucket capacity (defaults to ``2 * rate_qps``).
      max_inflight: concurrent in-compute requests before load shedding.
      default_deadline_ms: applied when a request carries no deadline;
        None disables deadline shedding for deadline-less requests.
    """

    def __init__(
        self,
        buckets: Sequence[int] = (),
        rate_qps: Optional[float] = None,
        burst: Optional[float] = None,
        max_inflight: int = 64,
        default_deadline_ms: Optional[float] = None,
        service_ewma_alpha: float = 0.2,
        registry: Optional[obs_metrics.MetricsRegistry] = None,
    ):
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        self.max_inflight = int(max_inflight)
        self.default_deadline_ms = default_deadline_ms
        self._alpha = float(service_ewma_alpha)
        self._limiters: Dict[int, TokenBucket] = {}
        if rate_qps is not None:
            b = burst if burst is not None else 2.0 * rate_qps
            keys = self.buckets if self.buckets else (0,)
            self._limiters = {k: TokenBucket(rate_qps, b) for k in keys}
        self._lock = threading.Lock()
        self._inflight = 0  #: guarded by self._lock
        self._service_ewma_s = 0.0  #: guarded by self._lock
        self.stats = AdmissionStats()  #: guarded by self._lock
        # Observability: None => process default registry; pass
        # obs_metrics.NULL_REGISTRY to disable. Every admit() outcome becomes
        # a labelled counter tick and a structured "admission" event carrying
        # the caller's current trace ID (no-op when no event log is active).
        reg = obs_metrics.default_registry() if registry is None else registry
        self._m_decisions = reg.counter(
            "gp_admission_decisions_total", "Admission outcomes",
            labelnames=("outcome",))
        self._m_inflight = reg.gauge(
            "gp_admission_inflight", "Requests between admit and release")
        self._m_ewma = reg.gauge(
            "gp_admission_service_ewma_seconds",
            "EWMA per-request service time driving deadline shedding")
        self._m_tokens = reg.gauge(
            "gp_admission_bucket_tokens", "Token-bucket fill per row bucket",
            labelnames=("bucket",))

    # -- helpers -------------------------------------------------------------
    def _bucket_for(self, rows: int) -> int:
        for b in self.buckets:
            if rows <= b:
                return b
        return self.buckets[-1] if self.buckets else 0

    @property
    def inflight(self) -> int:
        """Requests currently between :meth:`admit` and :meth:`release`."""
        with self._lock:
            return self._inflight

    @property
    def service_ewma_s(self) -> float:
        """EWMA of per-request compute time (seconds); drives deadline shedding."""
        with self._lock:
            return self._service_ewma_s

    # -- the gate ------------------------------------------------------------
    def admit(
        self,
        rows: int = 1,
        deadline_ms: Optional[float] = None,
        priority: Priority = Priority.PREDICT,
        now: Optional[float] = None,
    ) -> Decision:
        """Admit or shed one request of ``rows`` query rows.

        Admitted requests MUST be paired with :meth:`release` (use
        :meth:`track` for the with-statement form) or the inflight gauge
        leaks and eventually sheds everything.
        """
        now = time.monotonic() if now is None else now
        with self._lock:
            decision = self._admit_locked(rows, deadline_ms, priority, now)
            inflight = self._inflight
        # Instrumentation outside the admission lock (the event log does
        # file IO): one labelled counter tick + one structured event that
        # carries the handler thread's current trace ID.
        if decision.reason == "bypass":
            outcome = "bypass"
        elif decision.admitted:
            outcome = "admitted"
        else:
            outcome = _SHED_LABELS.get(decision.reason, "shed_other")
        self._m_decisions.inc(outcome=outcome)
        self._m_inflight.set(inflight)
        obs_trace.emit(
            "admission", outcome=outcome, rows=rows,
            priority=priority.name.lower(),
            retry_after_s=decision.retry_after_s, inflight=inflight,
        )
        return decision

    def _admit_locked(
        self, rows: int, deadline_ms: Optional[float], priority: Priority,
        now: float,
    ) -> Decision:
        """The admission decision proper; caller holds ``self._lock``."""
        if priority >= Priority.REFRESH:
            self._inflight += 1
            self.stats.bypassed += 1
            self.stats.admitted += 1
            return Decision(True, "bypass")

        # Cheap checks first; the token is only spent on requests that
        # every other gate would admit (an inflight- or deadline-shed
        # request must not burn rate budget).
        if self._inflight >= self.max_inflight:
            self.stats.shed_inflight += 1
            # Everything queued ahead must drain first.
            retry = max(0.001, self._inflight * self._service_ewma_s)
            return Decision(False, "inflight", retry_after_s=retry)

        dl = deadline_ms if deadline_ms is not None else self.default_deadline_ms
        if dl is not None:
            est_wait_s = self._inflight * self._service_ewma_s
            if est_wait_s * 1e3 > dl:
                self.stats.shed_deadline += 1
                return Decision(False, "deadline",
                                retry_after_s=max(0.001, est_wait_s))

        bucket = self._bucket_for(rows)
        limiter = self._limiters.get(bucket)
        if limiter is not None:
            ok, retry = limiter.try_acquire(1.0, now=now)
            self._m_tokens.set(limiter._tokens, bucket=str(bucket))
            if not ok:
                self.stats.shed_rate += 1
                return Decision(False, "rate", retry_after_s=retry)

        self._inflight += 1
        self.stats.admitted += 1
        return Decision(True, "ok")

    def release(self, service_s: Optional[float] = None) -> None:
        """Return an admitted request's inflight slot; ``service_s`` feeds the EWMA."""
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            if service_s is not None:
                if self._service_ewma_s == 0.0:
                    self._service_ewma_s = float(service_s)
                else:
                    self._service_ewma_s += self._alpha * (
                        float(service_s) - self._service_ewma_s
                    )
            inflight, ewma = self._inflight, self._service_ewma_s
        self._m_inflight.set(inflight)
        self._m_ewma.set(ewma)

    class _Tracker:
        def __init__(self, ctrl: "AdmissionController"):
            self._ctrl = ctrl
            self._t0 = time.monotonic()

        def __enter__(self):
            return self

        def __exit__(self, exc_type, *exc):
            # Failed-fast requests (aged-out deadline, bad model, engine
            # error) must not drag the service-time EWMA toward zero —
            # that would disable deadline shedding exactly under overload.
            # Only successful compute contributes a service sample.
            service = None if exc_type is not None else (
                time.monotonic() - self._t0
            )
            self._ctrl.release(service)
            return False

    def track(self) -> "AdmissionController._Tracker":
        """Pair an already-admitted request with its release + timing."""
        return AdmissionController._Tracker(self)

    def as_dict(self) -> dict:
        """Stats + live gauges for the ``GET /stats`` admission section.

        ``service_ewma_ms`` and ``bucket_tokens`` (current fill per rate-
        limited bucket) make shed decisions explainable post-hoc: a shed
        with near-zero tokens was rate, one with a large EWMA x inflight
        product was deadline.
        """
        with self._lock:
            now = time.monotonic()
            tokens = {
                str(b): lim.available(now) for b, lim in self._limiters.items()
            }
            d = self.stats.as_dict()
            d.update({
                "inflight": self._inflight,
                "max_inflight": self.max_inflight,
                "service_ewma_ms": self._service_ewma_s * 1e3,
                "rate_limited_buckets": sorted(self._limiters),
                "bucket_tokens": tokens,
            })
        for b, v in tokens.items():
            self._m_tokens.set(v, bucket=b)
        return d
