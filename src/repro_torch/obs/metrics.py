"""Thread-safe metrics registry with Prometheus text exposition (stdlib).

The port's own copy of ``repro.obs.metrics`` (the reference module imports
no JAX, but the port imports nothing of the reference); the rendered text is
the reference's, line for line, for the same sequence of instrument calls.

Three instrument kinds, all label-aware:

  * :class:`Counter`   — monotone; ``inc(value, **labels)``;
  * :class:`Gauge`     — point-in-time; ``set`` / ``inc`` / ``set_ewma``
    (the EWMA arm is how slow-moving signals like service time are
    exported without a separate smoothing layer);
  * :class:`Histogram` — fixed cumulative buckets + ``_sum`` / ``_count``,
    the Prometheus convention, so latency quantiles are scrape-side.

A :class:`MetricsRegistry` owns instruments by name (idempotent getters, so
every subsystem can say ``registry.counter("gp_x_total", ...)`` without
coordination) and renders the whole family set in Prometheus text
exposition format 0.0.4 — including the label-value escaping rules
(backslash, double-quote, newline) that make adversarial label values safe.

The module-level :func:`default_registry` is what the serving stack uses
when no registry is passed explicitly; :data:`NULL_REGISTRY` is a no-op
drop-in for A/B-ing instrumentation cost.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Prometheus-convention latency buckets (seconds); chosen to straddle the
# engine's sub-ms bucketed predicts and multi-second cold solves.
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

DEFAULT_EWMA_ALPHA = 0.2


def escape_label_value(value: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def escape_help(text: str) -> str:
    """Prometheus HELP-line escaping: backslash and newline only."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(value: float) -> str:
    """Exposition-format float: integers bare, inf/nan per the spec."""
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if math.isnan(value):
        return "NaN"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def quantile_from_buckets(bounds: Sequence[float],
                          cum_counts: Sequence[float],
                          q: float) -> float:
    """Estimate the ``q``-quantile from cumulative histogram buckets.

    ``bounds`` are the finite upper bucket boundaries (ascending);
    ``cum_counts`` are the cumulative counts per boundary plus one final
    entry for the implicit ``+Inf`` bucket (``len(bounds) + 1`` entries).
    Standard Prometheus ``histogram_quantile`` semantics: linear
    interpolation within the landing bucket (from its lower boundary, 0.0
    below the first), and a quantile that lands in the ``+Inf`` bucket
    clamps to the highest finite boundary. Returns NaN for an empty
    histogram or an out-of-range ``q``.
    """
    if not 0.0 <= q <= 1.0:
        return math.nan
    if len(cum_counts) != len(bounds) + 1:
        raise ValueError("cum_counts must have len(bounds) + 1 entries")
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
    # Landed in +Inf: the best defensible point estimate is the largest
    # finite boundary (histogram_quantile does the same).
    return bounds[-1] if bounds else math.nan


def bucket_fraction_le(bounds: Sequence[float],
                       cum_counts: Sequence[float],
                       threshold: float) -> float:
    """Fraction of observations ``<= threshold`` from cumulative buckets.

    Same layout contract as :func:`quantile_from_buckets`. Interpolates
    linearly inside the bucket containing ``threshold``; 1.0 above the
    last finite boundary, NaN for an empty histogram. The latency-SLO
    engine uses this to count "good" (fast-enough) events.
    """
    if len(cum_counts) != len(bounds) + 1:
        raise ValueError("cum_counts must have len(bounds) + 1 entries")
    total = cum_counts[-1]
    if total <= 0:
        return math.nan
    prev_bound, prev_cum = 0.0, 0.0
    for i, bound in enumerate(bounds):
        if threshold <= bound:
            if threshold == bound:
                return cum_counts[i] / total
            width = bound - prev_bound
            if width <= 0:
                return cum_counts[i] / total
            frac = max(0.0, (threshold - prev_bound)) / width
            return (prev_cum + (cum_counts[i] - prev_cum) * frac) / total
        prev_bound, prev_cum = bound, cum_counts[i]
    return 1.0


class _Instrument:
    """Shared label bookkeeping for all instrument kinds."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, labels: dict) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.labelnames)}"
            )
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def _series(self, key: Tuple[str, ...], extra: Tuple[Tuple[str, str], ...] = ()) -> str:
        pairs = [
            f'{ln}="{escape_label_value(v)}"'
            for ln, v in zip(self.labelnames, key)
        ]
        pairs.extend(f'{ln}="{escape_label_value(v)}"' for ln, v in extra)
        return "{" + ",".join(pairs) + "}" if pairs else ""


class Counter(_Instrument):
    """Monotonically increasing counter (per label set)."""

    kind = "counter"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, value: float = 1.0, **labels) -> None:
        """Add ``value`` (must be >= 0) to the labelled series."""
        if value < 0:
            raise ValueError(f"{self.name}: counters only go up, got {value}")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, **labels) -> float:
        """Current value of the labelled series (0 if never incremented)."""
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def render(self) -> list:
        """Exposition lines for every series of this counter."""
        with self._lock:
            return [
                f"{self.name}{self._series(k)} {_fmt(v)}"
                for k, v in sorted(self._values.items())
            ]


class Gauge(_Instrument):
    """Point-in-time value; supports ``set``/``inc`` and an EWMA update."""

    kind = "gauge"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels) -> None:
        """Overwrite the labelled series with ``value``."""
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        """Add ``value`` (may be negative) to the labelled series."""
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def set_ewma(self, value: float, alpha: float = DEFAULT_EWMA_ALPHA,
                 **labels) -> None:
        """Fold ``value`` into an exponentially weighted moving average.

        The first observation seeds the average; later ones move it by
        ``alpha * (value - current)``. This is the standard way slow
        signals (service time, queue wait) are exported as gauges.
        """
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        key = self._key(labels)
        with self._lock:
            cur = self._values.get(key)
            self._values[key] = (
                float(value) if cur is None
                else cur + alpha * (float(value) - cur)
            )

    def value(self, **labels) -> float:
        """Current value of the labelled series (0 if never set)."""
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def render(self) -> list:
        """Exposition lines for every series of this gauge."""
        with self._lock:
            return [
                f"{self.name}{self._series(k)} {_fmt(v)}"
                for k, v in sorted(self._values.items())
            ]


class Histogram(_Instrument):
    """Fixed-bucket cumulative histogram (Prometheus ``_bucket``/``_sum``/``_count``)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help, labelnames)
        if "le" in labelnames:
            raise ValueError("'le' is reserved for histogram buckets")
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("need at least one bucket boundary")
        self.buckets = bs
        # per label set: [count per finite bucket..., +Inf count], sum
        self._counts: Dict[Tuple[str, ...], list] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}

    def observe(self, value: float, **labels) -> None:
        """Record one observation into the labelled series."""
        key = self._key(labels)
        v = float(value)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self.buckets) + 1))
            for i, b in enumerate(self.buckets):
                if v <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[key] = self._sums.get(key, 0.0) + v

    def count(self, **labels) -> int:
        """Total observations of the labelled series."""
        with self._lock:
            return sum(self._counts.get(self._key(labels), ()))

    def render(self) -> list:
        """Exposition lines: cumulative ``_bucket`` series + ``_sum``/``_count``."""
        with self._lock:
            lines = []
            for key in sorted(self._counts):
                counts = self._counts[key]
                cum = 0
                for b, c in zip(self.buckets, counts):
                    cum += c
                    series = self._series(key, extra=(("le", _fmt(b)),))
                    lines.append(f"{self.name}_bucket{series} {cum}")
                cum += counts[-1]
                inf = self._series(key, extra=(("le", "+Inf"),))
                lines.append(f"{self.name}_bucket{inf} {cum}")
                lines.append(
                    f"{self.name}_sum{self._series(key)} {_fmt(self._sums[key])}"
                )
                lines.append(f"{self.name}_count{self._series(key)} {cum}")
            return lines


class MetricsRegistry:
    """Named instrument store; getters are idempotent, rendering is atomic.

    ``counter`` / ``gauge`` / ``histogram`` return the existing instrument
    when the name is already registered (raising if the kind or labels
    disagree), so independent subsystems can declare the same metric
    without coordinating a single init site.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Instrument] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind} with labels {existing.labelnames}"
                    )
                return existing
            inst = cls(name, help, labelnames, **kw)
            self._metrics[name] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        """Get-or-create a :class:`Counter`."""
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        """Get-or-create a :class:`Gauge`."""
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        """Get-or-create a :class:`Histogram` with ``buckets`` boundaries."""
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def get(self, name: str) -> Optional[_Instrument]:
        """The registered instrument, or None."""
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> list:
        """Registered metric names, sorted."""
        with self._lock:
            return sorted(self._metrics)

    def render(self) -> str:
        """The whole registry in Prometheus text exposition format 0.0.4."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        out = []
        for m in metrics:
            if m.help:
                out.append(f"# HELP {m.name} {escape_help(m.help)}")
            out.append(f"# TYPE {m.name} {m.kind}")
            out.extend(m.render())
        return "\n".join(out) + "\n" if out else ""


class _NullInstrument:
    """Accepts every instrument method as a no-op (overhead A/B baseline)."""

    def __getattr__(self, _name):
        return lambda *a, **kw: None


class NullRegistry(MetricsRegistry):
    """A registry whose instruments drop everything — the off switch.

    Pass this where a ``MetricsRegistry`` is expected to measure the cost
    of instrumentation itself or to silence
    a subsystem without touching its call sites.
    """

    def __init__(self):
        super().__init__()
        self._null = _NullInstrument()

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        return self._null

    def render(self) -> str:
        """Always empty."""
        return ""


NULL_REGISTRY = NullRegistry()

_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry serving components fall back to."""
    return _DEFAULT


def render_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    """Render ``registry`` (default: the process-wide one) as exposition text."""
    return (registry if registry is not None else _DEFAULT).render()


# Content type the /metrics endpoint must reply with (version matters to
# Prometheus scrapers).
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
