"""Prometheus text-format parsing + the fleet scraper (stdlib only); the
port's own copy of ``repro.obs.scrape``.

The exact inverse of :mod:`repro_torch.obs.metrics`'s renderer: :func:`parse_prometheus`
turns exposition text back into typed families with un-escaped label values,
so ``parse(render(registry))`` recovers every family, sample and label bit
for bit (property-tested in ``tests/test_fleet.py`` for the reference and in
``tests/test_torch_fleet.py`` against it).

On top of the parser sits :class:`FleetScraper` — the sensing half of the
fleet observability plane. It polls N replica ``/metrics`` + ``/stats``
endpoints on an interval (one thread, or caller-driven via
:meth:`FleetScraper.scrape_once` for deterministic tests), re-exports every
scraped family into one aggregate exposition with a ``replica`` label
appended to each sample, and tracks per-replica liveness:

  * a scrape failure increments the replica's consecutive-miss count; at
    ``stale_after_misses`` misses ``gp_fleet_replica_up`` flips to 0 (the
    autoscaler's primary down signal);
  * once ``ttl_s`` seconds pass without a successful scrape, the replica's
    re-exported series are **dropped** from the aggregate (stale samples
    must not freeze dashboards at their last value);
  * removing a target (scale-down) drops everything, including its ``up``
    series — a drained replica is not a dead replica.

Scrape outcomes themselves are first-class availability events: the SLO
engine (:mod:`repro_torch.obs.slo`) counts failed scrapes against the
availability error budget, which is how a dead replica pages even when no
client traffic is hitting it.
"""
from __future__ import annotations

import json
import math
import threading
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.obs.metrics import _fmt, escape_help, escape_label_value

# Suffixes whose samples roll up into a declared histogram family.
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")

DEFAULT_TIMEOUT_S = 5.0
DEFAULT_STALE_AFTER_MISSES = 2
DEFAULT_TTL_S = 30.0


def unescape_label_value(value: str) -> str:
    """Inverse of :func:`repro_torch.obs.metrics.escape_label_value`.

    A single left-to-right scan, so ``\\\\n`` decodes to backslash + ``n``
    (not newline) exactly as the escaper produced it.
    """
    out: List[str] = []
    i, n = 0, len(value)
    while i < n:
        c = value[i]
        if c == "\\" and i + 1 < n:
            nxt = value[i + 1]
            if nxt == "\\":
                out.append("\\")
                i += 2
                continue
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt == '"':
                out.append('"')
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def unescape_help(text: str) -> str:
    """Inverse of :func:`repro_torch.obs.metrics.escape_help` (backslash, newline)."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "\\" and i + 1 < n:
            nxt = text[i + 1]
            if nxt == "\\":
                out.append("\\")
                i += 2
                continue
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def parse_value(token: str) -> float:
    """Exposition value token -> float (``+Inf``/``-Inf``/``NaN`` per spec)."""
    if token == "+Inf":
        return math.inf
    if token == "-Inf":
        return -math.inf
    if token == "NaN":
        return math.nan
    return float(token)


@dataclass
class Sample:
    """One exposition sample: full sample name, label dict, value.

    ``name`` keeps histogram suffixes (``_bucket``/``_sum``/``_count``);
    the owning :class:`Family` is the declared base family.
    """

    name: str
    labels: Dict[str, str]
    value: float


@dataclass
class Family:
    """One metric family: TYPE/HELP metadata plus its samples in file order."""

    name: str
    kind: str = "untyped"
    help: str = ""
    samples: List[Sample] = field(default_factory=list)


def _parse_labels(text: str, line: str) -> Tuple[Dict[str, str], int]:
    """Parse ``{k="v",...}`` starting at ``text[0] == '{'``.

    Returns (labels, index just past the closing brace). Escapes inside
    quoted values are decoded; a quote or comma inside a value never splits
    a pair. Raises ValueError (with the offending line) on malformed input.
    """
    labels: Dict[str, str] = {}
    i = 1
    n = len(text)
    while True:
        while i < n and text[i] in " \t":
            i += 1
        if i < n and text[i] == "}":
            return labels, i + 1
        j = i
        while j < n and text[j] not in '="{},':
            j += 1
        name = text[i:j].strip()
        if not name or j >= n or text[j] != "=":
            raise ValueError(f"malformed label pair in line {line!r}")
        i = j + 1
        if i >= n or text[i] != '"':
            raise ValueError(f"unquoted label value in line {line!r}")
        i += 1
        buf: List[str] = []
        while i < n:
            c = text[i]
            if c == "\\" and i + 1 < n:
                buf.append(c)
                buf.append(text[i + 1])
                i += 2
                continue
            if c == '"':
                break
            buf.append(c)
            i += 1
        if i >= n or text[i] != '"':
            raise ValueError(f"unterminated label value in line {line!r}")
        labels[name] = unescape_label_value("".join(buf))
        i += 1
        while i < n and text[i] in " \t":
            i += 1
        if i < n and text[i] == ",":
            i += 1
            continue
        if i < n and text[i] == "}":
            return labels, i + 1
        raise ValueError(f"malformed label block in line {line!r}")


def _family_for(name: str, families: Dict[str, Family]) -> Family:
    """The family a sample named ``name`` belongs to (creating untyped)."""
    fam = families.get(name)
    if fam is not None and fam.kind != "histogram":
        return fam
    for suffix in _HIST_SUFFIXES:
        if name.endswith(suffix):
            base = families.get(name[: -len(suffix)])
            if base is not None and base.kind == "histogram":
                return base
    if fam is not None:  # histogram family sampled under its bare name
        return fam
    fam = Family(name=name)
    families[name] = fam
    return fam


def parse_prometheus(text: str) -> Dict[str, Family]:
    """Parse exposition text (format 0.0.4) into ``{family_name: Family}``.

    Strict about structure (malformed lines raise ValueError — the only
    producer we scrape is our own renderer) but tolerant about ordering:
    HELP/TYPE may precede or be absent, unknown families default to
    ``untyped``. Histogram ``_bucket``/``_sum``/``_count`` samples attach
    to their declared base family.
    """
    families: Dict[str, Family] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                kind = parts[3] if len(parts) > 3 else "untyped"
                fam = families.setdefault(parts[2], Family(name=parts[2]))
                fam.kind = kind
            elif len(parts) >= 3 and parts[1] == "HELP":
                fam = families.setdefault(parts[2], Family(name=parts[2]))
                fam.help = unescape_help(parts[3] if len(parts) > 3 else "")
            continue  # other comments are skipped per the spec
        # Sample line: name[{labels}] value
        i = 0
        n = len(line)
        while i < n and line[i] not in "{ \t":
            i += 1
        name = line[:i]
        if not name:
            raise ValueError(f"sample line without metric name: {raw!r}")
        labels: Dict[str, str] = {}
        rest = line[i:]
        if rest.startswith("{"):
            labels, consumed = _parse_labels(rest, raw)
            rest = rest[consumed:]
        tokens = rest.split()
        if not tokens:
            raise ValueError(f"sample line without value: {raw!r}")
        value = parse_value(tokens[0])  # optional timestamp token ignored
        _family_for(name, families).samples.append(Sample(name, labels, value))
    return families


def render_families(families: Dict[str, Family],
                    extra_label: Optional[Tuple[str, str]] = None) -> List[str]:
    """Render parsed families back to exposition lines (sorted by family).

    ``extra_label`` appends one ``(name, value)`` pair to every sample —
    the fleet scraper's ``replica`` label. Sample order within a family is
    preserved (the renderer emitted them sorted already).
    """
    out: List[str] = []
    for fname in sorted(families):
        fam = families[fname]
        if fam.help:
            out.append(f"# HELP {fam.name} {escape_help(fam.help)}")
        out.append(f"# TYPE {fam.name} {fam.kind}")
        for s in fam.samples:
            pairs = [(k, v) for k, v in s.labels.items()]
            if extra_label is not None:
                pairs.append(extra_label)
            body = ",".join(
                f'{k}="{escape_label_value(v)}"' for k, v in pairs
            )
            label_str = "{" + body + "}" if body else ""
            out.append(f"{s.name}{label_str} {_fmt(s.value)}")
    return out


def _http_get(url: str, timeout: float) -> bytes:
    """One GET; raises OSError/urllib errors on any failure."""
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        if resp.status != 200:
            raise OSError(f"GET {url} -> {resp.status}")
        return resp.read()


@dataclass
class ReplicaState:
    """Everything the scraper knows about one target replica."""

    url: str
    families: Dict[str, Family] = field(default_factory=dict)
    stats: Optional[dict] = None  # last successful GET /stats JSON
    up: bool = False
    ever_up: bool = False
    consecutive_misses: int = 0
    ok_scrapes: int = 0
    err_scrapes: int = 0
    last_ok: Optional[float] = None  # injectable-clock time of last success
    last_ok_ts: Optional[float] = None  # wall-clock of last success
    last_scrape_ms: float = 0.0
    last_error: Optional[str] = None
    dropped: bool = False  # TTL expired: series removed from the aggregate


class FleetScraper:
    """Poll replica ``/metrics`` + ``/stats``; aggregate into one exposition.

    Args:
      targets: initial ``{replica_name: base_url}`` map.
      interval_s: polling interval of the background thread (callers may
        instead drive :meth:`scrape_once` themselves).
      timeout_s: per-request HTTP timeout.
      stale_after_misses: consecutive failed scrapes before
        ``gp_fleet_replica_up`` flips to 0.
      ttl_s: seconds without a successful scrape before the replica's
        re-exported series are dropped from the aggregate.
      clock: injectable monotonic clock (tests).
      fetch: injectable ``fetch(url, timeout) -> bytes`` (tests).

    Thread safety: one internal lock guards the target map and all scrape
    state; :meth:`render` and :meth:`health` snapshot under it.
    """

    def __init__(
        self,
        targets: Optional[Dict[str, str]] = None,
        interval_s: float = 1.0,
        timeout_s: float = DEFAULT_TIMEOUT_S,
        stale_after_misses: int = DEFAULT_STALE_AFTER_MISSES,
        ttl_s: float = DEFAULT_TTL_S,
        clock: Callable[[], float] = time.monotonic,
        fetch: Callable[[str, float], bytes] = _http_get,
    ):
        if stale_after_misses < 1:
            raise ValueError("stale_after_misses must be >= 1")
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.stale_after_misses = int(stale_after_misses)
        self.ttl_s = float(ttl_s)
        self._clock = clock
        self._fetch = fetch
        self._lock = threading.Lock()
        self._replicas: Dict[str, ReplicaState] = {}  #: guarded by self._lock
        self.scrape_rounds = 0  #: guarded by self._lock
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if targets:
            self.set_targets(targets)

    # -- target management ----------------------------------------------------
    def set_targets(self, targets: Dict[str, str]) -> None:
        """Replace the target set; removed replicas drop all their series."""
        with self._lock:
            for name in list(self._replicas):
                if name not in targets:
                    del self._replicas[name]
            for name, url in targets.items():
                state = self._replicas.get(name)
                if state is None:
                    self._replicas[name] = ReplicaState(url=url)
                elif state.url != url:  # respawned on a new port: fresh state
                    self._replicas[name] = ReplicaState(url=url)

    def targets(self) -> Dict[str, str]:
        """The current ``{replica_name: base_url}`` map."""
        with self._lock:
            return {n: s.url for n, s in self._replicas.items()}

    # -- scraping -------------------------------------------------------------
    def scrape_once(self) -> Dict[str, bool]:
        """One polling round over every target; returns ``{name: ok}``.

        Each target is scraped independently: ``/metrics`` is parsed and
        cached, ``/stats`` JSON is cached for :meth:`health`. Failures feed
        the staleness machinery documented on the class.
        """
        with self._lock:
            snapshot = [(n, s.url) for n, s in self._replicas.items()]
        results: Dict[str, bool] = {}
        for name, url in snapshot:
            t0 = time.perf_counter()
            err: Optional[str] = None
            families: Optional[Dict[str, Family]] = None
            stats: Optional[dict] = None
            try:
                families = parse_prometheus(
                    self._fetch(url + "/metrics", self.timeout_s).decode(
                        "utf-8")
                )
                stats = json.loads(
                    self._fetch(url + "/stats", self.timeout_s) or b"{}"
                )
            except Exception as e:  # any transport/parse failure is a miss
                err = f"{type(e).__name__}: {e}"
            dur_ms = (time.perf_counter() - t0) * 1e3
            now = self._clock()
            with self._lock:
                state = self._replicas.get(name)
                if state is None or state.url != url:
                    continue  # target changed mid-round
                state.last_scrape_ms = dur_ms
                if err is None:
                    state.families = families or {}
                    state.stats = stats
                    state.up = True
                    state.ever_up = True
                    state.dropped = False
                    state.consecutive_misses = 0
                    state.ok_scrapes += 1
                    state.last_ok = now
                    state.last_ok_ts = time.time()
                    state.last_error = None
                else:
                    state.err_scrapes += 1
                    state.consecutive_misses += 1
                    state.last_error = err
                    if state.consecutive_misses >= self.stale_after_misses \
                            or not state.ever_up:
                        state.up = False
                results[name] = err is None
        self._expire_stale()
        with self._lock:
            self.scrape_rounds += 1
        return results

    def _expire_stale(self) -> None:
        """Drop series of replicas past TTL (called after each round).

        Takes ``self._lock`` itself — deliberately *not* named
        ``*_locked``, which in this repo means the caller must already
        hold the lock.
        """
        now = self._clock()
        with self._lock:
            for state in self._replicas.values():
                ref = state.last_ok
                if state.dropped or state.up:
                    continue
                if ref is None or (now - ref) > self.ttl_s:
                    state.families = {}
                    state.stats = None
                    state.dropped = ref is not None
        # A never-scraped replica keeps dropped=False: it has no series to
        # drop, and its up series should still render (as 0) so the fleet
        # sees the missing member.

    # -- background thread ----------------------------------------------------
    def start(self) -> None:
        """Poll every ``interval_s`` on a daemon thread (idempotent)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.interval_s):
                self.scrape_once()

        self._thread = threading.Thread(
            target=_loop, name="fleet-scraper", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        """Stop the polling thread."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=self.timeout_s + self.interval_s + 5.0)
        self._thread = None

    # -- aggregate exposition -------------------------------------------------
    def _meta_lines(self) -> List[str]:
        """The scraper's own ``gp_fleet_*`` families (built from state)."""
        with self._lock:
            rows = sorted(
                (n, s.up, s.ok_scrapes, s.err_scrapes, s.last_scrape_ms,
                 s.last_ok_ts)
                for n, s in self._replicas.items()
            )
        out = [
            "# HELP gp_fleet_replica_up 1 while the replica answers scrapes, "
            "0 once stale",
            "# TYPE gp_fleet_replica_up gauge",
        ]
        for n, up, *_ in rows:
            out.append(
                f'gp_fleet_replica_up{{replica="{escape_label_value(n)}"}} '
                f"{1 if up else 0}")
        out.append("# HELP gp_fleet_scrapes_total Scrape attempts by outcome")
        out.append("# TYPE gp_fleet_scrapes_total counter")
        for n, _, ok, err, *_ in rows:
            esc = escape_label_value(n)
            out.append(
                f'gp_fleet_scrapes_total{{replica="{esc}",outcome="ok"}} {ok}')
            out.append(
                f'gp_fleet_scrapes_total{{replica="{esc}",outcome="error"}} '
                f"{err}")
        out.append(
            "# HELP gp_fleet_scrape_duration_ms Last scrape duration per "
            "replica")
        out.append("# TYPE gp_fleet_scrape_duration_ms gauge")
        for n, _, _, _, ms, _ in rows:
            out.append(
                f'gp_fleet_scrape_duration_ms{{replica='
                f'"{escape_label_value(n)}"}} {_fmt(ms)}')
        out.append(
            "# HELP gp_fleet_last_scrape_ts Wall-clock of the last "
            "successful scrape")
        out.append("# TYPE gp_fleet_last_scrape_ts gauge")
        for n, *_rest in rows:
            ts = _rest[-1]
            out.append(
                f'gp_fleet_last_scrape_ts{{replica='
                f'"{escape_label_value(n)}"}} '
                f"{_fmt(ts if ts is not None else 0.0)}")
        return out

    def render(self) -> str:
        """The aggregate fleet exposition: meta families + every scraped
        family with a ``replica`` label appended to each sample."""
        lines = self._meta_lines()
        with self._lock:
            per_replica = [
                (name, state.families)
                for name, state in sorted(self._replicas.items())
                if state.families
            ]
        # Emit each family once (first replica's metadata wins), samples
        # from every replica that exports it, in replica order.
        seen: Dict[str, Family] = {}
        order: List[str] = []
        for name, families in per_replica:
            for fname, fam in families.items():
                if fname not in seen:
                    seen[fname] = Family(fname, fam.kind, fam.help)
                    order.append(fname)
        for fname in sorted(order):
            fam = seen[fname]
            if fam.help:
                lines.append(f"# HELP {fam.name} {escape_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for rname, families in per_replica:
                sub = families.get(fname)
                if sub is None:
                    continue
                lines.extend(
                    render_families(
                        {fname: Family(fname, sub.kind, "", sub.samples)},
                        extra_label=("replica", rname),
                    )[1:]  # drop the TYPE line; emitted once above
                )
        return "\n".join(lines) + "\n" if lines else ""

    # -- SLO / health accessors -----------------------------------------------
    def counter_total(self, family: str,
                      where: Optional[Callable[[Dict[str, str]], bool]] = None
                      ) -> float:
        """Sum of a counter family's samples across all live series.

        ``where`` filters by label dict (e.g. 5xx statuses only). Dropped
        replicas contribute nothing — their series are gone.
        """
        total = 0.0
        with self._lock:
            for state in self._replicas.values():
                fam = state.families.get(family)
                if fam is None:
                    continue
                for s in fam.samples:
                    if where is None or where(s.labels):
                        total += s.value
        return total

    def histogram_cumulative(
        self, family: str,
        where: Optional[Callable[[Dict[str, str]], bool]] = None,
    ) -> Tuple[Tuple[float, ...], List[float]]:
        """Merged cumulative buckets of a histogram family across the fleet.

        Returns ``(bounds, cum_counts)`` where ``bounds`` are the sorted
        finite ``le`` boundaries and ``cum_counts`` has one extra final
        entry for ``+Inf``. Summing cumulative counts per boundary across
        series is exact because every series shares the bucket layout.
        """
        sums: Dict[float, float] = {}
        inf_sum = 0.0
        with self._lock:
            for state in self._replicas.values():
                fam = state.families.get(family)
                if fam is None:
                    continue
                for s in fam.samples:
                    if not s.name.endswith("_bucket") or "le" not in s.labels:
                        continue
                    if where is not None and not where(s.labels):
                        continue
                    le = parse_value(s.labels["le"])
                    if math.isinf(le):
                        inf_sum += s.value
                    else:
                        sums[le] = sums.get(le, 0.0) + s.value
        bounds = tuple(sorted(sums))
        cum = [sums[b] for b in bounds]
        cum.append(inf_sum)
        return bounds, cum

    def scrape_totals(self) -> Tuple[float, float]:
        """Cumulative (ok, error) scrape counts over the current targets.

        These are the synthetic availability probes: the SLO engine charges
        failed scrapes against the availability budget so a dead replica
        burns even with zero client traffic.
        """
        with self._lock:
            ok = float(sum(s.ok_scrapes for s in self._replicas.values()))
            err = float(sum(s.err_scrapes for s in self._replicas.values()))
        return ok, err

    def health(self) -> Dict[str, dict]:
        """Per-replica sensing snapshot — the ``/fleet/health`` contract.

        For each target: ``up``, staleness bookkeeping, and the load
        signals the balancer/autoscaler consume, lifted verbatim from the
        replica's last ``/stats`` (``service_ewma_ms``, ``inflight``,
        ``shed_rate`` = shed / (admitted + shed), ``queue_depth`` from the
        scraped engine gauge). Signals are ``None`` until first scrape.
        """
        out: Dict[str, dict] = {}
        with self._lock:
            items = list(self._replicas.items())
        for name, s in items:
            entry = {
                "url": s.url,
                "up": s.up,
                "dropped": s.dropped,
                "consecutive_misses": s.consecutive_misses,
                "ok_scrapes": s.ok_scrapes,
                "err_scrapes": s.err_scrapes,
                "last_ok_ts": s.last_ok_ts,
                "last_error": s.last_error,
                "service_ewma_ms": None,
                "inflight": None,
                "shed_rate": None,
                "queue_depth": None,
                "requests": None,
                "draining": None,
                "version": None,
            }
            stats = s.stats
            if stats:
                adm = stats.get("admission", {})
                entry["service_ewma_ms"] = adm.get("service_ewma_ms")
                entry["inflight"] = adm.get("inflight")
                admitted = adm.get("admitted", 0) or 0
                shed = adm.get("shed", 0) or 0
                denom = admitted + shed
                entry["shed_rate"] = (shed / denom) if denom else 0.0
                entry["requests"] = stats.get("engine", {}).get("requests")
                entry["draining"] = stats.get("draining")
                entry["version"] = stats.get("version")
            fam = s.families.get("gp_engine_queue_depth")
            if fam is not None and fam.samples:
                entry["queue_depth"] = fam.samples[0].value
            out[name] = entry
        return out

    def up_fraction(self) -> float:
        """Fraction of targets currently up (1.0 for an empty fleet)."""
        with self._lock:
            if not self._replicas:
                return 1.0
            return sum(1 for s in self._replicas.values() if s.up) / len(
                self._replicas)
