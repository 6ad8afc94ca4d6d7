"""SLOs, multi-window error-budget burn rates, and the alert state machine;
the port's own copy of ``repro.obs.slo`` (stdlib and the port's
``obs.metrics`` / ``obs.trace``; the same rules, states and gauges).

The decision half of the fleet observability plane (the sensing half is
:mod:`repro_torch.obs.scrape`). Definitions follow the SRE burn-rate playbook:

  * an :class:`SLO` turns scraped counters into a cumulative ``(good, bad)``
    event pair. :class:`AvailabilitySLO` counts HTTP responses by status
    class **plus scrape probe outcomes** — a dead replica must burn budget
    even when no client traffic is flowing, so each failed scrape is a bad
    synthetic probe. :class:`LatencySLO` splits a cumulative histogram at a
    threshold via the shared bucket interpolator in :mod:`repro_torch.obs.metrics`.
  * burn rate over a window = (bad / total in that window) / (1 - objective):
    burn 1.0 spends exactly the whole budget over the SLO period; 14.4
    exhausts a 30-day budget in ~2 days (the classic page threshold).
  * a rule fires only when **both** a fast and a slow window exceed its
    threshold — the fast window gives reaction speed, the slow window keeps
    a brief blip from paging.
  * the per-SLO state machine (OK -> WARN -> PAGE) escalates immediately
    but de-escalates with hysteresis (burn must drop below
    ``threshold * hysteresis`` in either window) so a burn hovering at the
    threshold doesn't flap. Every transition emits a ``slo_alert`` JSONL
    event through :class:`repro_torch.obs.trace.EventLog` and the
    current state is exported as ``gp_slo_*`` gauges.

Wire format and worked examples: ``docs/fleet.md`` (the reference's).
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.obs.metrics import (
    MetricsRegistry,
    bucket_fraction_le,
    quantile_from_buckets,
)
from repro_torch.obs.trace import EventLog

# State machine levels, ordered by severity.
OK, WARN, PAGE = "OK", "WARN", "PAGE"
_LEVEL = {OK: 0, WARN: 1, PAGE: 2}
_NAME = {v: k for k, v in _LEVEL.items()}

# Classic 30-day-budget thresholds: PAGE at 14.4x (budget gone in ~2 days),
# WARN at 3x (~10 days).
DEFAULT_PAGE_BURN = 14.4
DEFAULT_WARN_BURN = 3.0
DEFAULT_HYSTERESIS = 0.8


@dataclass
class BurnRateRule:
    """One multi-window burn-rate rule: fire when BOTH windows exceed
    ``threshold``; de-escalate when EITHER drops below
    ``threshold * hysteresis``."""

    level: str  # WARN or PAGE
    threshold: float
    fast_window_s: float
    slow_window_s: float
    hysteresis: float = DEFAULT_HYSTERESIS


def default_rules(fast_window_s: float = 300.0,
                  slow_window_s: float = 3600.0) -> List[BurnRateRule]:
    """The standard WARN@3x / PAGE@14.4x rule pair over the given windows."""
    return [
        BurnRateRule(PAGE, DEFAULT_PAGE_BURN, fast_window_s, slow_window_s),
        BurnRateRule(WARN, DEFAULT_WARN_BURN, fast_window_s, slow_window_s),
    ]


class SLO:
    """Base: a named objective mapping fleet state to cumulative counts.

    Subclasses implement :meth:`totals` returning monotone cumulative
    ``(good, bad)`` event counts read from the fleet source (anything with
    the :class:`repro_torch.obs.scrape.FleetScraper` accessor surface).
    """

    def __init__(self, name: str, objective: float,
                 rules: Optional[List[BurnRateRule]] = None):
        if not 0.0 < objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        self.name = name
        self.objective = float(objective)
        self.rules = rules if rules is not None else default_rules()

    def totals(self, fleet) -> Tuple[float, float]:
        """Cumulative (good, bad) counts — subclass responsibility."""
        raise NotImplementedError


class AvailabilitySLO(SLO):
    """Availability from ``gp_http_requests_total`` status classes + scrape
    probes.

    Bad events: responses whose status starts with ``5`` plus every failed
    scrape. Good: everything else plus successful scrapes. Counting the
    scrapes as blackbox probes is what lets a dead-but-idle replica page.
    """

    def __init__(self, name: str = "availability", objective: float = 0.99,
                 rules: Optional[List[BurnRateRule]] = None,
                 count_scrapes: bool = True):
        super().__init__(name, objective, rules)
        self.count_scrapes = count_scrapes

    def totals(self, fleet) -> Tuple[float, float]:
        """(good, bad) = non-5xx responses + ok scrapes, 5xx + failed
        scrapes."""
        bad = fleet.counter_total(
            "gp_http_requests_total",
            where=lambda lbl: str(lbl.get("status", "")).startswith("5"))
        good = fleet.counter_total(
            "gp_http_requests_total",
            where=lambda lbl: not str(lbl.get("status", "")).startswith("5"))
        if self.count_scrapes:
            ok, err = fleet.scrape_totals()
            good += ok
            bad += err
        return good, bad


class LatencySLO(SLO):
    """Latency from cumulative histogram buckets: good = observations at or
    under ``threshold_s``, interpolated inside the landing bucket."""

    def __init__(self, name: str = "latency", objective: float = 0.95,
                 threshold_s: float = 0.25,
                 family: str = "gp_http_request_seconds",
                 path: Optional[str] = None,
                 rules: Optional[List[BurnRateRule]] = None):
        super().__init__(name, objective, rules)
        self.threshold_s = float(threshold_s)
        self.family = family
        self.path = path

    def _where(self) -> Optional[Callable[[Dict[str, str]], bool]]:
        if self.path is None:
            return None
        return lambda lbl: lbl.get("path") == self.path

    def totals(self, fleet) -> Tuple[float, float]:
        """(good, bad) split of the histogram at ``threshold_s``."""
        bounds, cum = fleet.histogram_cumulative(self.family,
                                                 where=self._where())
        total = cum[-1] if cum else 0.0
        if total <= 0:
            return 0.0, 0.0
        frac = bucket_fraction_le(bounds, cum, self.threshold_s)
        if math.isnan(frac):
            return 0.0, 0.0
        good = frac * total
        return good, total - good

    def quantiles(self, fleet, qs=(0.5, 0.99)) -> Dict[float, float]:
        """Fleet-wide latency quantiles (seconds; NaN when empty)."""
        bounds, cum = fleet.histogram_cumulative(self.family,
                                                 where=self._where())
        return {q: quantile_from_buckets(bounds, cum, q) for q in qs}


@dataclass
class _SLOState:
    """Mutable evaluation state for one SLO."""

    slo: SLO
    state: str = OK
    # (ts, good, bad) cumulative snapshots, trimmed to the slowest window.
    history: Deque[Tuple[float, float, float]] = field(default_factory=deque)
    burns: Dict[str, float] = field(default_factory=dict)  # window -> burn
    last_transition_ts: Optional[float] = None


class SLOEngine:
    """Evaluate SLOs against a fleet source; run the alert state machine.

    Args:
      fleet: the sensing source (a :class:`repro_torch.obs.scrape.FleetScraper`
        or anything with ``counter_total`` / ``histogram_cumulative`` /
        ``scrape_totals``).
      slos: the objectives to track.
      event_log: transition sink; ``None`` disables alert events.
      registry: where ``gp_slo_*`` gauges land (own registry by default so
        the monitor can concatenate it with the scraper's exposition).
      clock: injectable time source (tests).

    Call :meth:`evaluate` once per scrape round. Burn windows clamp to the
    data actually available — a 1-hour window evaluated 30s after startup
    uses the 30s of history it has, rather than reporting zero burn.
    """

    def __init__(self, fleet, slos: List[SLO],
                 event_log: Optional[EventLog] = None,
                 registry: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.fleet = fleet
        self.event_log = event_log
        self.registry = registry if registry is not None else MetricsRegistry()
        self._clock = clock
        self._states = {slo.name: _SLOState(slo=slo) for slo in slos}
        if len(self._states) != len(slos):
            raise ValueError("duplicate SLO names")
        self._g_state = self.registry.gauge(
            "gp_slo_state",
            "Alert level per SLO (0=OK, 1=WARN, 2=PAGE)", ["slo"])
        self._g_burn = self.registry.gauge(
            "gp_slo_burn_rate",
            "Error-budget burn rate per SLO and window", ["slo", "window"])
        self._g_budget = self.registry.gauge(
            "gp_slo_error_budget_remaining",
            "Fraction of total error budget left (cumulative)", ["slo"])
        self._g_quantile = self.registry.gauge(
            "gp_slo_latency_seconds",
            "Fleet-wide latency quantiles for latency SLOs",
            ["slo", "quantile"])

    # -- burn computation -----------------------------------------------------
    @staticmethod
    def _windowed_burn(history: Deque[Tuple[float, float, float]],
                       now: float, window_s: float,
                       objective: float) -> float:
        """Burn over ``[now - window_s, now]`` from cumulative snapshots.

        Uses the oldest snapshot inside the window as the baseline (the
        window clamps to available history). No events in the window means
        zero burn.
        """
        if not history:
            return 0.0
        cutoff = now - window_s
        base = None
        for ts, good, bad in history:
            if ts >= cutoff:
                base = (good, bad)
                break
        if base is None:
            base = (history[-1][1], history[-1][2])
        _, good_now, bad_now = history[-1]
        d_good = good_now - base[0]
        d_bad = bad_now - base[1]
        d_total = d_good + d_bad
        if d_total <= 0:
            return 0.0
        return (d_bad / d_total) / (1.0 - objective)

    def _desired_level(self, st: _SLOState, now: float) -> int:
        """Highest rule level whose fast AND slow burns exceed threshold."""
        desired = _LEVEL[OK]
        for rule in st.slo.rules:
            fast = self._windowed_burn(st.history, now, rule.fast_window_s,
                                       st.slo.objective)
            slow = self._windowed_burn(st.history, now, rule.slow_window_s,
                                       st.slo.objective)
            st.burns[f"fast_{rule.level.lower()}"] = fast
            st.burns[f"slow_{rule.level.lower()}"] = slow
            if fast >= rule.threshold and slow >= rule.threshold:
                desired = max(desired, _LEVEL[rule.level])
        return desired

    def _supports_level(self, st: _SLOState, now: float, level: int) -> bool:
        """Whether hysteresis-scaled thresholds still justify ``level``."""
        for rule in st.slo.rules:
            if _LEVEL[rule.level] != level:
                continue
            thresh = rule.threshold * rule.hysteresis
            fast = self._windowed_burn(st.history, now, rule.fast_window_s,
                                       st.slo.objective)
            slow = self._windowed_burn(st.history, now, rule.slow_window_s,
                                       st.slo.objective)
            if fast >= thresh and slow >= thresh:
                return True
        return False

    # -- evaluation -----------------------------------------------------------
    def evaluate(self) -> Dict[str, dict]:
        """One evaluation round: snapshot, burn, transition, export.

        Returns the per-SLO status dict also served at ``/fleet/slo``.
        """
        now = self._clock()
        out: Dict[str, dict] = {}
        for name, st in self._states.items():
            good, bad = st.slo.totals(self.fleet)
            st.history.append((now, good, bad))
            slowest = max(
                max(r.fast_window_s, r.slow_window_s) for r in st.slo.rules)
            while len(st.history) > 2 and st.history[1][0] < now - slowest:
                st.history.popleft()

            st.burns = {}
            desired = self._desired_level(st, now)
            current = _LEVEL[st.state]
            new = current
            if desired > current:
                new = desired  # escalate immediately (OK -> PAGE jumps ok)
            elif desired < current:
                # De-escalate only past hysteresis, one level at a time.
                while new > desired and not self._supports_level(st, now,
                                                                 new):
                    new -= 1
            if new != current:
                self._transition(st, _NAME[new], now)

            total = good + bad
            budget = 1.0
            if total > 0:
                allowed = (1.0 - st.slo.objective) * total
                budget = 1.0 - (bad / allowed) if allowed > 0 else 0.0
            self._g_state.set(_LEVEL[st.state], slo=name)
            self._g_budget.set(budget, slo=name)
            for window, burn in st.burns.items():
                self._g_burn.set(burn, slo=name, window=window)
            entry = {
                "state": st.state,
                "objective": st.slo.objective,
                "good": good,
                "bad": bad,
                "error_budget_remaining": budget,
                "burn_rates": dict(st.burns),
                "last_transition_ts": st.last_transition_ts,
            }
            if isinstance(st.slo, LatencySLO):
                qs = st.slo.quantiles(self.fleet)
                for q, v in qs.items():
                    self._g_quantile.set(
                        v if not math.isnan(v) else 0.0,
                        slo=name, quantile=str(q))
                entry["latency_quantiles_s"] = {
                    str(q): (None if math.isnan(v) else v)
                    for q, v in qs.items()
                }
                entry["threshold_s"] = st.slo.threshold_s
            out[name] = entry
        return out

    def _transition(self, st: _SLOState, new_state: str, now: float) -> None:
        """Apply a state change and emit the ``slo_alert`` event."""
        old = st.state
        st.state = new_state
        st.last_transition_ts = time.time()
        if self.event_log is not None:
            self.event_log.emit(
                "slo_alert",
                slo=st.slo.name,
                from_state=old,
                to_state=new_state,
                objective=st.slo.objective,
                burn_rates={k: round(v, 4) for k, v in st.burns.items()},
            )

    def status(self) -> Dict[str, dict]:
        """Last-evaluated per-SLO status without advancing the machine."""
        out = {}
        for name, st in self._states.items():
            out[name] = {
                "state": st.state,
                "objective": st.slo.objective,
                "burn_rates": dict(st.burns),
                "last_transition_ts": st.last_transition_ts,
            }
        return out

    def worst_state(self) -> str:
        """Highest alert level across all SLOs (OK for an empty set)."""
        level = 0
        for st in self._states.values():
            level = max(level, _LEVEL[st.state])
        return _NAME[level]
