"""Fleet monitor: one process watching N replicas (stdlib HTTP); the port's
own copy of ``repro.serve.cluster.monitor``.

Composes the two halves of the fleet observability plane — the
:class:`repro_torch.obs.scrape.FleetScraper` (sensing) and the
:class:`repro_torch.obs.slo.SLOEngine` (deciding) — behind three read-only HTTP
endpoints:

  * ``GET /fleet/metrics`` — the aggregated Prometheus exposition: every
    scraped family re-labelled per replica, the scraper's ``gp_fleet_*``
    meta families, and the SLO engine's ``gp_slo_*`` gauges, in one body;
  * ``GET /fleet/slo``     — JSON burn/alert state per SLO (the same dict
    the evaluator produced on the last tick);
  * ``GET /fleet/health``  — per-replica up/EWMA/shed-rate/queue-depth —
    the sensing contract a load balancer or autoscaler consumes (see
    the reference's ``docs/fleet.md`` for the field-by-field schema);
  * ``GET /healthz``       — the monitor's own liveness.

The monitor ticks on an interval: refresh targets (from a live
:class:`repro_torch.serve.cluster.replica.ReplicaSupervisor` when embedded, or a
static target map when standalone), scrape every replica, evaluate the
SLOs. Alert transitions stream as ``slo_alert`` JSONL events through the
observability event log. Embed it via :mod:`repro_torch.launch.serve`'s
``--monitor HOST:PORT`` flag or run it standalone::

    python -m repro_torch.serve.cluster.monitor --targets \\
        replica_0=http://127.0.0.1:8101,replica_1=http://127.0.0.1:8102
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import CONTENT_TYPE
from repro_torch.obs.scrape import FleetScraper
from repro_torch.obs.slo import SLO, AvailabilitySLO, LatencySLO, SLOEngine


def default_slos(fast_window_s: float = 300.0,
                 slow_window_s: float = 3600.0) -> List[SLO]:
    """The stock SLO set: 99% availability + 95% of predicts under 250ms."""
    from repro_torch.obs.slo import default_rules

    rules = default_rules(fast_window_s, slow_window_s)
    return [
        AvailabilitySLO(objective=0.99, rules=list(rules)),
        LatencySLO(objective=0.95, threshold_s=0.25, rules=list(rules)),
    ]


class FleetMonitor:
    """Scrape + evaluate + serve: the whole monitor in one object.

    Args:
      targets: initial ``{replica_name: base_url}`` scrape map.
      supervisor: optional live :class:`ReplicaSupervisor`; when given, each
        tick refreshes the target set from ``supervisor.targets()`` so
        spawns/exits change what is scraped without restarts.
      interval_s: tick period (scrape round + SLO evaluation).
      slos: SLO set (default: :func:`default_slos` over windows derived
        from ``interval_s`` when small, else the stock 5min/1h pair).
      event_log: alert sink; None falls back to the process-wide log.
      scraper_kwargs: forwarded to :class:`FleetScraper` (``ttl_s``,
        ``stale_after_misses``, injectable ``clock``/``fetch`` in tests).
    """

    def __init__(
        self,
        targets: Optional[Dict[str, str]] = None,
        supervisor=None,
        interval_s: float = 1.0,
        slos: Optional[List[SLO]] = None,
        event_log: Optional[obs_trace.EventLog] = None,
        **scraper_kwargs,
    ):
        self.interval_s = float(interval_s)
        self.supervisor = supervisor
        self.scraper = FleetScraper(
            targets=targets, interval_s=interval_s, **scraper_kwargs)
        if slos is None:
            slos = default_slos()
        log = event_log if event_log is not None \
            else obs_trace.get_event_log()
        self.slo_engine = SLOEngine(
            self.scraper, slos, event_log=log,
            clock=scraper_kwargs.get("clock", time.monotonic))
        self._slo_status: Dict[str, dict] = {}  #: guarded by self._status_lock
        self._status_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.ticks = 0  #: guarded by self._status_lock

    # -- the tick -------------------------------------------------------------
    def tick(self) -> Dict[str, dict]:
        """One monitor cycle: refresh targets, scrape, evaluate SLOs.

        Synchronous and injectable-clock friendly — tests drive it
        directly; production runs it on the :meth:`start` thread.
        """
        if self.supervisor is not None:
            self.scraper.set_targets(self.supervisor.targets())
        self.scraper.scrape_once()
        status = self.slo_engine.evaluate()
        with self._status_lock:
            self._slo_status = status
            self.ticks += 1
        return status

    def start(self) -> None:
        """Tick every ``interval_s`` on a daemon thread (idempotent)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception:  # a failed tick must not kill the loop
                    pass

        self._thread = threading.Thread(
            target=_loop, name="fleet-monitor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the tick thread."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=self.interval_s + 30.0)
        self._thread = None

    def tick_count(self) -> int:
        """Completed monitor cycles (thread-safe read for handlers)."""
        with self._status_lock:
            return self.ticks

    # -- endpoint payloads ----------------------------------------------------
    def fleet_metrics(self) -> str:
        """``/fleet/metrics`` body: scraper aggregate + ``gp_slo_*`` gauges."""
        return self.scraper.render() + self.slo_engine.registry.render()

    def fleet_slo(self) -> dict:
        """``/fleet/slo`` body: last tick's per-SLO burn/alert state."""
        with self._status_lock:
            status = dict(self._slo_status)
            ticks = self.ticks
        return {
            "ts": time.time(),
            "ticks": ticks,
            "worst_state": self.slo_engine.worst_state(),
            "slos": status,
        }

    def fleet_health(self) -> dict:
        """``/fleet/health`` body: the autoscaler's sensing contract."""
        health = self.scraper.health()
        up = sum(1 for h in health.values() if h["up"])
        return {
            "ts": time.time(),
            "replicas": health,
            "num_replicas": len(health),
            "num_up": up,
            "up_fraction": self.scraper.up_fraction(),
            "worst_slo_state": self.slo_engine.worst_state(),
        }


class _MonitorHandler(BaseHTTPRequestHandler):
    """Read-only JSON/text routes over one :class:`FleetMonitor`."""

    protocol_version = "HTTP/1.1"
    monitor: FleetMonitor = None  # set by the server class

    def log_message(self, fmt, *args):  # pragma: no cover - logging
        pass

    def _send(self, status: int, data: bytes, ctype: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        try:
            if self.path == "/fleet/metrics":
                body = self.monitor.fleet_metrics().encode("utf-8")
                self._send(200, body, CONTENT_TYPE)
                return
            if self.path == "/fleet/slo":
                payload = self.monitor.fleet_slo()
            elif self.path == "/fleet/health":
                payload = self.monitor.fleet_health()
            elif self.path == "/healthz":
                payload = {"ok": True, "ticks": self.monitor.tick_count()}
            else:
                self._send(404, json.dumps(
                    {"error": f"no route {self.path}"}).encode(),
                    "application/json")
                return
            self._send(200, json.dumps(payload).encode(),
                       "application/json")
        except Exception as e:  # pragma: no cover - defensive
            self._send(500, json.dumps(
                {"error": f"{type(e).__name__}: {e}"}).encode(),
                "application/json")


class MonitorHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer bound to one :class:`FleetMonitor`."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, monitor: FleetMonitor, host: str = "127.0.0.1",
                 port: int = 0):
        handler = type("BoundMonitorHandler", (_MonitorHandler,),
                       {"monitor": monitor})
        super().__init__((host, port), handler)
        self.monitor = monitor

    @property
    def port(self) -> int:
        """The bound TCP port (resolved even when constructed with port 0)."""
        return self.server_address[1]


def start_monitor_server(
    monitor: FleetMonitor, host: str = "127.0.0.1", port: int = 0,
) -> tuple:
    """Serve the monitor on a daemon thread; returns (server, thread).

    Also starts the monitor's tick loop. Callers own shutdown:
    ``server.shutdown(); monitor.stop()``.
    """
    server = MonitorHTTPServer(monitor, host=host, port=port)
    thread = threading.Thread(
        target=server.serve_forever, name="gp-fleet-monitor-http",
        daemon=True)
    thread.start()
    monitor.start()
    return server, thread


def parse_targets(spec: str) -> Dict[str, str]:
    """Parse ``name=url,name=url`` (CLI) into a target map."""
    out: Dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"target {part!r} is not name=url")
        name, url = part.split("=", 1)
        out[name.strip()] = url.strip().rstrip("/")
    if not out:
        raise ValueError("no targets parsed")
    return out


def main(argv=None) -> int:
    """Standalone monitor CLI (static target set)."""
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--targets", required=True,
                    help="comma-separated name=url scrape targets")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--interval", type=float, default=1.0,
                    help="scrape/evaluate tick period (s)")
    ap.add_argument("--alert-log", default=None,
                    help="JSONL file for slo_alert events")
    ap.add_argument("--fast-window", type=float, default=300.0)
    ap.add_argument("--slow-window", type=float, default=3600.0)
    args = ap.parse_args(argv)

    log = obs_trace.configure(path=args.alert_log) if args.alert_log else None
    monitor = FleetMonitor(
        targets=parse_targets(args.targets),
        interval_s=args.interval,
        slos=default_slos(args.fast_window, args.slow_window),
        event_log=log,
    )
    server, _ = start_monitor_server(monitor, host=args.host, port=args.port)
    print(f"[monitor] serving /fleet/* on http://{args.host}:{server.port} "
          f"({len(monitor.scraper.targets())} targets, "
          f"interval {args.interval}s)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        monitor.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
