"""Replica workers + supervisor: N processes serving one artifact store;
port of ``repro.serve.cluster.replica``.

A *worker* is a fresh process (``multiprocessing`` spawn context: a parent
that has run on the card holds a CUDA context, which a forked child could
not use) that:

  0. resolves its ``device`` (default ``"cuda"``) and dies if the device is
     absent: there is no fallback to the CPU,
  1. polls the artifact store until a first version is published,
  2. builds a `MultiModelServer` (+ admission controller), fetches the
     model onto its device and runs every bucket once (the first launch
     loads the kernel library; a failed load or launch ends the worker
     with a non-zero exit code),
  3. binds the HTTP front-end (port 0 => ephemeral) and writes the chosen
     port to a ``replica_<i>.port`` file (write-temp + rename, so the
     supervisor never reads a half-written port),
  4. keeps polling ``LATEST`` and atomically swaps new versions in while
     serving (in-flight requests finish on the model snapshot they
     started with).

The *supervisor* spawns the workers, waits for them to report healthy,
restarts any that die, and on ``stop()`` drains them (POST /admin/drain,
then wait for in-flight to hit zero) before terminating — a swap or a
shutdown never drops an admitted request.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import signal
import threading
import time
import urllib.error
import urllib.request
from typing import Optional

DEFAULT_BUCKETS = (16, 64, 256)


def _http_json(
    url: str,
    payload: Optional[dict] = None,
    timeout: float = 10.0,
) -> tuple[int, dict]:
    """Tiny stdlib HTTP client; returns (status, parsed body)."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json"} if data else {},
        method="POST" if data is not None else "GET",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read() or b"{}")
        except json.JSONDecodeError:
            body = {}
        return e.code, body


def run_worker(cfg: dict) -> None:
    """Worker process entry point; ``cfg`` is a plain dict of primitives
    (spawn-pickle friendly). Blocks until SIGTERM/SIGINT, then drains.

    ``cfg["device"]`` (default ``"cuda"``) is resolved first: a worker asked
    for a card on a machine without one raises, so its process exits
    non-zero and :meth:`ReplicaSupervisor.start` reports the exit code.
    """
    # Imports happen here, inside the spawned process.
    from repro_torch.device import resolve_device
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serve.cluster.admission import AdmissionController
    from repro_torch.serve.cluster.store import ArtifactPoller, latest_version
    from repro_torch.serve.cluster.transport import (
        ServeFrontend,
        start_http_server,
    )
    from repro_torch.serve.multimodel import MultiModelServer

    device = resolve_device(cfg.get("device", "cuda"))

    # Structured request log: one JSONL file per replica process, so the
    # per-request / admission / engine events of concurrent replicas never
    # interleave mid-line. Configured before the front-end exists so even
    # warmup-era events land in the file.
    request_log = cfg.get("request_log")
    if request_log:
        obs_trace.configure(path=request_log)

    buckets = tuple(cfg.get("buckets", DEFAULT_BUCKETS))
    server = MultiModelServer(buckets=buckets)
    admission = AdmissionController(
        buckets=buckets,
        rate_qps=cfg.get("rate_qps"),
        burst=cfg.get("burst"),
        max_inflight=cfg.get("max_inflight", 64),
        default_deadline_ms=cfg.get("default_deadline_ms"),
    )
    frontend = ServeFrontend(
        server, admission, store_dir=cfg["store_dir"],
        default_model=cfg.get("default_model", "default"), device=device,
    )
    poller = ArtifactPoller(
        cfg["store_dir"], server,
        interval_s=cfg.get("poll_interval_s", 0.5),
        on_swap=lambda version, manifest: setattr(frontend, "version", version),
        device=device,
    )

    # Wait for the first published version (the supervisor may start us
    # before the publisher finishes).
    deadline = time.monotonic() + cfg.get("wait_for_artifact_s", 120.0)
    while latest_version(cfg["store_dir"]) is None:
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"no artifact published under {cfg['store_dir']}"
            )
        time.sleep(0.2)
    if not poller.poll_once():
        raise RuntimeError(
            f"initial artifact fetch failed: {poller.status()['last_error']}"
        )

    httpd, _ = start_http_server(
        frontend, host=cfg.get("host", "127.0.0.1"), port=cfg.get("port", 0)
    )
    port_file = cfg.get("port_file")
    if port_file:
        tmp = port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{httpd.port}\n")
        os.rename(tmp, port_file)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    poller.start()
    stop.wait()

    # Drain: refuse new work, let in-flight requests finish, then exit.
    frontend.draining = True
    drain_deadline = time.monotonic() + cfg.get("drain_timeout_s", 10.0)
    while admission.inflight > 0 and time.monotonic() < drain_deadline:
        time.sleep(0.05)
    poller.stop()
    httpd.shutdown()


class ReplicaSupervisor:
    """Spawn, monitor and drain N HTTP replica workers over one store."""

    def __init__(
        self,
        store_dir: str,
        num_replicas: int = 2,
        host: str = "127.0.0.1",
        base_port: int = 0,
        run_dir: Optional[str] = None,
        request_log_dir: Optional[str] = None,
        **worker_kwargs,
    ):
        if num_replicas < 1:
            raise ValueError("need at least one replica")
        self.store_dir = store_dir
        self.num_replicas = int(num_replicas)
        self.host = host
        self.base_port = int(base_port)  # 0 => ephemeral; else port+i per replica
        self.run_dir = run_dir if run_dir is not None else os.path.join(
            store_dir, ".run"
        )
        self.request_log_dir = request_log_dir
        self.worker_kwargs = worker_kwargs
        self._ctx = multiprocessing.get_context("spawn")
        self._procs: list = [None] * self.num_replicas
        self.ports: list = [None] * self.num_replicas
        # Seconds from spawn to the first healthy /healthz, per replica
        # (set by start(); the start-up cost a respawn pays).
        self.startup_s: list = [None] * self.num_replicas
        self._spawned_at: list = [None] * self.num_replicas
        self.restarts = 0

    # -- lifecycle -----------------------------------------------------------
    def _port_file(self, i: int) -> str:
        return os.path.join(self.run_dir, f"replica_{i}.port")

    def _spawn(self, i: int) -> None:
        pf = self._port_file(i)
        if os.path.exists(pf):
            os.remove(pf)
        cfg = {
            "store_dir": self.store_dir,
            "host": self.host,
            "port": (self.base_port + i) if self.base_port else 0,
            "port_file": pf,
            **self.worker_kwargs,
        }
        if self.request_log_dir:
            cfg["request_log"] = os.path.join(
                self.request_log_dir, f"replica_{i}.jsonl"
            )
        proc = self._ctx.Process(
            target=run_worker, args=(cfg,), name=f"gp-replica-{i}", daemon=True
        )
        proc.start()
        self._procs[i] = proc
        self._spawned_at[i] = time.monotonic()
        self.ports[i] = None

    def start(self, timeout_s: float = 180.0) -> list:
        """Spawn all replicas, wait until each reports healthy over HTTP.

        Returns the list of endpoint URLs. Raises on timeout or if a
        worker dies during startup (its exitcode is in the message).
        """
        os.makedirs(self.run_dir, exist_ok=True)
        for i in range(self.num_replicas):
            self._spawn(i)
        deadline = time.monotonic() + timeout_s
        pending = set(range(self.num_replicas))
        while pending:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"replicas {sorted(pending)} not healthy after "
                    f"{timeout_s:.0f}s"
                )
            for i in sorted(pending):
                proc = self._procs[i]
                if not proc.is_alive():
                    raise RuntimeError(
                        f"replica {i} died during startup "
                        f"(exitcode={proc.exitcode})"
                    )
                if self.ports[i] is None:
                    try:
                        with open(self._port_file(i)) as f:
                            self.ports[i] = int(f.read().strip())
                    except (FileNotFoundError, ValueError):
                        continue
                try:
                    status, _ = _http_json(
                        self.endpoint(i) + "/healthz", timeout=2.0
                    )
                except OSError:
                    continue
                if status == 200:
                    pending.discard(i)
                    self.startup_s[i] = time.monotonic() - self._spawned_at[i]
            if pending:
                time.sleep(0.2)
        return self.endpoints()

    def endpoint(self, i: int) -> str:
        """Base URL of replica ``i`` (RuntimeError before it reports a port)."""
        if self.ports[i] is None:
            raise RuntimeError(f"replica {i} has not reported a port yet")
        return f"http://{self.host}:{self.ports[i]}"

    def endpoints(self) -> list:
        """Base URLs of all replicas, in index order."""
        return [self.endpoint(i) for i in range(self.num_replicas)]

    def targets(self) -> dict:
        """Scrape-target map ``{replica_name: base_url}`` for the monitor.

        Every replica with a known port is listed — including dead ones,
        deliberately: a crashed replica stays a fleet member until the
        supervisor decides otherwise, and keeping its target is what lets
        the scraper observe the miss and flip ``gp_fleet_replica_up`` to 0
        instead of silently shrinking the fleet.
        """
        out = {}
        for i in range(self.num_replicas):
            if self.ports[i] is None:
                # A respawned worker reports its port via the port file;
                # pick it up opportunistically so the target set heals.
                try:
                    with open(self._port_file(i)) as f:
                        self.ports[i] = int(f.read().strip())
                except (FileNotFoundError, ValueError):
                    continue
            out[f"replica_{i}"] = f"http://{self.host}:{self.ports[i]}"
        return out

    def kill(self, i: int) -> None:
        """Hard-kill replica ``i`` without draining or respawning (chaos
        hook for staleness/alerting tests — :meth:`check` still respawns
        it if called afterwards)."""
        proc = self._procs[i]
        if proc is not None and proc.is_alive():
            proc.kill()
            proc.join(timeout=10.0)

    def check(self) -> int:
        """Respawn any dead replica; returns how many were restarted."""
        restarted = 0
        for i, proc in enumerate(self._procs):
            if proc is not None and not proc.is_alive():
                self._spawn(i)
                restarted += 1
        self.restarts += restarted
        return restarted

    def stop(self, drain: bool = True, timeout_s: float = 15.0) -> None:
        """Drain (refuse new work, finish in-flight) then stop every worker."""
        if drain:
            for i in range(self.num_replicas):
                if self.ports[i] is None or not self._procs[i].is_alive():
                    continue
                try:
                    _http_json(self.endpoint(i) + "/admin/drain",
                               payload={}, timeout=2.0)
                except OSError:
                    pass
        for proc in self._procs:
            if proc is not None and proc.is_alive():
                proc.terminate()
        deadline = time.monotonic() + timeout_s
        for proc in self._procs:
            if proc is None:
                continue
            proc.join(timeout=max(0.1, deadline - time.monotonic()))
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
