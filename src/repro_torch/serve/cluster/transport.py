"""HTTP front-end for the bucketed serving engine; port of
``repro.serve.cluster.transport`` (stdlib HTTP, the reference's wire format,
status codes, error texts and ``/stats`` schema).

Endpoints (JSON in/out):

  * ``POST /predict``  — body ``{"x": [[...], ...], "model": name?,
    "deadline_ms": int?, "priority": "predict|refresh|admin"?,
    "samples": bool?}``; replies ``{"mean": [...], "var": [...], "rows": m,
    "model": name, "version": v, "elapsed_ms": t}`` (+ ``samples``).
    Sheds with ``429`` + ``Retry-After`` when admission refuses, ``504``
    when the request's deadline expired before compute could start.
  * ``GET /healthz``   — liveness + served artifact version (``503`` while
    draining or before a model is loaded).
  * ``GET /stats``     — ``EngineStats.as_dict`` + admission counters +
    per-status HTTP counters (+ an ``OnlineGP.stats_dict`` ``refresh``
    section when the replica refreshes in place); the one stats wire
    format, stamped with ``ts`` + ``schema_version``.
  * ``GET /metrics``   — the process metrics registry in Prometheus text
    exposition format (request/admission/engine/refresh families; see
    ``docs/observability.md``).
  * ``POST /append``   — stream observations into the replica's
    `OnlineGP` (body ``{"x": [[...], ...], "y": [...]}``); the request's
    trace ID is remembered and carried by the `RefreshReport` of the
    refine that absorbs the rows.
  * ``POST /admin/swap`` — fetch a version from the artifact store (body
    ``{"version": v?}``, default LATEST) and atomically swap it in.
  * ``POST /admin/drain`` — stop admitting, report in-flight count (the
    supervisor polls until 0 before stopping the process).

Tracing: every request runs under a trace ID — the inbound ``X-Trace-Id``
header when it passes :func:`repro_torch.obs.trace.sanitize_trace_id`, a fresh ID
otherwise — bound as the handler thread's trace context (admission events
and engine spans pick it up), echoed back as a response header, and stamped
on the per-request ``request`` event in the structured JSONL log.

Deadlines are budgets from request arrival: admission refuses requests
whose estimated queue wait already exceeds the budget, and a request that
aged past its deadline between admission and compute returns ``504``
instead of burning engine time. In-flight requests hold a reference to the
model snapshot they started with, so an ``/admin/swap`` (or poller swap)
never tears a response — the swap is a pointer flip inside the engine.

Devices: a request is validated on numpy first, then moved once to the
served model's device (``torch.from_numpy(x).to(model.x.device)``), and its
mean, variance and samples come back through one explicit ``.cpu()``.
Nothing on this path moves a model to the CPU. Handler threads launch on
the device's default stream, as the engine's worker and the artifact
poller do, so a model swapped in by another thread is fully written before
a later request reads it.
"""
from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.cluster.admission import (
    AdmissionController,
    Priority,
    parse_priority,
)
from repro_torch.serve.cluster.store import fetch_servable
from repro_torch.serve.engine import STATS_SCHEMA_VERSION, BucketedEngine
from repro_torch.serve.multimodel import MultiModelServer

DEFAULT_MODEL = "default"

# Known routes: HTTP metric label values. Anything else is labelled
# "other" so scanners probing random paths cannot blow up label
# cardinality in the registry.
ROUTES = ("/predict", "/append", "/healthz", "/stats", "/metrics",
          "/admin/swap", "/admin/drain")


class WireError(Exception):
    """Maps straight to an HTTP status + JSON error body."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class ServeFrontend:
    """Transport-independent request handling around an engine/registry.

    ``target`` is a `BucketedEngine` (single anonymous model) or a
    `MultiModelServer` (route by the request's ``model`` field).
    ``store_dir`` enables ``/admin/swap`` and version reporting;
    ``/admin/swap`` fetches onto ``device``.
    """

    def __init__(
        self,
        target,
        admission: Optional[AdmissionController] = None,
        store_dir: Optional[str] = None,
        version: Optional[str] = None,
        default_model: str = DEFAULT_MODEL,
        refresh_source=None,
        registry: Optional[obs_metrics.MetricsRegistry] = None,
        device="cuda",
    ):
        self.target = target
        self.device = device
        # An OnlineGP (anything with a stats_dict()) feeding this replica:
        # its refresh counters — escalations, coupling residuals, capacity
        # growth — become the "refresh" section of GET /stats, so sequential
        # drivers and operators see WHY a refresh escalated, not just that
        # latency moved.
        self.refresh_source = refresh_source
        self.admission = admission if admission is not None else (
            AdmissionController(
                buckets=getattr(target, "buckets", None)
                or getattr(getattr(target, "engine", None), "buckets", ()),
            )
        )
        self.store_dir = store_dir
        self.version = version
        self.default_model = default_model
        self.draining = False
        self._lock = threading.Lock()
        self.by_status: dict = {}
        # HTTP metrics + the registry GET /metrics renders. None => the
        # process default registry (shared with engine/admission/refresh
        # instruments); pass obs_metrics.NULL_REGISTRY to disable.
        self.registry = (obs_metrics.default_registry() if registry is None
                         else registry)
        self._m_http = self.registry.counter(
            "gp_http_requests_total", "HTTP requests by route and status",
            labelnames=("path", "status"))
        self._m_http_seconds = self.registry.histogram(
            "gp_http_request_seconds", "HTTP request latency by route",
            labelnames=("path",))

    # -- helpers -------------------------------------------------------------
    @property
    def _engine(self) -> BucketedEngine:
        if isinstance(self.target, MultiModelServer):
            return self.target.engine
        return self.target

    def _model_names(self) -> list:
        if isinstance(self.target, MultiModelServer):
            return list(self.target.names())
        try:
            self.target.model
            return [self.default_model]
        except RuntimeError:
            return []

    def _submit(self, name: Optional[str], xq: np.ndarray) -> "object":
        if isinstance(self.target, MultiModelServer):
            try:
                model = self.target.get(name or self.default_model)
            except KeyError as e:
                raise WireError(404, str(e)) from None
            self._check_dim(model, xq)
            return self.target.engine.submit(self._on_device(xq, model),
                                             model=model)
        if name is not None and name != self.default_model:
            raise WireError(
                404, f"unknown model {name!r}; this replica serves a single "
                f"anonymous model ({self.default_model!r})"
            )
        try:
            model = self.target.model
        except RuntimeError as e:
            raise WireError(503, str(e)) from None
        self._check_dim(model, xq)
        return self.target.submit(self._on_device(xq, model), model=model)

    @staticmethod
    def _on_device(xq: np.ndarray, model) -> torch.Tensor:
        """The validated query rows on the model's device, in its dtype."""
        return torch.from_numpy(xq).to(device=model.x.device,
                                       dtype=model.x.dtype)

    @staticmethod
    def _check_dim(model, xq) -> None:
        d = model.x.shape[1]
        if xq.shape[1] != d:
            raise WireError(
                400, f"'x' has {xq.shape[1]} features, model expects {d}"
            )

    def record_status(self, status: int) -> None:
        """Count one HTTP response by status code (feeds ``GET /stats``)."""
        with self._lock:
            self.by_status[status] = self.by_status.get(status, 0) + 1

    def observe_request(self, path: str, status: int, dur_s: float) -> None:
        """Fold one finished request into the HTTP metric families."""
        route = path if path in ROUTES else "other"
        self._m_http.inc(path=route, status=str(status))
        self._m_http_seconds.observe(dur_s, path=route)

    # -- endpoint bodies -----------------------------------------------------
    def healthz(self) -> tuple[int, dict]:
        """``GET /healthz`` body: 200 when serving, 503 draining/model-less."""
        models = self._model_names()
        if self.draining:
            return 503, {"status": "draining",
                         "inflight": self.admission.inflight}
        if not models:
            return 503, {"status": "no-model"}
        return 200, {"status": "ok", "version": self.version,
                     "models": models}

    def stats(self) -> tuple[int, dict]:
        """``GET /stats`` body: engine + admission + http (+ ``refresh``).

        ``ts`` (epoch seconds) and ``schema_version`` let pollers detect
        stale snapshots and wire-format drift.
        """
        with self._lock:
            by_status = {str(k): v for k, v in sorted(self.by_status.items())}
        body = {
            "ts": time.time(),
            "schema_version": STATS_SCHEMA_VERSION,
            "engine": self._engine.stats_dict(),
            "admission": self.admission.as_dict(),
            "http": {"by_status": by_status},
            "version": self.version,
            "models": self._model_names(),
            "draining": self.draining,
        }
        if self.refresh_source is not None:
            body["refresh"] = self.refresh_source.stats_dict()
        return 200, body

    def metrics(self) -> tuple[int, str, str]:
        """``GET /metrics``: (status, Prometheus text body, content-type)."""
        return 200, self.registry.render(), obs_metrics.CONTENT_TYPE

    def append(self, payload: dict) -> tuple[int, dict]:
        """``POST /append``: stream observations into the replica's OnlineGP.

        The handler's current trace ID is recorded with the rows, so the
        refine that later absorbs them reports which requests triggered it.
        """
        if self.refresh_source is None or not hasattr(
                self.refresh_source, "append"):
            raise WireError(
                400, "this replica has no online refresh source to append to")
        try:
            x_new = np.asarray(payload["x"], dtype=np.float32)
            y_new = np.asarray(payload["y"], dtype=np.float32)
        except KeyError as e:
            raise WireError(400, f"missing required field {e}") from None
        except (TypeError, ValueError) as e:
            raise WireError(400, f"'x'/'y' not numeric arrays: {e}") from None
        if x_new.ndim == 1:
            x_new = x_new[None, :]
        if x_new.ndim != 2 or y_new.ndim != 1 \
                or x_new.shape[0] != y_new.shape[0] or x_new.shape[0] == 0:
            raise WireError(
                400, f"'x' must be (k, d) and 'y' (k,) with k >= 1, got "
                     f"{tuple(x_new.shape)} / {tuple(y_new.shape)}")
        if not (np.all(np.isfinite(x_new)) and np.all(np.isfinite(y_new))):
            raise WireError(400, "'x'/'y' contain non-finite values")
        device = self.refresh_source.x.device
        try:
            self.refresh_source.append(
                torch.from_numpy(x_new).to(device),
                torch.from_numpy(y_new).to(device),
                trace_id=obs_trace.current_trace_id())
        except ValueError as e:
            raise WireError(400, str(e)) from None
        stats = self.refresh_source.stats_dict()
        return 200, {"appended": int(x_new.shape[0]), "n": stats.get("n"),
                     "pending_appends": stats.get("pending_appends")}

    def predict(self, payload: dict, arrival: Optional[float] = None
                ) -> tuple[int, dict, dict]:
        """Returns (status, body, extra_headers)."""
        arrival = time.monotonic() if arrival is None else arrival
        if self.draining:
            raise WireError(503, "draining")
        try:
            xq = np.asarray(payload["x"], dtype=np.float32)
        except KeyError:
            raise WireError(400, "missing required field 'x'") from None
        except (TypeError, ValueError) as e:
            raise WireError(400, f"field 'x' is not a numeric matrix: {e}") \
                from None
        if xq.ndim == 1:
            xq = xq[None, :]
        if xq.ndim != 2 or xq.shape[0] == 0 or xq.shape[1] == 0:
            raise WireError(400, f"'x' must be a non-empty (rows, d) matrix, "
                                 f"got shape {tuple(xq.shape)}")
        if not np.all(np.isfinite(xq)):
            raise WireError(400, "'x' contains non-finite values")
        deadline_ms = payload.get("deadline_ms")
        if deadline_ms is not None and (not isinstance(deadline_ms, (int, float))
                                        or deadline_ms <= 0):
            raise WireError(400, f"'deadline_ms' must be a positive number, "
                                 f"got {deadline_ms!r}")
        priority = Priority.PREDICT
        if "priority" in payload:
            try:
                priority = parse_priority(str(payload["priority"]))
            except ValueError as e:
                raise WireError(400, str(e)) from None

        # Version label snapshot. The label is advisory during a swap
        # window: the poller swaps the model before it bumps
        # ``self.version``, so a request racing the swap may carry the
        # neighbouring label. The prediction itself is never torn (it is
        # computed from one model snapshot); correlate via /healthz when
        # exactness matters.
        version = self.version
        decision = self.admission.admit(
            rows=xq.shape[0], deadline_ms=deadline_ms, priority=priority
        )
        if not decision.admitted:
            retry = max(1, math.ceil(decision.retry_after_s))
            return 429, {
                "error": "overloaded",
                "reason": decision.reason,
                "retry_after_s": decision.retry_after_s,
            }, {"Retry-After": str(retry)}

        with self.admission.track():
            if deadline_ms is not None:
                aged_ms = (time.monotonic() - arrival) * 1e3
                if aged_ms > deadline_ms:
                    raise WireError(
                        504, f"deadline exceeded before compute "
                             f"({aged_ms:.0f}ms > {deadline_ms}ms)"
                    )
            name = payload.get("model")
            pred = self._submit(name, xq)
            cols = [pred.mean[:, None], pred.var[:, None]]
            if payload.get("samples"):
                cols.append(pred.samples)
            host = torch.cat(cols, dim=1).cpu().numpy()
        body = {
            "mean": host[:, 0].tolist(),
            "var": host[:, 1].tolist(),
            "rows": int(xq.shape[0]),
            "model": name or self.default_model,
            "version": version,
            "elapsed_ms": (time.monotonic() - arrival) * 1e3,
        }
        if payload.get("samples"):
            body["samples"] = host[:, 2:].tolist()
        return 200, body, {}

    def admin_swap(self, payload: dict) -> tuple[int, dict]:
        """``POST /admin/swap``: fetch a store version onto ``device`` and
        hot-swap it in."""
        if self.store_dir is None:
            raise WireError(400, "no artifact store configured on this replica")
        version = payload.get("version")
        try:
            model, version, manifest = fetch_servable(
                self.store_dir, version, device=self.device)
        except FileNotFoundError as e:
            raise WireError(404, str(e)) from None
        except ValueError as e:  # integrity failure
            raise WireError(409, str(e)) from None
        name = manifest.get("name", self.default_model)
        if isinstance(self.target, MultiModelServer):
            self.target.engine.warmup(model)
            if name in self.target.names():
                self.target.swap(name, model)
            else:
                self.target.register(name, model)
        else:
            self.target.warmup(model)
            self.target.swap_model(model)
        self.version = version
        return 200, {"swapped": True, "version": version, "model": name}

    def admin_drain(self) -> tuple[int, dict]:
        """``POST /admin/drain``: refuse new work, let in-flight finish."""
        self.draining = True
        return 200, {"draining": True, "inflight": self.admission.inflight}


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    frontend: ServeFrontend = None  # set by the server class

    # Silence the default per-request stderr logging (stats cover it).
    def log_message(self, fmt, *args):  # pragma: no cover - logging
        pass

    def _reply(self, status: int, body: dict, headers: Optional[dict] = None):
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        tid = getattr(self, "_trace_id", None)
        if tid is not None:
            self.send_header(obs_trace.TRACE_HEADER, tid)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)
        self._status = status
        self.frontend.record_status(status)

    def _reply_text(self, status: int, text: str, content_type: str):
        data = text.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        tid = getattr(self, "_trace_id", None)
        if tid is not None:
            self.send_header(obs_trace.TRACE_HEADER, tid)
        self.end_headers()
        self.wfile.write(data)
        self._status = status
        self.frontend.record_status(status)

    def _read_json(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b""
        if not raw:
            return {}
        try:
            payload = json.loads(raw)
        except json.JSONDecodeError as e:
            raise WireError(400, f"invalid JSON body: {e}") from None
        if not isinstance(payload, dict):
            raise WireError(400, "JSON body must be an object")
        return payload

    def _traced(self, method: str, run) -> None:
        """Run one request under its trace context + request-event logging.

        The trace ID is the sanitised inbound ``X-Trace-Id`` (a fresh one
        when absent/unsafe), bound as the thread's context for the whole
        handler — admission events and engine spans inherit it — echoed on
        the response, and stamped on the structured ``request`` event along
        with route, status and duration.
        """
        t0 = time.perf_counter()
        inbound = obs_trace.sanitize_trace_id(
            self.headers.get(obs_trace.TRACE_HEADER))
        with obs_trace.trace_context(inbound) as tid:
            self._trace_id = tid
            self._status = 500
            try:
                run()
            finally:
                dur = time.perf_counter() - t0
                self.frontend.observe_request(self.path, self._status, dur)
                obs_trace.emit(
                    "request", method=method, path=self.path,
                    status=self._status, dur_ms=dur * 1e3,
                )

    def do_GET(self):
        self._traced("GET", self._do_get)

    def _do_get(self):
        try:
            if self.path == "/metrics":
                status, text, ctype = self.frontend.metrics()
                self._reply_text(status, text, ctype)
                return
            if self.path == "/healthz":
                status, body = self.frontend.healthz()
            elif self.path == "/stats":
                status, body = self.frontend.stats()
            else:
                status, body = 404, {"error": f"no route {self.path}"}
            self._reply(status, body)
        except Exception as e:  # pragma: no cover - defensive
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    def do_POST(self):
        self._traced("POST", self._do_post)

    def _do_post(self):
        arrival = time.monotonic()
        try:
            payload = self._read_json()
            if self.path == "/predict":
                status, body, headers = self.frontend.predict(
                    payload, arrival=arrival
                )
                self._reply(status, body, headers)
                return
            if self.path == "/append":
                status, body = self.frontend.append(payload)
            elif self.path == "/admin/swap":
                status, body = self.frontend.admin_swap(payload)
            elif self.path == "/admin/drain":
                status, body = self.frontend.admin_drain()
            else:
                status, body = 404, {"error": f"no route {self.path}"}
            self._reply(status, body)
        except WireError as e:
            self._reply(e.status, {"error": str(e)})
        except Exception as e:
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})


class GPHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer bound to one `ServeFrontend`."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, frontend: ServeFrontend, host: str = "127.0.0.1",
                 port: int = 0):
        handler = type("BoundHandler", (_Handler,), {"frontend": frontend})
        super().__init__((host, port), handler)
        self.frontend = frontend

    @property
    def port(self) -> int:
        """The bound TCP port (resolved even when constructed with port 0)."""
        return self.server_address[1]


def start_http_server(
    frontend: ServeFrontend, host: str = "127.0.0.1", port: int = 0
) -> tuple[GPHTTPServer, threading.Thread]:
    """Bind (port 0 => ephemeral) and serve on a daemon thread."""
    server = GPHTTPServer(frontend, host, port)
    thread = threading.Thread(
        target=server.serve_forever, name="gp-http", daemon=True
    )
    thread.start()
    return server, thread
