"""Trace IDs, span timing, and a JSON-lines structured event log (stdlib).

The port's own copy of ``repro.obs.trace``: the same ID rules, event
format, rotation and ``$REPRO_OBS_LOG`` auto-configuration, with its own
process-wide log and trace context.

One request = one trace ID. The transport mints it at ingress (honouring an
inbound ``X-Trace-Id`` header after :func:`sanitize_trace_id`), stores it in
a ``contextvars.ContextVar`` so everything on the request's call path —
admission decisions, engine spans, refresh triggers — can stamp events
without threading the ID through every signature, and echoes it back on the
response. Offline, the JSONL events group back into per-trace waterfalls.

Event log format: one JSON object per line, always carrying ``ts`` (epoch
seconds), ``kind`` and — when one is current or given — ``trace_id``.
Span events add ``span`` (name) and ``dur_ms``. Everything else is
kind-specific payload. Writers are per-process (the path template may
contain ``{pid}``), append-only, line-buffered behind a lock, so replica
processes never interleave partial lines.
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import os
import re
import secrets
import threading
import time
from typing import Optional

# Header carrying the trace ID over HTTP, both directions.
TRACE_HEADER = "X-Trace-Id"

# Accepted inbound trace IDs: short, printable, shell/log-safe. Anything
# else is REPLACED with a fresh ID (never echoed back raw — log injection).
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._\-]{0,127}$")

_current_trace: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_obs_trace_id", default=None
)

# Environment variable that auto-configures the process event log (used by
# replica workers and CI smoke jobs; ``{pid}`` expands per process).
LOG_ENV_VAR = "REPRO_OBS_LOG"


def new_trace_id() -> str:
    """A fresh 16-hex-char trace ID (64 random bits)."""
    return secrets.token_hex(8)


def sanitize_trace_id(raw: Optional[str]) -> Optional[str]:
    """``raw`` if it is a safe trace ID, else None (caller mints a new one).

    Inbound header values are attacker-controlled; anything not matching
    the conservative charset/length rule is dropped rather than quoted.
    """
    if raw is None:
        return None
    raw = raw.strip()
    return raw if _TRACE_ID_RE.match(raw) else None


def current_trace_id() -> Optional[str]:
    """The trace ID bound to the current context (None outside a request)."""
    return _current_trace.get()


@contextlib.contextmanager
def trace_context(trace_id: Optional[str]):
    """Bind ``trace_id`` as the current trace for the with-block.

    ``None`` mints a fresh ID. Yields the bound ID. Context-local, so
    concurrent handler threads never see each other's IDs.
    """
    tid = trace_id if trace_id is not None else new_trace_id()
    token = _current_trace.set(tid)
    try:
        yield tid
    finally:
        _current_trace.reset(token)


class EventLog:
    """Append-only JSON-lines event writer (one per process).

    Args:
      path: file path; ``{pid}`` expands to the process ID so several
        processes given the same template never share a file.
      stream: an open text stream instead of a path (tests, stdout).
      max_bytes: when > 0 and ``path``-backed, rotate once the file would
        exceed this size: the live file moves to ``<path>.1`` (existing
        rotations shift to ``.2`` … ``.backups``, the oldest dropped) and a
        fresh file is opened. Rotation happens between lines, under the
        writer lock, so no event is ever split across files.
      backups: how many rotated files to keep (>= 1 when rotating).
    Exactly one of ``path`` / ``stream`` must be given; rotation requires
    ``path``.
    """

    def __init__(self, path: Optional[str] = None, stream=None,
                 max_bytes: int = 0, backups: int = 3):
        if (path is None) == (stream is None):
            raise ValueError("pass exactly one of path= or stream=")
        if max_bytes and path is None:
            raise ValueError("rotation (max_bytes) requires path=")
        if max_bytes and backups < 1:
            raise ValueError("backups must be >= 1 when rotating")
        self.path = None
        self.max_bytes = int(max_bytes)
        self.backups = int(backups)
        self.rotations = 0  #: guarded by self._lock
        if path is not None:
            path = path.replace("{pid}", str(os.getpid()))
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self.path = path
            self._fh = open(path, "a", encoding="utf-8")  #: guarded by self._lock
            self._owns = True
        else:
            self._fh = stream  #: guarded by self._lock
            self._owns = False
        self._lock = threading.Lock()
        self.events_written = 0  #: guarded by self._lock

    def _rotate_locked(self, incoming: int) -> None:
        """Rotate if writing ``incoming`` more bytes would exceed the cap."""
        try:
            size = self._fh.tell()
        except (OSError, ValueError):
            return
        if size == 0 or size + incoming <= self.max_bytes:
            return
        self._fh.close()
        for i in range(self.backups, 1, -1):
            src = f"{self.path}.{i - 1}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i}")
        os.replace(self.path, f"{self.path}.1")
        self._fh = open(self.path, "a", encoding="utf-8")
        self.rotations += 1

    def emit(self, kind: str, trace_id: Optional[str] = None, **fields) -> dict:
        """Write one event line; returns the event dict.

        ``trace_id`` defaults to the context's current trace (omitted from
        the line when there is none). ``fields`` must be JSON-serialisable.
        """
        event = {"ts": time.time(), "kind": str(kind)}
        tid = trace_id if trace_id is not None else current_trace_id()
        if tid is not None:
            event["trace_id"] = tid
        event.update(fields)
        line = json.dumps(event, separators=(",", ":"))
        with self._lock:
            if self.max_bytes and self._owns:
                self._rotate_locked(len(line) + 1)
            self._fh.write(line + "\n")
            self._fh.flush()
            self.events_written += 1
        return event

    def close(self) -> None:
        """Flush and close the underlying file (no-op for borrowed streams)."""
        with self._lock:
            if self._owns:
                self._fh.close()


_log_lock = threading.Lock()
_LOG: Optional[EventLog] = None
_env_checked = False


def configure(path: Optional[str] = None, stream=None,
              max_bytes: int = 0, backups: int = 3) -> Optional[EventLog]:
    """Install (or clear) the process-wide event log.

    ``configure(path=...)`` or ``configure(stream=...)`` installs a writer
    (``max_bytes``/``backups`` forward to :class:`EventLog` rotation);
    ``configure()`` with neither closes and clears it (events become
    no-ops again). Returns the installed log (or None).
    """
    global _LOG, _env_checked
    with _log_lock:
        if _LOG is not None and _LOG._owns:
            _LOG.close()
        _LOG = (
            EventLog(path=path, stream=stream, max_bytes=max_bytes,
                     backups=backups)
            if (path is not None or stream is not None) else None
        )
        _env_checked = True  # explicit configure wins over the env var
        return _LOG


def get_event_log() -> Optional[EventLog]:
    """The process-wide event log, auto-configured from ``$REPRO_OBS_LOG``.

    Returns None when no log is configured — callers must treat that as
    "observability off" and skip, which is what :func:`emit` does.
    """
    global _LOG, _env_checked
    if _LOG is None and not _env_checked:
        with _log_lock:
            if _LOG is None and not _env_checked:
                path = os.environ.get(LOG_ENV_VAR)
                if path:
                    _LOG = EventLog(path=path)
                _env_checked = True
    return _LOG


def emit(kind: str, trace_id: Optional[str] = None, **fields) -> Optional[dict]:
    """Emit an event to the process-wide log; no-op (None) when unconfigured."""
    log = get_event_log()
    if log is None:
        return None
    return log.emit(kind, trace_id=trace_id, **fields)


class Span:
    """A named, timed unit of work inside a trace (yielded by :func:`span`).

    Extra fields can be attached while the span is open::

        with span("engine.submit", bucket=64) as sp:
            ...
            sp.fields["rows"] = m

    ``dur_ms`` is filled in at exit, just before the event is written.
    """

    def __init__(self, name: str, fields: dict):
        self.name = name
        self.fields = fields
        self.t0 = time.perf_counter()
        self.dur_ms: Optional[float] = None


@contextlib.contextmanager
def span(name: str, log: Optional[EventLog] = None,
         trace_id: Optional[str] = None, **fields):
    """Time a block and emit a ``span`` event (no-op when no log is active).

    The event carries ``span`` (the name), ``dur_ms``, the current (or
    given) trace ID, and any extra ``fields`` — including ones attached to
    the yielded :class:`Span` while it is open. An exception inside the
    block still emits the span, with ``error`` set to the exception type,
    then propagates.
    """
    sp = Span(name, dict(fields))
    error = None
    try:
        yield sp
    except BaseException as e:
        error = type(e).__name__
        raise
    finally:
        sp.dur_ms = (time.perf_counter() - sp.t0) * 1e3
        target = log if log is not None else get_event_log()
        if target is not None:
            payload = dict(sp.fields)
            if error is not None:
                payload["error"] = error
            target.emit("span", trace_id=trace_id, span=name,
                        dur_ms=sp.dur_ms, **payload)
