"""Multi-process cluster serving on top of the bucketed engine; port of
``repro.serve.cluster`` (the same modules and names, on PyTorch: replicas
serve on the card unless asked for the CPU).

The step from "a library you can call" to "a service you can run":

  * :mod:`repro_torch.serve.cluster.transport` — stdlib HTTP front-end
    (``/predict``, ``/healthz``, ``/stats``, ``/admin/swap``) with a JSON
    wire format and per-request deadlines;
  * :mod:`repro_torch.serve.cluster.admission` — per-bucket token buckets,
    bounded concurrency, deadline-aware load shedding (429 + Retry-After)
    and priority classes;
  * :mod:`repro_torch.serve.cluster.store` — versioned artifact distribution
    with content-hash manifests and an atomic ``LATEST`` pointer;
  * :mod:`repro_torch.serve.cluster.replica` — worker processes + a supervisor
    that spawns, monitors and drains them;
  * :mod:`repro_torch.serve.cluster.monitor` — the fleet monitor: scrapes every
    replica's ``/metrics`` + ``/stats``, evaluates SLO burn rates, and
    serves the aggregated ``/fleet/*`` endpoints the autoscaler consumes.
"""
from repro_torch.serve.cluster.admission import (
    AdmissionController,
    AdmissionStats,
    Decision,
    Priority,
    TokenBucket,
    parse_priority,
)
from repro_torch.serve.cluster.monitor import (
    FleetMonitor,
    MonitorHTTPServer,
    start_monitor_server,
)
from repro_torch.serve.cluster.replica import ReplicaSupervisor, run_worker
from repro_torch.serve.cluster.store import (
    ArtifactPoller,
    fetch_servable,
    latest_version,
    list_versions,
    publish_servable,
    read_manifest,
)
from repro_torch.serve.cluster.transport import (
    GPHTTPServer,
    ServeFrontend,
    WireError,
    start_http_server,
)

__all__ = [
    "AdmissionController", "AdmissionStats", "Decision", "Priority",
    "TokenBucket", "parse_priority",
    "FleetMonitor", "MonitorHTTPServer", "start_monitor_server",
    "ReplicaSupervisor", "run_worker",
    "ArtifactPoller", "fetch_servable", "latest_version", "list_versions",
    "publish_servable", "read_manifest",
    "GPHTTPServer", "ServeFrontend", "WireError", "start_http_server",
]
