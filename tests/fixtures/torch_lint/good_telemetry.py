"""Telemetry-clean twin of bad_telemetry.py: bounded labels, schema'd
events."""
from repro_torch.obs import trace as obs_trace

_MODES = ("solve", "block", "auto", "step")


class Refresher:
    def __init__(self, registry):
        self._m_refines = registry.counter(
            "x_refines_total", "Refines", labelnames=("mode",))

    def record(self, mode, rows, trace_id):
        label = mode if mode in _MODES else "other"  # bounded vocabulary
        self._m_refines.inc(mode=label)
        obs_trace.emit("refresh", mode=label, n=rows, appended=rows)
