"""Seeded telemetry-hygiene violations (exact lines asserted in tests)."""
from repro_torch.obs import trace as obs_trace


class Refresher:
    def __init__(self, registry):
        self._m_refines = registry.counter(
            "x_refines_total", "Refines", labelnames=("mode",))

    def record(self, mode, rows, trace_id):
        self._m_refines.inc(mode=f"{mode}-{rows}")  # LINE 11: telemetry-label
        label = "m_" + mode
        self._m_refines.inc(mode=label)  # LINE 13: telemetry-label (local)
        obs_trace.emit("refrsh", mode=mode)  # LINE 14: unknown event kind
        obs_trace.emit("refresh", mode=mode,
                       rows=rows)  # LINE 15-16: off-schema key
