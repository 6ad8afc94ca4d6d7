"""The trace reduction reads the profiler's raw events: on the CPU the
host's runtime events are found and no device time is invented."""
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import trace  # noqa: E402


def test_a_cpu_profile_reduces_to_host_events_and_no_device_time():
    with trace.profiler("cpu") as prof:
        a = torch.ones(64, 64)
        for _ in range(3):
            a = a @ a / 64.0
    device, host = trace._events(prof)
    assert not device
    assert any("mm" in name for name, _, _ in host)
    assert all(end >= start for _, start, end in host)
    out = trace.reduce(prof, 0.5)
    assert out.busy_s == 0.0 and out.window_s == 0.5 and not out.kernels
    assert out.breakdown == {"device_ops": [], "idle_gaps": []}
