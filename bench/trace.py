"""Reduction of one ``torch.profiler`` trace to what the metrics read.

The trace records the device's activity and the CUDA runtime calls that
issued it (``ProfilerActivity.CUDA`` alone: recording every PyTorch
operator on the host as well slowed a segment 3-6 fold on the card). The
device's busy time is the union of its operations' intervals (two that
overlap count once; the rule of ``chip_smoke.py::_device_busy``). The
breakdown names the device operations that took the most time and sums
the idle gaps between them by what the host was doing meanwhile: the
innermost runtime call that spans the gap's middle ("no host event": the
host was running Python, between calls).
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from types import SimpleNamespace

NOT_KERNELS = ("Memcpy", "Memset")
TOP = 10
NAME_CHARS = 120


def _union(spans: list) -> tuple:
    """(total seconds covered, merged intervals) of (start, end) in us."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged) / 1e6, merged


def _host_label(starts: list, host: list, t: float) -> str:
    """The innermost host event spanning time ``t`` (the latest-starting
    one that has not ended), or a note that none does."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 5000, 0) - 1, -1):
        if host[j][2] >= t:
            return host[j][0]
    return "no host event"


def _events(prof) -> tuple:
    """(device events, host events) of a finished profile as (name,
    start_us, end_us), read from the raw trace (building the profiler's
    event tree took a minute for a segment of 200 000 launches)."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
        (device if str(e.device_type()).endswith("CUDA") else host).append(rec)
    return device, host


def profiler(device):
    """A profiler of the device's activity (the host's on the CPU, for the
    tests)."""
    import torch

    act = torch.profiler.ProfilerActivity
    return torch.profiler.profile(activities=[
        act.CUDA if torch.device(device).type == "cuda" else act.CPU])


def warm_up(device) -> None:
    """One short profile, so that the profiler's first start (seconds of
    CUPTI set-up) falls in set-up and not in the traced window."""
    import torch

    with profiler(device):
        torch.ones(1, device=device).add_(1.0)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()


def reduce(prof, window_s: float) -> SimpleNamespace:
    """Summary of a finished profile over a traced window of ``window_s``
    seconds: ``kernels`` [(name, start_us, end_us)], the busy and window
    seconds, and the breakdown's two lists."""
    device, host = _events(prof)
    busy_s, merged = _union([(a, b) for _, a, b in device])
    per_name = defaultdict(float)
    for name, a, b in device:
        per_name[name[:NAME_CHARS]] += (b - a) / 1e6
    host.sort(key=lambda h: h[1])
    starts = [h[1] for h in host]
    gaps = defaultdict(float)
    for (_, end), (start, _) in zip(merged, merged[1:]):
        gaps[_host_label(starts, host, (start + end) / 2)[:NAME_CHARS]] += \
            (start - end) / 1e6
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return SimpleNamespace(
        kernels=[d for d in device if not d[0].startswith(NOT_KERNELS)],
        busy_s=busy_s, window_s=window_s,
        breakdown={"device_ops": [[n, s] for n, s in top],
                   "idle_gaps": [[n, s] for n, s in idle]})
