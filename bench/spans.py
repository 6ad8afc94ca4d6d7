"""Reduction of the program's stage spans to what the span metrics read.

The program records a stage span at each layer boundary
(``repro_torch.obs.trace.stage``: ``fit.round``, ``step``, ``step.targets``,
``step.solve``, ``solve.precond``, ``solve.iter``, ``solve.read``,
``step.grad``, ``step.adam``, ``fit.sync``, ``fit.readback``,
``kernel.fwd``, ``kernel.bwd``) on the clock of ``torch.profiler``'s
events. A run records them over its whole window and tags each by the
segment it fell in:

* host times come from the untraced segments only (the trace costs ~35 us
  of host time a launch): each span name's count, total and self time
  (its duration less the part its child spans cover), per lane-stacked
  step (``step`` spans);
* device time and idle gaps come from the traced segment: each kernel goes
  to the innermost span open at the runtime call that launched it (matched
  by correlation ID, on the call's thread), and counts for that span and
  every span around it; each idle gap between the device's merged busy
  intervals (``bench/trace.py``'s union) goes to the innermost span open
  at its middle, or to ``outside the program``.

:func:`collect` makes the reduction once (``ctx.spans``); the span metrics
(``bench/metrics/solve_issue_us_per_iter.py``, ``precond_ms_per_step.py``,
``outer_self_ms_per_step.py``, ``grad_device_ms_per_step.py``) and
:func:`breakdown` read it. Without spans (a program that records none)
there is nothing to collect and each metric reads None.
"""
from __future__ import annotations

import re
from collections import Counter, defaultdict
from types import SimpleNamespace

from bench.trace import NOT_KERNELS, TOP, _union

OUTSIDE = "outside the program"
# Kernels whose launching call must fall inside a kernel wrapper's span.
WRAPPED = {r"kernel_mvm_fwd": "kernel.fwd", r"kernel_mvm_bwd": "kernel.bwd"}
# The outer loop's own stages: host self time left once the solve, the
# gradient and the round's synchronise are taken out.
OUTER = ("fit.round", "step", "step.targets", "step.adam", "fit.readback")


def events(prof) -> tuple:
    """(device, calls) of a finished profile: device operations as
    (name, start_ns, end_ns, correlation) and host events by correlation
    ID as (name, start_ns, end_ns, thread IDs)."""
    device, calls = [], {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            device.append((e.name(), e.start_ns(), e.end_ns(),
                           e.correlation_id()))
        elif e.correlation_id():
            calls[e.correlation_id()] = (
                e.name(), e.start_ns(), e.end_ns(),
                (e.start_thread_id(), e.device_resource_id()))
    return device, calls


def _within(r, spans: list) -> bool:
    return any(a <= r.start_ns and r.end_ns <= b for a, b in spans)


def parents(records: list) -> dict:
    """Each record's parent record: the span that enclosed it on its
    thread, or, for the top span of a thread, the innermost span of
    another thread that encloses it (the caller a worker thread serves:
    autograd runs the backward of CUDA tensors on a thread of its own, a
    sharded ``fit_batch`` a lane group on each); None for neither."""
    by_id = {r.id: r for r in records}
    out = {}
    for r in records:
        p = by_id.get(r.parent)
        if p is None:
            around = [q for q in records if q.thread != r.thread
                      and q.start_ns <= r.start_ns and r.end_ns <= q.end_ns]
            p = max(around, key=lambda q: (q.start_ns, -q.end_ns),
                    default=None)
        out[r.id] = p
    return out


def _self_ns(records: list, parent: dict) -> dict:
    """Each record's duration less the part its children cover."""
    kids = defaultdict(list)
    for r in records:
        if parent[r.id] is not None:
            kids[parent[r.id].id].append(r)
    own = {}
    for r in records:
        cover, end = 0, r.start_ns
        for a, b in sorted((k.start_ns, k.end_ns) for k in kids[r.id]):
            a, b = max(a, end), min(b, r.end_ns)
            if b > a:
                cover, end = cover + b - a, b
        own[r.id] = r.end_ns - r.start_ns - cover
    return own


def innermost(records: list, queries: list) -> list:
    """For each query (t_ns, thread), the innermost record open at t on
    that thread; with thread None, on any thread (the latest-starting of
    the innermost ones). None where no record is open."""
    ev = [(r.start_ns, 0, -r.end_ns, i) for i, r in enumerate(records)]
    ev += [(r.end_ns, 2, -r.start_ns, i) for i, r in enumerate(records)]
    ev += [(t, 1, 0, j) for j, (t, _) in enumerate(queries)]
    ev.sort()
    stacks, out = defaultdict(list), [None] * len(queries)
    for _, kind, _, i in ev:
        if kind == 0:
            stacks[records[i].thread].append(records[i])
        elif kind == 2:
            stack = stacks[records[i].thread]
            if stack and stack[-1] is records[i]:
                stack.pop()
            else:
                stack.remove(records[i])
        else:
            thread = queries[i][1]
            if thread is not None:
                stack = stacks.get(thread)
                out[i] = stack[-1] if stack else None
            else:
                tops = [s[-1] for s in stacks.values() if s]
                out[i] = max(tops, key=lambda r: r.start_ns, default=None)
    return out


def _thread(ids: tuple, known: set):
    """The span thread among a host event's thread IDs; the only one when
    the spans ran on one thread; else None (any thread)."""
    for tid in ids:
        if tid in known:
            return tid
    return next(iter(known)) if len(known) == 1 else None


def _chain(span, parent: dict) -> list:
    """``span`` and every span around it."""
    chain = []
    while span is not None:
        chain.append(span)
        span = parent[span.id]
    return chain


def _per_step(records: list, parent: dict, name: str) -> list:
    """Each ``step`` record's count of ``name`` spans inside it, in time
    order."""
    counts = Counter()
    for r in records:
        if r.name == name:
            step = next((p for p in _chain(r, parent) if p.name == "step"),
                        None)
            if step is not None:
                counts[step.id] += 1
    return [counts[r.id] for r in sorted(records, key=lambda r: r.start_ns)
            if r.name == "step"]


def window_rounds(records: list, first_step: int) -> list:
    """(start_ns, end_ns) of each top ``fit.round`` from step
    ``first_step`` on: a cell's window, whose segments all start from its
    warm-up's last state (set-up's rounds start before it)."""
    return sorted((r.start_ns, r.end_ns) for r in records
                  if r.name == "fit.round" and r.parent == -1
                  and r.step is not None and r.step >= first_step)


def collect(records: list, traced: tuple, untraced: list, device: list,
            calls: dict) -> SimpleNamespace:
    """The reduction of a window's spans. ``traced`` is the traced
    segment's (start_ns, end_ns), ``untraced`` the untraced segments';
    ``device`` and ``calls`` the traced segment's profile (:func:`events`)."""
    host = [r for r in records if _within(r, untraced)]
    seg = [r for r in records if _within(r, [traced])]
    up = parents(host)
    self_ns = _self_ns(host, up)
    steps = sum(r.name == "step" for r in host)
    count, total, own = Counter(), Counter(), Counter()
    for r in host:
        count[r.name] += 1
        total[r.name] += r.end_ns - r.start_ns
        own[r.name] += self_ns[r.id]

    known = {r.thread for r in seg}
    kernels = [d for d in device if not d[0].startswith(NOT_KERNELS)]
    launch = [calls.get(corr) for _, _, _, corr in kernels]
    at = innermost(seg, [(c[1], _thread(c[3], known)) if c else (-1, None)
                         for c in launch])
    seg_up = parents(seg)
    device_ns, wrapped = Counter(), Counter()
    for (name, a, b, _), call, span in zip(kernels, launch, at):
        chain = _chain(span, seg_up)
        for n in {s.name for s in chain}:
            device_ns[n] += b - a
        for pattern, wrapper in WRAPPED.items():
            if re.search(pattern, name):
                wrapped["launches"] += 1
                wrapped["inside"] += any(s.name == wrapper
                                         and call[2] <= s.end_ns
                                         for s in chain)

    _, merged = _union([(a / 1e3, b / 1e3) for _, a, b, _ in device])
    gaps = [(e, s) for (_, e), (s, _) in zip(merged, merged[1:])]
    idle = Counter()
    for (e, s), span in zip(gaps, innermost(
            seg, [(int((e + s) / 2 * 1e3), None) for e, s in gaps])):
        idle[span.name if span is not None else OUTSIDE] += (s - e) / 1e6
    traced_steps = sum(r.name == "step" for r in seg)
    return SimpleNamespace(
        steps=steps, count=dict(count), total_ns=dict(total),
        self_ns=dict(own),
        traced_steps=traced_steps, device_ns=dict(device_ns),
        idle_s=dict(idle), wrapped=dict(wrapped),
        reads_per_step=_per_step(seg, seg_up, "solve.read")
        + _per_step(host, up, "solve.read"))


def breakdown(spans: SimpleNamespace) -> dict:
    """The traced run's ``span_breakdown``: host self time and device time
    per span name per step (ms), and the idle gaps by span (s, top 10)."""
    per = max(spans.steps, 1)
    dev = max(spans.traced_steps, 1)
    return {"host_self_ms": {n: v / 1e6 / per for n, v in
                             sorted(spans.self_ns.items(), key=lambda kv: -kv[1])},
            "device_ms": {n: v / 1e6 / dev for n, v in
                          sorted(spans.device_ns.items(), key=lambda kv: -kv[1])},
            "idle_by_span": [[n, s] for n, s in sorted(
                spans.idle_s.items(), key=lambda kv: -kv[1])[:TOP]]}
