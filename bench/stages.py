"""One run of a cell with the program's stage spans recorded.

    python3 bench/stages.py --workload <cell> --seed <n> --seconds <s> [--profile 0]

From the root of a checkout, on the card (``--device cpu`` and ``--rows``
for the CPU tests). It runs the cell through ``bench/core.py::run_cell``
(unchanged) with ``repro_torch.obs.trace.recording`` on for the whole
run, and reduces the spans of the window's rounds (``bench/spans.py``).

* ``--profile 1`` (the default) runs as ``bench/run.py --trace 1`` does:
  host times from the untraced segments, device time and idle gaps by span
  from the traced one. Its last line is ``run_cell``'s result with, besides,
  the four span metrics under ``metrics``, ``span_breakdown``,
  ``span_checks`` (each kernel launch inside its wrapper's span, stopping
  reads against ``host_syncs``, idle time outside the program) and
  ``span_cost`` (ns a span, recording off and on, the untraced segments'
  wall).
* ``--profile 0`` runs as ``--trace 0`` does: no profiler starts in the
  process, so no device metric; every segment gives host times, and
  ``step_s`` is the window's with the spans on.

The records go to ``bench/out/<cell>.<seed>.spans.jsonl`` through the
program's ``EventLog``. Under ``--profile 1`` the profiler and the metric
context of ``run_cell`` are wrapped for the run, so that its code and the
seven accepted metrics' readers run as they do in ``bench/run.py``; the
traced segment is the profile ``run_cell`` hands ``layer_context``, and a
run in which either is missing raises.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

METRICS = ("solve_issue_us_per_iter", "precond_ms_per_step",
           "outer_self_ms_per_step", "grad_device_ms_per_step")


def span_cost_ns(count: int = 200_000) -> dict:
    """ns per ``stage`` span of an empty block with recording off and on,
    less the time of an empty block in a shared no-op context."""
    from repro_torch.obs import trace as obs_trace

    null, stage = contextlib.nullcontext(), obs_trace.stage

    def base() -> float:
        t0 = time.perf_counter_ns()
        for _ in range(count):
            with null:
                pass
        return (time.perf_counter_ns() - t0) / count

    def spans() -> float:
        t0 = time.perf_counter_ns()
        for _ in range(count):
            with stage("x"):
                pass
        return (time.perf_counter_ns() - t0) / count

    empty, off = base(), spans()
    with obs_trace.recording():
        on = spans()
    return {"off": off - empty, "on": on - empty, "empty_block": empty}


def run(plan, seed: int, seconds: float, device: str = "cuda",
        rows: int = 0, profile: bool = True) -> dict:
    """``run_cell`` with the spans recorded; its result with the span
    metrics, breakdown, checks and costs. With ``profile`` it runs as
    ``--trace 1`` does (host times from the untraced segments, device time
    and idle gaps from the traced one); without, as ``--trace 0`` does, no
    profiler starting in the process, and every segment gives host times."""
    from bench import core, spans, trace
    from repro_torch.obs import trace as obs_trace

    profiles, held = [], {}
    profiler, layer_context = trace.profiler, core.layer_context

    @contextlib.contextmanager
    def marked(dev):
        t0 = time.time_ns()
        with profiler(dev) as prof:
            yield prof
        profiles.append((prof, t0, time.time_ns()))

    def kept(*args, **kwargs):
        held["ctx"] = ctx = layer_context(*args, **kwargs)
        held["prof"] = args[2][0]
        return ctx

    if profile:
        trace.profiler, core.layer_context = marked, kept
    try:
        with obs_trace.recording() as rec:
            out = core.run_cell(plan, seed, seconds, profile, device,
                                rows=rows)
    finally:
        trace.profiler, core.layer_context = profiler, layer_context
    records = rec.records
    rounds = spans.window_rounds(records, plan.traffic["warmup_steps"])
    if not rounds:
        raise RuntimeError(f"{plan.name}: no fit.round span in the window")

    if profile:
        # The traced segment is the profile run_cell hands layer_context.
        if "ctx" not in held:
            raise RuntimeError(f"{plan.name}: run_cell made no layer context")
        traced = [(t0, t1) for prof, t0, t1 in profiles
                  if prof is held["prof"]]
        if len(traced) != 1:
            raise RuntimeError(f"{plan.name}: the traced segment's profile "
                               f"was not started through bench.trace.profiler")
        ctx, (t0, t1) = held["ctx"], traced[0]
        untraced = [r for r in rounds if r[1] <= t0 or r[0] >= t1]
        device_ops, calls = spans.events(held["prof"])
    else:
        ctx, (t0, t1) = SimpleNamespace(), (0, 0)
        untraced, device_ops, calls = rounds, [], {}
    ctx.spans = s = spans.collect(records, (t0, t1), untraced, device_ops,
                                  calls)
    for name in METRICS:
        value = core.load_metric(plan.root, name).read(ctx)
        if value is not None:
            out["metrics"][name] = {"value": float(value),
                                    "unit": UNITS[name]}
    out["span_breakdown"] = spans.breakdown(s)
    checks = {"reads_per_step": s.reads_per_step,
              "untraced_steps": s.steps, "traced_steps": s.traced_steps}
    if profile:
        idle = sum(s.idle_s.values())
        syncs = [int(v) for v in ctx.window["host_syncs"][:, 0, 0]]
        checks.update(
            wrapped_launches=s.wrapped.get("launches", 0),
            inside_wrapper=s.wrapped.get("inside", 0), host_syncs=syncs,
            reads_match=s.reads_per_step == syncs, idle_s=idle,
            outside_share=s.idle_s.get(spans.OUTSIDE, 0.0) / idle
            if idle else None)
    out["span_checks"] = checks
    out["span_cost"] = dict(span_cost_ns(), records=len(records),
                            segment_s=getattr(ctx, "segment_s", None))
    write_records(plan, seed, rec)
    return out


UNITS = {"solve_issue_us_per_iter": "us/iter", "precond_ms_per_step":
         "ms/step", "outer_self_ms_per_step": "ms/step",
         "grad_device_ms_per_step": "ms/step"}


def write_records(plan, seed: int, rec) -> None:
    """The run's records, in a fresh file (the event log appends)."""
    from bench.core import OUT
    from repro_torch.obs.trace import EventLog

    path = plan.root / OUT / f"{plan.name}.{seed}.spans.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    log = EventLog(path=str(path))
    try:
        rec.write(log)
    finally:
        log.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=0)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=1,
                    help="0: no profiler in the process (host times only)")
    args = ap.parse_args(argv)

    from bench import core

    plan = core.plan_cell(core.load_spec(ROOT), args.workload, ROOT)
    out = run(plan, args.seed, args.seconds, args.device, args.rows,
              bool(args.profile))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
