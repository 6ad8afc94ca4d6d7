"""The span reduction (``bench/spans.py``) and the four span metrics on a
synthetic window, with nothing to read when a program records no spans;
then one CPU run of ``bench/stages.py`` at a small size: the span metrics
beside the accepted ones, stopping reads equal to ``host_syncs``."""
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import core, spans, stages  # noqa: E402
from repro_torch.obs.trace import SpanRecord, stage  # noqa: E402

THREAD = 7
# One step's tree, (name, start, end, children), times in ns.
TREE = ("fit.round", 0, 1000, [
    ("step", 10, 900, [
        ("step.targets", 20, 100, []),
        ("step.solve", 100, 600, [
            ("solve.precond", 110, 200, []),
            ("solve.iter", 200, 300, [("kernel.fwd", 210, 250, [])]),
            ("solve.read", 300, 320, []),
            ("solve.iter", 320, 420, [("kernel.fwd", 330, 370, [])]),
            ("solve.read", 420, 440, []),
        ]),
        ("step.grad", 600, 800, [("kernel.fwd", 610, 650, []),
                                 ("kernel.bwd", 660, 700, [])]),
        ("step.adam", 800, 880, []),
    ]),
    ("fit.sync", 900, 950, []),
    ("fit.readback", 950, 990, []),
])


def records(offset: int, first_id: int) -> list:
    out, ids = [], iter(range(first_id, first_id + 100))

    def walk(node, parent):
        name, start, end, kids = node
        rid = next(ids)
        out.append(SpanRecord(rid, name, parent, THREAD, start + offset,
                              end + offset, 0 if name == "step" else None))
        for kid in kids:
            walk(kid, rid)

    walk(TREE, -1)
    return out


def window() -> SimpleNamespace:
    """The tree traced in [0, 1000) and untraced twice in [1000, 3000);
    four kernels launched from the traced segment's spans."""
    recs = records(0, 0) + records(1000, 100) + records(2000, 200)
    device = [("kernel_mvm_fwd_x", 230, 330, 1),     # from solve.iter
              ("kernel_mvm_fwd_x", 620, 680, 2),     # from step.grad
              ("kernel_mvm_bwd_x", 680, 780, 3),     # from step.grad
              ("elementwise", 790, 795, 4),          # from step.grad
              ("Memcpy DtoH", 960, 965, 5)]          # never a kernel
    calls = {1: ("cudaLaunchKernel", 215, 225, (THREAD, 0)),
             2: ("cudaLaunchKernel", 615, 625, (THREAD, 0)),
             3: ("cudaLaunchKernel", 665, 670, (THREAD, 0)),
             4: ("cudaLaunchKernel", 705, 710, (THREAD, 0))}
    return spans.collect(recs, (0, 1000), [(1000, 3000)], device, calls)


def read(name: str, span_data) -> float:
    return core.load_metric(ROOT, name).read(SimpleNamespace(spans=span_data))


def test_reduction_of_a_synthetic_window():
    s = window()
    assert s.steps == 2 and s.traced_steps == 1
    assert s.count["solve.iter"] == 4 and s.count["solve.read"] == 4
    assert s.self_ns["fit.round"] == 2 * (1000 - 890 - 50 - 40)
    assert s.self_ns["step"] == 2 * (890 - 80 - 500 - 200 - 80)
    assert s.self_ns["step.solve"] == 2 * (500 - 90 - 100 - 20 - 100 - 20)
    assert s.total_ns["solve.iter"] == 2 * 200
    assert s.device_ns["step.grad"] == 60 + 100 + 5
    assert s.device_ns["solve.iter"] == s.device_ns["step.solve"] == 100
    assert s.device_ns["step"] == s.device_ns["fit.round"] == 265
    assert s.wrapped == {"launches": 3, "inside": 3}
    assert s.reads_per_step == [2, 2, 2]
    # Gaps between the merged busy intervals, by the span open at their
    # middles: 475 ns (step.solve), 785 (step.grad), 877.5 (step.adam).
    assert s.idle_s == pytest.approx({"step.solve": 290e-9,
                                      "step.grad": 10e-9,
                                      "step.adam": 165e-9})
    b = spans.breakdown(s)
    assert list(b["host_self_ms"])[0] == "step.solve"
    assert b["device_ms"]["step.grad"] == pytest.approx(165e-6)
    assert b["idle_by_span"][0] == ["step.solve", pytest.approx(290e-9)]


def test_the_four_metrics_read_the_reduction():
    s = window()
    assert read("solve_issue_us_per_iter", s) == pytest.approx(0.1)
    assert read("precond_ms_per_step", s) == pytest.approx(90e-6)
    assert read("outer_self_ms_per_step", s) == pytest.approx(
        (20 + 30 + 80 + 80 + 40) * 1e-6)
    assert read("grad_device_ms_per_step", s) == pytest.approx(165e-6)


def test_a_launch_outside_its_wrapper_and_gaps_outside_the_program():
    recs = records(0, 0)
    device = [("kernel_mvm_fwd_x", 1100, 1200, 1),
              ("kernel_mvm_fwd_x", 1300, 1400, 2)]
    calls = {1: ("cudaLaunchKernel", 150, 160, (THREAD, 0)),
             2: ("cudaLaunchKernel", 245, 255, (THREAD, 0))}
    s = spans.collect(recs, (0, 2000), [], device, calls)
    assert s.wrapped == {"launches": 2, "inside": 0}
    assert s.idle_s == {spans.OUTSIDE: pytest.approx(100e-9)}
    assert s.device_ns == {"step.solve": 200, "solve.precond": 100,
                           "step": 200, "fit.round": 200,
                           "solve.iter": 100, "kernel.fwd": 100}


def test_a_worker_threads_top_span_joins_the_span_around_it():
    """Autograd runs a CUDA backward on a thread of its own: its
    ``kernel.bwd`` is the top span there, inside ``step.grad``."""
    recs = [r._replace(thread=9, parent=-1) if r.name == "kernel.bwd" else r
            for r in records(0, 0) + records(1000, 100)]
    device = [("kernel_mvm_bwd_x", 680, 780, 3)]
    calls = {3: ("cudaLaunchKernel", 665, 670, (9, 0))}
    s = spans.collect(recs, (0, 1000), [(1000, 2000)], device, calls)
    assert s.device_ns["step.grad"] == s.device_ns["kernel.bwd"] == 100
    assert s.wrapped == {"launches": 1, "inside": 1}
    assert s.self_ns["step.grad"] == 200 - 40 - 40
    up = spans.parents(recs)
    (bwd,) = [r for r in recs[:len(recs) // 2] if r.name == "kernel.bwd"]
    assert up[bwd.id].name == "step.grad"


@pytest.mark.parametrize("name", stages.METRICS)
def test_nothing_to_read_without_spans(name):
    ctx = SimpleNamespace()
    assert core.load_metric(ROOT, name).read(ctx) is None
    empty = spans.collect([], (0, 1), [(1, 2)], [], {})
    assert read(name, empty) is None


def test_a_cpu_run_reports_the_span_metrics_beside_the_accepted():
    plan = core.plan_cell(core.load_spec(ROOT), "protein.cg-tol", ROOT)
    out = stages.run(plan, 2147483651, 3.0, device="cpu", rows=300)
    m = out["metrics"]
    assert out["correct"]
    for name in ("host_syncs_per_step", "solver_iters_per_step", "fit_mfu",
                 "solve_issue_us_per_iter", "precond_ms_per_step",
                 "outer_self_ms_per_step"):
        assert m[name]["value"] > 0, name
    # No device on the CPU: no device time, no roofline, no idle share.
    assert "grad_device_ms_per_step" not in m
    assert "fwd_kernel_roofline" not in m
    c = out["span_checks"]
    assert c["reads_match"] and c["untraced_steps"] >= 10
    assert c["traced_steps"] == 10
    assert (ROOT / "bench/out/protein.cg-tol.2147483651.spans.jsonl").exists()


def test_the_window_is_the_rounds_from_the_warm_up_on():
    recs = [r._replace(step=0) if r.name == "fit.round" else r
            for r in records(0, 0)]
    recs += [r._replace(step=3) if r.name == "fit.round" else r
             for r in records(1000, 100) + records(2000, 200)]
    assert spans.window_rounds(recs, 3) == [(1000, 2000), (2000, 3000)]
    assert spans.window_rounds(recs, 4) == []


def test_a_run_without_its_traced_profile_raises(monkeypatch):
    """``stages.run`` takes the traced segment from what ``run_cell``
    hands ``layer_context``; a run that hands it nothing fails loudly."""
    plan = core.plan_cell(core.load_spec(ROOT), "protein.cg-tol", ROOT)
    def window_only(*args, **kwargs):
        with stage("fit.round", step=99):
            pass
        return {"metrics": {}}

    monkeypatch.setattr(core, "run_cell", lambda *a, **k: {"metrics": {}})
    with pytest.raises(RuntimeError, match="no fit.round"):
        stages.run(plan, 1, 1.0, device="cpu", rows=300)
    monkeypatch.setattr(core, "run_cell", window_only)
    with pytest.raises(RuntimeError, match="no layer context"):
        stages.run(plan, 1, 1.0, device="cpu", rows=300)


def test_a_cpu_run_without_a_profiler_gives_host_times_and_step_s():
    plan = core.plan_cell(core.load_spec(ROOT), "protein.cg-tol", ROOT)
    out = stages.run(plan, 2147483652, 1.0, device="cpu", rows=300,
                     profile=False)
    m = out["metrics"]
    assert out["correct"]
    for name in ("step_s", "setup_s", "solve_issue_us_per_iter",
                 "precond_ms_per_step", "outer_self_ms_per_step"):
        assert m[name]["value"] > 0, name
    for name in ("fwd_kernel_roofline", "grad_device_ms_per_step",
                 "host_syncs_per_step"):
        assert name not in m
    c = out["span_checks"]
    assert c["traced_steps"] == 0 and c["untraced_steps"] >= 10
    assert c["untraced_steps"] == len(c["reads_per_step"])
    assert out["span_breakdown"]["device_ms"] == {}
