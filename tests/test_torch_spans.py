"""The port's stage spans (``repro_torch.obs.trace.stage`` / ``recording``):
off, a fit records nothing and runs the same arithmetic bit for bit, and
writes nothing to a configured event log; on, the span tree of CG, AP and
2-lane ``fit_batch`` runs (names, parents, one gradient a step, iterations
and stopping reads against the history, self time), one stack per thread
under ``fit_batch(mesh=)``, the records written as ``span`` events within
their schema, and the spans on the clock of ``torch.profiler``'s events."""
import json
import os
import threading
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.telemetry import EVENT_SCHEMAS, GLOBAL_EVENT_KEYS  # noqa: E402
from repro_torch.core.driver import fit, fit_batch  # noqa: E402
from repro_torch.core.outer import OuterConfig  # noqa: E402
from repro_torch.launch.mesh import make_lane_mesh  # noqa: E402
from repro_torch.obs import trace as tt  # noqa: E402
from repro_torch.solvers import SolverConfig  # noqa: E402

SOLVERS = {
    "cg": SolverConfig(name="cg", tolerance=0.01, max_epochs=30,
                       precond_rank=8),
    "ap": SolverConfig(name="ap", tolerance=0.01, max_epochs=2,
                       block_size=40),
}
STEP_CHILDREN = {"step.targets", "step.solve", "step.grad", "step.adam"}
PARENTS = {
    "fit.round": {None}, "step": {"fit.round"},
    "fit.sync": {"fit.round"}, "fit.readback": {"fit.round"},
    **{name: {"step"} for name in STEP_CHILDREN},
    "solve.precond": {"step.solve"}, "solve.iter": {"step.solve"},
    "solve.read": {"step.solve"},
    "kernel.fwd": {"step.solve", "solve.iter", "step.grad"},
    "kernel.bwd": {"step.grad"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(n=160, d=3):
    gen = torch.Generator().manual_seed(3)
    x = torch.rand(n, d, generator=gen) * 4 - 2
    y = torch.sin(x.sum(-1)) + 0.1 * torch.randn(n, generator=gen)
    return x, y


def _cfg(solver="cg", steps=3):
    return OuterConfig(estimator="pathwise", warm_start=True, num_probes=4,
                       num_rff_pairs=32, num_steps=steps,
                       solver=SOLVERS[solver], backend="cuda")


def _fit(solver="cg", **kwargs):
    x, y = _data()
    return fit(x, y, _cfg(solver), steps_per_round=2, **kwargs)


def _tree(records):
    by_id = {r.id: r for r in records}

    def parent(r):
        p = by_id.get(r.parent)
        return None if p is None else p.name

    def step_of(r):
        while r is not None and r.name != "step":
            r = by_id.get(r.parent)
        return r

    return by_id, parent, step_of


def _per_step(records, name, step_of):
    counts = Counter(step_of(r).id for r in records if r.name == name)
    steps = sorted((r for r in records if r.name == "step"),
                   key=lambda r: r.start_ns)
    return [counts[s.id] for s in steps]


def test_off_records_nothing_and_fit_is_bitwise_unchanged():
    assert tt.stage("step", step=1, lanes=2) is tt.stage("x")
    idle = tt.SpanRecorder()
    off = _fit()
    assert idle.records == []
    with tt.recording() as rec:
        on = _fit()
    assert rec.records and tt._RECORDER is None
    for key in ("hypers", "iters", "host_syncs", "res_y", "res_z"):
        np.testing.assert_array_equal(off.history[key], on.history[key])
    for a, b in zip(off.state.params.leaves, on.state.params.leaves):
        assert torch.equal(a, b)
    assert torch.equal(off.state.carry_v, on.state.carry_v)


@pytest.mark.parametrize("solver", ["cg", "ap"])
def test_span_tree_of_a_fit(solver):
    with tt.recording() as rec:
        res = _fit(solver)
    records = rec.records
    _, parent, step_of = _tree(records)
    names = Counter(r.name for r in records)
    assert set(names) == set(PARENTS)
    for r in records:
        assert parent(r) in PARENTS[r.name], (r.name, parent(r))
        assert r.start_ns <= r.end_ns
        assert r.thread == threading.get_native_id()
    steps = sorted((r for r in records if r.name == "step"),
                   key=lambda r: r.start_ns)
    assert [r.step for r in steps] == [0, 1, 2]
    assert [r.step for r in records if r.name == "fit.round"] == [0, 2]
    assert all(r.lanes == 1 for r in steps)
    assert _per_step(records, "step.grad", step_of) == [1, 1, 1]
    assert _per_step(records, "solve.precond", step_of) == [1, 1, 1]
    assert _per_step(records, "solve.iter", step_of) == \
        list(res.history["iters"])
    assert _per_step(records, "solve.read", step_of) == \
        list(res.history["host_syncs"])


def test_self_time_is_duration_less_child_cover():
    with tt.recording() as rec:
        _fit()
    records = rec.records
    by_id = {r.id: r for r in records}
    kids = {}
    for r in records:
        kids.setdefault(r.parent, []).append(r)
    for r in records:
        own = kids.get(r.id, [])
        assert all(r.start_ns <= k.start_ns <= k.end_ns <= r.end_ns
                   for k in own)
        spans = sorted((k.start_ns, k.end_ns) for k in own)
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        self_ns = r.end_ns - r.start_ns - sum(b - a for a, b in spans)
        assert 0 <= self_ns <= r.end_ns - r.start_ns
    assert all(r.parent in by_id or r.parent == -1 for r in records)


def test_span_tree_of_two_lanes():
    x, y = _data()
    with tt.recording() as rec:
        out = fit_batch(x, y, _cfg(), generators=[1, 2])
    records = rec.records
    _, parent, step_of = _tree(records)
    for r in records:
        assert parent(r) in PARENTS[r.name], (r.name, parent(r))
    steps = [r for r in records if r.name == "step"]
    assert len(steps) == 3 and all(r.lanes == 2 for r in steps)
    (rnd,) = [r for r in records if r.name == "fit.round"]
    assert rnd.lanes == 2 and rnd.step == 0
    iters = np.max([o.history["iters"] for o in out], axis=0)
    assert _per_step(records, "solve.iter", step_of) == list(iters)
    assert _per_step(records, "solve.read", step_of) == \
        list(out[0].history["host_syncs"])
    assert _per_step(records, "step.grad", step_of) == [1, 1, 1]


def test_mesh_groups_keep_their_own_parents():
    x, y = _data()
    with tt.recording() as rec:
        fit_batch(x, y, _cfg(steps=2), generators=[1, 2, 3, 4],
                  mesh=make_lane_mesh(devices=["cpu"] * 2))
    records = rec.records
    by_id = {r.id: r for r in records}
    main = threading.get_native_id()
    steps = [r for r in records if r.name == "step"]
    groups = {r.thread for r in steps}
    assert len(steps) == 4 and len(groups) == 2 and main not in groups
    assert all(r.parent == -1 and r.lanes == 2 for r in steps)
    for r in records:
        p = by_id.get(r.parent)
        assert p is None or p.thread == r.thread
    assert {r.thread for r in records if r.name == "fit.round"} == {main}


def test_records_write_as_span_events(tmp_path):
    with tt.recording() as rec:
        with tt.stage("fit.round", step=4, lanes=2):
            with tt.stage("step"):
                pass
    path = tmp_path / "spans.jsonl"
    log = tt.EventLog(path=str(path))
    assert rec.write(log) == 2
    log.close()
    events = [json.loads(line) for line in path.read_text().splitlines()]
    allowed = EVENT_SCHEMAS["span"] | GLOBAL_EVENT_KEYS
    assert all(set(e) <= allowed and e["kind"] == "span" for e in events)
    inner, outer = events
    assert (inner["span"], outer["span"]) == ("step", "fit.round")
    assert inner["parent"] == outer["id"] and outer["parent"] == -1
    assert outer["step"] == 4 and outer["lanes"] == 2 and "step" not in inner
    assert outer["end_ns"] - outer["start_ns"] == \
        pytest.approx(outer["dur_ms"] * 1e6)


def test_spans_sit_on_the_profilers_clock():
    a = torch.ones(64, 64)
    with tt.recording() as rec:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(50):
                with tt.stage("mm"):
                    a = a @ a / 64.0
    spans = sorted((r.start_ns, r.end_ns) for r in rec.records)
    events = sorted((e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() in ("aten::mm", "aten::div"))
    assert len(spans) == 50 and len(events) == 100
    for i, (start, end) in enumerate(events):
        s0, s1 = spans[i // 2]
        assert s0 <= start <= end <= s1


def test_env_event_log_gets_no_lines_from_a_fit(tmp_path, monkeypatch):
    path = tmp_path / "events.jsonl"
    monkeypatch.setenv(tt.LOG_ENV_VAR, str(path))
    monkeypatch.setattr(tt, "_LOG", None)
    monkeypatch.setattr(tt, "_env_checked", False)
    try:
        _fit()
        tt.emit("marker")
    finally:
        log = tt.get_event_log()
        if log is not None:
            log.close()
    lines = path.read_text().splitlines()
    assert [json.loads(line)["kind"] for line in lines] == ["marker"]
    assert os.environ[tt.LOG_ENV_VAR] == str(path)
