"""The port's observability (``repro_torch.obs``) against the JAX package's
``repro.obs``: the Prometheus text that the same sequence of instrument calls
renders (compared line for line), label and HELP escaping, registry
idempotence, the null registry, the bucket quantiles, trace-ID sanitising,
the event log with spans, rotation and the module-level log; then
``fit(event_log=)`` against the reference's events for the same fit (from
the reference's initial state, carried across by ``repro_torch.interop``),
``fit_batch``'s lane-tagged events, and the kernels' launch counters under
several threads. Tolerances: iterations equal, residuals and budget numbers
rtol 1e-3 (the residuals' agreement between the packages), rendered text
exact."""
import io
import json
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import OuterConfig as JOuterConfig  # noqa: E402
from repro.core import fit as j_fit  # noqa: E402
from repro.core.outer import init_outer_state as j_init  # noqa: E402
from repro.data.synthetic import make_gp_regression  # noqa: E402
from repro.obs import metrics as jm  # noqa: E402
from repro.obs import trace as jt  # noqa: E402
from repro.solvers import SolverConfig as JSolverConfig  # noqa: E402
from repro.solvers import adaptive as ja  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.driver import fit, fit_batch  # noqa: E402
from repro_torch.core.outer import OuterConfig  # noqa: E402
from repro_torch.kernels import tiled  # noqa: E402
from repro_torch.obs import metrics as tm  # noqa: E402
from repro_torch.obs import trace as tt  # noqa: E402
from repro_torch.solvers import SolverConfig  # noqa: E402
from repro_torch.solvers import adaptive as ta  # noqa: E402

RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensor ops: one intra-op thread beside the other workers of a
    parallel run (restored after)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _drive(mod, reg):
    """One fixed sequence of instrument calls on ``reg`` (module ``mod``)."""
    c = reg.counter("gp_req_total", "Requests by path", labelnames=("path",))
    c.inc(path="/a")
    c.inc(2.5, path="/a")
    c.inc(path='/pre"dict\n\\x')
    reg.counter("gp_plain_total", 'help with "quotes"\nand \\ newline').inc(7)
    g = reg.gauge("gp_depth", "Queue depth", labelnames=("q",))
    g.set(3, q="x")
    g.inc(-1.5, q="x")
    g.set_ewma(10.0, q="y")
    g.set_ewma(20.0, alpha=0.25, q="y")
    h = reg.histogram("gp_lat_seconds", "Latency", labelnames=("bucket",))
    for v in (0.0001, 0.003, 0.02, 0.7, 3.0, 42.0, float("inf")):
        h.observe(v, bucket="16")
    h2 = reg.histogram("gp_small", "", buckets=(0.5, 0.1, 1.0))
    h2.observe(0.25)
    reg.gauge("gp_nan").set(float("nan"))
    reg.gauge("gp_big").set(1e20)
    reg.gauge("gp_frac").set(0.1 + 0.2)
    return reg


def test_render_matches_reference_line_for_line():
    """The same calls render the same exposition text, line for line."""
    t = _drive(tm, tm.MetricsRegistry()).render().splitlines()
    j = _drive(jm, jm.MetricsRegistry()).render().splitlines()
    assert t == j
    assert 'gp_req_total{path="/pre\\"dict\\n\\\\x"} 1' in t
    assert '# HELP gp_plain_total help with "quotes"\\nand \\\\ newline' in t
    assert 'gp_lat_seconds_bucket{bucket="16",le="+Inf"} 7' in t
    assert tm.CONTENT_TYPE == jm.CONTENT_TYPE


def test_render_prometheus_default_registry_and_empty():
    assert tm.render_prometheus(tm.MetricsRegistry()) == ""
    assert tm.default_registry() is tm.default_registry()
    assert tm.default_registry() is not jm.default_registry()
    reg = _drive(tm, tm.MetricsRegistry())
    assert tm.render_prometheus(reg) == reg.render()


def test_registry_idempotent_and_mismatch():
    reg = tm.MetricsRegistry()
    a = reg.counter("x_total", "x")
    assert reg.counter("x_total", "x") is a
    assert reg.get("x_total") is a and reg.get("nope") is None
    with pytest.raises(ValueError):
        reg.gauge("x_total", "x")
    with pytest.raises(ValueError):
        reg.counter("x_total", "x", labelnames=("k",))
    with pytest.raises(ValueError):
        reg.counter("bad name", "x")
    with pytest.raises(ValueError):
        reg.histogram("h", "h", labelnames=("le",))
    with pytest.raises(ValueError):
        a.inc(-1.0)
    with pytest.raises(ValueError):
        reg.counter("y_total", "y", labelnames=("k",)).inc()  # label missing
    assert reg.names() == ["x_total", "y_total"]


def test_null_registry_is_inert():
    reg = tm.NullRegistry()
    reg.counter("a_total", "a").inc()
    reg.gauge("b", "b").set(1.0)
    reg.histogram("c", "c").observe(0.5)
    assert reg.render() == "" and tm.NULL_REGISTRY.render() == ""


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.9, 0.99, 1.0, 1.5])
def test_quantile_and_fraction_match_reference(q):
    bounds = tm.DEFAULT_BUCKETS
    counts = np.random.default_rng(3).integers(0, 5, len(bounds) + 1)
    cum = list(np.cumsum(counts).astype(float))
    a = tm.quantile_from_buckets(bounds, cum, q)
    b = jm.quantile_from_buckets(bounds, cum, q)
    assert (np.isnan(a) and np.isnan(b)) or a == b
    thr = q * 2.0
    assert tm.bucket_fraction_le(bounds, cum, thr) == \
        jm.bucket_fraction_le(bounds, cum, thr)
    assert np.isnan(tm.quantile_from_buckets(bounds, [0.0] * len(cum), q))


def test_sanitize_and_mint_trace_ids():
    for raw in ("abc-123.X_9", "  ok42  ", None, "", "has space",
                "semi;colon", "a" * 200, "-leadingdash", 'inj"ect\n'):
        assert tt.sanitize_trace_id(raw) == jt.sanitize_trace_id(raw)
    tid = tt.new_trace_id()
    assert len(tid) == 16 and tt.sanitize_trace_id(tid) == tid
    assert tt.TRACE_HEADER == jt.TRACE_HEADER


def test_event_log_and_span_carry_trace_id():
    buf = io.StringIO()
    log = tt.EventLog(stream=buf)
    with tt.trace_context("t-1") as tid:
        assert tid == "t-1" and tt.current_trace_id() == "t-1"
        assert jt.current_trace_id() is None  # the port's own context
        log.emit("thing", value=3)
        with pytest.raises(RuntimeError):
            with tt.span("work", log=log, rows=4):
                raise RuntimeError("boom")
        with tt.span("ok", log=log) as sp:
            sp.fields["extra"] = 1
    assert tt.current_trace_id() is None
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert [e["kind"] for e in events] == ["thing", "span", "span"]
    assert all(e["trace_id"] == "t-1" for e in events)
    assert events[1]["span"] == "work" and events[1]["error"] == "RuntimeError"
    assert events[1]["dur_ms"] >= 0 and events[1]["rows"] == 4
    assert events[2]["extra"] == 1 and "error" not in events[2]
    assert log.events_written == 3
    with pytest.raises(ValueError):
        tt.EventLog()
    with pytest.raises(ValueError):
        tt.EventLog(stream=buf, max_bytes=10)


def test_event_log_rotation(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    log = tt.EventLog(path=path, max_bytes=200, backups=2)
    for i in range(30):
        log.emit("e", i=i, pad="x" * 20)
    log.close()
    assert log.rotations > 0 and os.path.exists(path + ".1")
    assert not os.path.exists(path + ".3")
    lines = [json.loads(line) for p in (path + ".2", path + ".1", path)
             if os.path.exists(p) for line in open(p)]
    assert [e["i"] for e in lines] == list(range(30 - len(lines), 30))


def test_module_emit_noop_until_configured(tmp_path):
    tt.configure()
    assert tt.emit("ignored") is None
    path = str(tmp_path / "log" / "events-{pid}.jsonl")
    tt.configure(path=path)
    try:
        tt.emit("hello", n=1)
        expanded = path.replace("{pid}", str(os.getpid()))
        (ev,) = [json.loads(line) for line in open(expanded)]
        assert ev["kind"] == "hello" and ev["n"] == 1
        assert jt.get_event_log() is not tt.get_event_log()
    finally:
        tt.configure()
    assert tt.emit("ignored") is None


# -- fit(event_log=) -----------------------------------------------------------
SOLVER = dict(name="cg", tolerance=0.01, max_epochs=30, precond_rank=0,
              record_history=16)
COMMON = dict(estimator="pathwise", warm_start=True, num_probes=4,
              num_rff_pairs=64, num_steps=4, bm=64, bn=64)


def _np_params(p):
    return {"raw_lengthscales": np.asarray(p.raw_lengthscales),
            "raw_signal": np.asarray(p.raw_signal),
            "raw_noise": np.asarray(p.raw_noise), "kernel": p.kernel}


def _np_state(st):
    pr = st.probes
    return {"params": _np_params(st.params),
            "adam": {"step": np.asarray(st.adam.step),
                     "mu": _np_params(st.adam.mu),
                     "nu": _np_params(st.adam.nu)},
            "probes": {"estimator": pr.estimator, "z": None,
                       "rff": {"z": np.asarray(pr.rff.z),
                               "u": np.asarray(pr.rff.u),
                               "w": np.asarray(pr.rff.w), "kind": pr.rff.kind},
                       "w_eps": np.asarray(pr.w_eps)},
            "carry_v": np.asarray(st.carry_v), "step": np.asarray(st.step)}


def _events(buf, kind):
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if json.loads(line)["kind"] == kind]


@pytest.mark.parametrize("budget", [False, True], ids=["fixed", "budgeted"])
def test_fit_event_log_matches_reference(budget):
    """``fit(event_log=)`` emits the reference's ``solve_step`` events (and
    ``budget_decision`` under a budget policy, and ``fit_done``) for the
    same fit: the same keys, steps, solver, lane, iterations and ring
    lengths; residuals, epochs and budget numbers within rtol 1e-3. The
    fixed fit runs 6 CG iterations a step (tolerance 0), the budgeted one
    runs to tolerance 0.05 under the controller."""
    x, y = make_gp_regression(jax.random.PRNGKey(2), 64, 2, noise=0.3)
    solver = ({**SOLVER, "tolerance": 0.05} if budget else
              {**SOLVER, "tolerance": 0.0, "max_epochs": 6})
    jcfg = JOuterConfig(solver=JSolverConfig(**solver), backend="streamed",
                        **COMMON)
    tcfg = OuterConfig(solver=SolverConfig(**solver), backend="cuda", **COMMON)
    key = jax.random.PRNGKey(5)
    kw = dict(floor=2.0, ceiling=12.0, margin=2.0)
    jbuf, tbuf = io.StringIO(), io.StringIO()
    j_fit(x, y, jcfg, key=key, event_log=jt.EventLog(stream=jbuf),
          budget_policy=ja.make_budget_policy(**kw) if budget else None)
    state = interop.outer_state_from_numpy(_np_state(j_init(key, jcfg, x)))
    fit(torch.tensor(np.asarray(x)), torch.tensor(np.asarray(y)), tcfg,
        state=state, event_log=tt.EventLog(stream=tbuf), steps_per_round=3,
        budget_policy=ta.make_budget_policy(**kw) if budget else None)
    kinds = ["solve_step", "fit_done"] + (["budget_decision"] if budget else [])
    for kind in kinds:
        je, te = _events(jbuf, kind), _events(tbuf, kind)
        assert len(je) == len(te) == (1 if kind == "fit_done" else 4), kind
        for a, b in zip(te, je):
            assert set(a) == set(b), (kind, set(a) ^ set(b))
            for name, want in b.items():
                if name in ("ts", "wall_time_s", "solver_time_s",
                            "step_time_s"):
                    continue
                got = a[name]
                if name == "res_history":
                    assert len(got) == len(want)
                    np.testing.assert_allclose(got, want, rtol=RTOL)
                elif isinstance(want, float):
                    np.testing.assert_allclose(got, want, rtol=RTOL,
                                               err_msg=f"{kind}.{name}")
                else:
                    assert got == want, (kind, name, got, want)


def test_fit_batch_event_log_is_lane_tagged():
    """Port only: fit_batch's events carry each lane's number and agree
    with that lane's history."""
    x, y = make_gp_regression(jax.random.PRNGKey(2), 64, 2, noise=0.3)
    tcfg = OuterConfig(solver=SolverConfig(**SOLVER), backend="cuda", **COMMON)
    buf = io.StringIO()
    results = fit_batch(torch.tensor(np.asarray(x)),
                        torch.tensor(np.asarray(y)), tcfg, [1, 2],
                        event_log=tt.EventLog(stream=buf))
    events = _events(buf, "solve_step")
    assert len(events) == 2 * COMMON["num_steps"]
    for lane, res in enumerate(results):
        mine = [e for e in events if e["lane"] == lane]
        assert [e["step"] for e in mine] == list(range(COMMON["num_steps"]))
        assert [e["iters"] for e in mine] == res.history["iters"].tolist()
        np.testing.assert_allclose([e["res_y"] for e in mine],
                                   res.history["res_y"], rtol=1e-6)


# -- launch counters -----------------------------------------------------------
def test_launch_counters_lose_nothing_across_threads():
    """More threads than cores, with a 1 us switch interval, counting 3000
    launches each (every third with a second pass, every other forward one
    through the warp-specialised loop) through the kernels' counter
    function: the counts are exact. (CPython with the GIL does not switch
    threads inside the counter's dict ``+=``, so the same test passes
    without the lock there; the lock is what keeps the counts exact where
    the interpreter gives no such guarantee, e.g. free-threaded builds.)"""
    tiled.reset_launch_counts()
    per, threads = 3000, 2 * (os.cpu_count() or 4) + 1
    interval = sys.getswitchinterval()

    def work():
        for i in range(per):
            tiled.count_launch(tiled.KERNEL_NAME, second_pass=i % 3 == 0,
                               path=tiled.WS_KERNEL_NAME if i % 2 else None)
            tiled.count_launch(tiled.BWD_KERNEL_NAME)

    pool = [threading.Thread(target=work) for _ in range(threads)]
    sys.setswitchinterval(1e-6)
    try:
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    try:
        assert tiled.launch_counts() == {
            tiled.KERNEL_NAME: per * threads,
            tiled.WS_KERNEL_NAME: threads * len(range(1, per, 2)),
            tiled.BWD_KERNEL_NAME: per * threads}
        assert tiled.second_pass_counts() == {
            tiled.KERNEL_NAME: threads * len(range(0, per, 3)),
            tiled.WS_KERNEL_NAME: threads * len(range(3, per, 6)),
            tiled.BWD_KERNEL_NAME: 0}
    finally:
        tiled.reset_launch_counts()
    assert set(tiled.launch_counts().values()) == {0}
    assert set(tiled.second_pass_counts().values()) == {0}
