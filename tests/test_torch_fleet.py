"""The port's fleet observability plane (``repro_torch.obs.scrape``,
``repro_torch.obs.slo``, ``repro_torch.serve.cluster.monitor``) and the
serve CLI's HTTP modes against the JAX package's.

The exposition parser and renderer on the same registry calls (adversarial
label escapes included) and on the ``/metrics`` text each package's front-end
serves; the fleet scraper and the SLO engine of each package on the same
scraped texts, deaths and injected clock (burn rates, WARN/PAGE transitions,
alert events and gauges equal); the reference's ``tools/trace_report.py
--fleet`` on the port's request and monitor logs; the serve CLI's in-process
``--http-smoke --metrics`` next to the reference CLI's; and the CLI's fleet
smoke with two CPU worker processes, the monitor and a kill. Equal means
equal: every number here is the same float arithmetic in both packages.
"""
import io
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.gp.hyperparams import HyperParams as JHyperParams  # noqa: E402
from repro.gp.rff import RFFState as JRFFState  # noqa: E402
from repro.obs import metrics as jm  # noqa: E402
from repro.obs import scrape as jscrape  # noqa: E402
from repro.obs import slo as jslo  # noqa: E402
from repro.obs import trace as jt  # noqa: E402
from repro.serve import BucketedEngine as JEngine  # noqa: E402
from repro.serve import ServableGP as JServable  # noqa: E402
from repro.serve import cluster as jc  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.obs import metrics as tm  # noqa: E402
from repro_torch.obs import scrape as tscrape  # noqa: E402
from repro_torch.obs import slo as tslo  # noqa: E402
from repro_torch.obs import trace as tt  # noqa: E402
from repro_torch.serve import BucketedEngine  # noqa: E402
from repro_torch.serve import cluster as tc  # noqa: E402
from repro_torch.serve.cluster.monitor import FleetMonitor  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

ADVERSARIAL_LABELS = [
    'plain',
    'with"quote',
    "back\\slash",
    "new\nline",
    'all\\three" \n mixed',
    '\\n literal-backslash-n',
    'trailing\\',
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensor ops: one intra-op thread beside the other workers of a
    parallel run (restored after)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _norm(families) -> dict:
    """Parsed families as comparable plain data (NaN samples dropped)."""
    return {name: (f.kind, f.help, sorted(
        (s.name, tuple(sorted(s.labels.items())), s.value)
        for s in f.samples if not math.isnan(s.value)))
        for name, f in families.items()}


def _drive(mod, reg):
    """One fixed sequence of instrument calls (adversarial labels, all
    kinds) on a registry of package ``mod``."""
    c = reg.counter("gp_req_total", 'Requests "by" path\\ and\nline',
                    labelnames=("path",))
    g = reg.gauge("gp_depth", "Queue depth", labelnames=("who",))
    h = reg.histogram("gp_lat_seconds", "Latency", labelnames=("route",))
    for i, label in enumerate(ADVERSARIAL_LABELS):
        c.inc(i + 0.5, path=label)
        g.set(-i * 1.25, who=label)
        g.set_ewma(i * 2.0, who=label + "-ewma")
        for v in (0.0004, 0.003, 0.2, 7.0, 1e9):
            h.observe(v * (i + 1), route=label)
    reg.counter("gp_plain_total", "no labels").inc(3)
    reg.gauge("gp_special", "specials").set(math.inf)


def test_parse_render_round_trip_matches_reference():
    """Both renderers give one text; both parsers read it to the same
    families, each the exact inverse of the renderer; render_families and
    a re-parse agree, with and without the replica label."""
    treg, jreg = tm.MetricsRegistry(), jm.MetricsRegistry()
    _drive(tm, treg)
    _drive(jm, jreg)
    text = treg.render()
    assert text == jreg.render()
    tf, jf = tscrape.parse_prometheus(text), jscrape.parse_prometheus(text)
    assert _norm(tf) == _norm(jf)
    assert len(tf) == 5 and tf["gp_lat_seconds"].kind == "histogram"
    for extra in (None, ("replica", 'r"0\\\n')):
        lines = tscrape.render_families(tf, extra_label=extra)
        assert lines == jscrape.render_families(jf, extra_label=extra)
    again = tscrape.parse_prometheus(
        "\n".join(tscrape.render_families(tf)) + "\n")
    assert _norm(again) == _norm(tf)
    labelled = tscrape.parse_prometheus("\n".join(lines) + "\n")
    assert all(s.labels["replica"] == 'r"0\\\n'
               for f in labelled.values() for s in f.samples)


@pytest.mark.parametrize("value", ADVERSARIAL_LABELS)
def test_unescape_matches_reference(value):
    esc = tm.escape_label_value(value)
    assert esc == jm.escape_label_value(value)
    assert tscrape.unescape_label_value(esc) == value
    assert jscrape.unescape_label_value(esc) == value
    help_esc = tm.escape_help(value)
    assert tscrape.unescape_help(help_esc) == jscrape.unescape_help(help_esc)


@pytest.mark.parametrize("token", ["+Inf", "-Inf", "NaN", "1.5e-3", "42",
                                   "bogus"])
def test_parse_value_matches_reference(token):
    try:
        want = jscrape.parse_value(token)
    except ValueError:
        with pytest.raises(ValueError):
            tscrape.parse_value(token)
        return
    got = tscrape.parse_value(token)
    assert (math.isnan(got) and math.isnan(want)) or got == want


@pytest.mark.parametrize("line", [
    'x{a="1" 3', 'x{a=1} 3', 'x{="1"} 3', 'x{a="1",,} 3', "x", '{a="1"} 3',
])
def test_malformed_lines_raise_like_reference(line):
    with pytest.raises(ValueError) as je:
        jscrape.parse_prometheus(line + "\n")
    with pytest.raises(ValueError) as te:
        tscrape.parse_prometheus(line + "\n")
    assert str(te.value) == str(je.value)


def _artifacts(d=3, n=48, s=4, m=16, seed=0):
    """One random servable in both packages (no fit needed for the wire)."""
    rng = np.random.default_rng(seed)
    tree = {"x": rng.normal(size=(n, d)).astype(np.float32),
            "correction": rng.normal(size=(n, 1 + s)).astype(np.float32),
            "rff": {"z": rng.normal(size=(m, d)).astype(np.float32),
                    "u": rng.chisquare(3, size=m).astype(np.float32),
                    "w": rng.normal(size=(2 * m, s)).astype(np.float32),
                    "kind": "matern32"},
            "params": {"raw_lengthscales": np.zeros(d, np.float32),
                       "raw_signal": np.float32(0.5),
                       "raw_noise": np.float32(-1.0), "kernel": "matern32"},
            "kind": "matern32"}
    j = JServable(x=jnp.asarray(tree["x"]),
                  correction=jnp.asarray(tree["correction"]),
                  rff=JRFFState(*(jnp.asarray(tree["rff"][k])
                                  for k in "zuw"), kind="matern32"),
                  params=JHyperParams(*(jnp.asarray(tree["params"][k]) for k in
                                        ("raw_lengthscales", "raw_signal",
                                         "raw_noise")), kernel="matern32"),
                  kind="matern32")
    return j, interop.servable_from_numpy(tree), tree["x"]


def test_served_metrics_text_parses_like_reference():
    """The ``/metrics`` text each package's front-end renders after the same
    requests: each parser reads both texts to the same families, the
    render/parse round trip is exact, and the HTTP stack's families carry
    the same kinds and labels."""
    jmodel, tmodel, x = _artifacts()
    texts = []
    for mod, engine in ((jc, JEngine(jmodel, buckets=(8,), bm=64, bn=64)),
                        (tc, BucketedEngine(tmodel, buckets=(8,)))):
        kw = {} if mod is jc else {"device": "cpu"}
        frontend = mod.ServeFrontend(engine, **kw)
        for rows in (1, 3, 8):
            status, _, _ = frontend.predict({"x": x[:rows].tolist()})
            frontend.observe_request("/predict", status, 0.002 * rows)
        frontend.observe_request("/nope", 404, 0.001)
        texts.append(frontend.metrics()[1])
    for text in texts:
        tf, jf = tscrape.parse_prometheus(text), jscrape.parse_prometheus(text)
        assert _norm(tf) == _norm(jf)
        assert _norm(tscrape.parse_prometheus(
            "\n".join(tscrape.render_families(tf)) + "\n")) == _norm(tf)

    def shape(text):
        fams = tscrape.parse_prometheus(text)
        return {n: (f.kind, sorted({tuple(sorted(k for k in s.labels
                                                 if k != "le"))
                                    for s in f.samples}))
                for n, f in fams.items()
                if n.startswith(("gp_http_", "gp_admission_", "gp_engine_"))}

    assert shape(texts[1]) == shape(texts[0])
    assert "gp_http_requests_total" in shape(texts[1])


# -- the scraper and the SLO engine on the same texts and clock --------------
def _replica_text(mod, good, bad, slow):
    """A replica's exposition: ``good`` 200s, ``bad`` 500s, and latencies
    (``slow`` of them past 250 ms) in package ``mod``'s renderer."""
    reg = mod.MetricsRegistry()
    c = reg.counter("gp_http_requests_total", "HTTP requests by route and "
                    "status", labelnames=("path", "status"))
    h = reg.histogram("gp_http_request_seconds", "HTTP request latency by "
                      "route", labelnames=("path",))
    if good:
        c.inc(good, path="/predict", status="200")
    if bad:
        c.inc(bad, path="/predict", status="500")
    for i in range(good + bad):
        h.observe(0.6 if i < slow else 0.01 * (1 + i % 5), path="/predict")
    reg.gauge("gp_engine_queue_depth", "Requests waiting").set(good % 3)
    return reg.render()


class _Fleet:
    """The replicas' texts and /stats by name; dead replicas refuse."""

    def __init__(self):
        self.texts, self.stats, self.dead = {}, {}, set()

    def fetch(self, url, timeout):
        name, _, route = url.partition("://")[2].partition("/")
        if name in self.dead:
            raise OSError("connection refused")
        if route == "metrics":
            return self.texts[name].encode()
        if route == "stats":
            return json.dumps(self.stats[name]).encode()
        raise OSError(f"404 {route}")


# (seconds, {replica: (good, bad, slow) cumulative or "dead"})
FLEET_SCRIPT = [
    (0.0, {"r0": (100, 0, 0), "r1": (80, 0, 0)}),
    (1.0, {"r0": (195, 5, 5), "r1": (175, 3, 1)}),
    (2.0, {"r0": (170, 130, 60), "r1": (150, 60, 40)}),
    (3.0, {"r0": (175, 230, 150), "r1": "dead"}),
    (4.0, {"r0": (275, 230, 150), "r1": "dead"}),
    (6.0, {"r0": (475, 230, 150), "r1": "dead"}),
    (9.0, {"r0": (775, 230, 150), "r1": (400, 60, 40)}),
    (14.0, {"r0": (1275, 230, 150), "r1": (900, 60, 40)}),
    (40.0, {"r0": (2000, 230, 150), "r1": "dead"}),
    (60.0, {"r0": (3000, 230, 150), "r1": "dead"}),
]
TIMING_FAMILIES = ("gp_fleet_scrape_duration_ms", "gp_fleet_last_scrape_ts")


def _stable_render(text):
    return [line for line in text.splitlines()
            if not any(f in line for f in TIMING_FAMILIES)]


def _health(h):
    return {n: {k: v for k, v in e.items() if k != "last_ok_ts"}
            for n, e in h.items()}


def test_scraper_and_slo_engine_match_reference():
    """Both packages' scrapers and SLO engines over the same replica texts
    (half rendered by each package), deaths, TTL expiry and injected clock:
    the same scrape results, aggregate exposition, health, totals, burn
    rates, states, transitions, alert events and ``gp_slo_*`` gauges."""
    fleet = _Fleet()
    clock = {"t": 0.0}
    streams = {"ref": io.StringIO(), "port": io.StringIO()}
    sides = {}
    for side, sc, slo, trace in (("ref", jscrape, jslo, jt),
                                 ("port", tscrape, tslo, tt)):
        scraper = sc.FleetScraper(
            targets={"r0": "fake://r0", "r1": "fake://r1"},
            stale_after_misses=2, ttl_s=10.0, clock=lambda: clock["t"],
            fetch=fleet.fetch)
        rules = [slo.BurnRateRule(slo.PAGE, 10.0, 2.0, 6.0),
                 slo.BurnRateRule(slo.WARN, 2.0, 2.0, 6.0)]
        engine = slo.SLOEngine(
            scraper,
            [slo.AvailabilitySLO(objective=0.99, rules=list(rules)),
             slo.LatencySLO(objective=0.97, threshold_s=0.25,
                            path="/predict", rules=list(rules))],
            event_log=trace.EventLog(stream=streams[side]),
            clock=lambda: clock["t"])
        sides[side] = (scraper, engine)
    states = set()
    for i, (t, replicas) in enumerate(FLEET_SCRIPT):
        clock["t"] = t
        fleet.dead = {n for n, v in replicas.items() if v == "dead"}
        for n, v in replicas.items():
            if v != "dead":
                mod = tm if (i + int(n[1])) % 2 else jm
                fleet.texts[n] = _replica_text(mod, *v)
                fleet.stats[n] = {"admission": {"admitted": v[0], "shed": v[1],
                                                "service_ewma_ms": 1.0 + i,
                                                "inflight": i % 2},
                                  "engine": {"requests": v[0] + v[1]},
                                  "draining": False, "version": f"v{i}"}
        (js, je), (ts, te) = sides["ref"], sides["port"]
        assert ts.scrape_once() == js.scrape_once()
        jstatus, tstatus = je.evaluate(), te.evaluate()
        for status in (jstatus, tstatus):
            for entry in status.values():
                entry.pop("last_transition_ts")
        assert tstatus == jstatus, t
        states |= {e["state"] for e in tstatus.values()}
        assert _stable_render(ts.render()) == _stable_render(js.render())
        assert _health(ts.health()) == _health(js.health())
        for fam in ("gp_http_requests_total", "gp_nope_total"):
            assert ts.counter_total(fam) == js.counter_total(fam)
        assert ts.histogram_cumulative("gp_http_request_seconds") == \
            js.histogram_cumulative("gp_http_request_seconds")
        assert ts.scrape_totals() == js.scrape_totals()
        assert ts.up_fraction() == js.up_fraction()
        assert te.worst_state() == je.worst_state()
        assert te.registry.render() == je.registry.render()
    assert {"OK", "WARN", "PAGE"} <= states

    def transitions(stream):
        return [(e["slo"], e["from_state"], e["to_state"], e["burn_rates"])
                for e in map(json.loads, stream.getvalue().splitlines())]

    assert transitions(streams["port"]) == transitions(streams["ref"])
    assert len(transitions(streams["port"])) >= 3
    for side in sides.values():
        side[0].set_targets({"r0": "fake://r0"})
    assert _stable_render(sides["port"][0].render()) == _stable_render(
        sides["ref"][0].render())


# -- the monitor's logs through the reference's trace_report -----------------
def test_trace_report_reads_the_ports_fleet_logs(tmp_path):
    """An in-process replica of the port logging its requests, a monitor
    over it logging alerts, the replica shut down until the availability SLO
    pages: the reference's ``tools/trace_report.py --fleet`` merges the
    port's logs into one timeline with the request's trace and the PAGE."""
    _, tmodel, x = _artifacts()
    logs = tmp_path / "fleet-logs"
    tt.configure(path=str(logs / "replica_0.jsonl"))
    frontend = tc.ServeFrontend(BucketedEngine(tmodel, buckets=(8,)),
                                device="cpu")
    httpd, _ = tc.start_http_server(frontend)
    url = f"http://127.0.0.1:{httpd.port}"
    clock = {"t": 0.0}
    monitor = FleetMonitor(
        targets={"replica_0": url}, interval_s=0.5,
        slos=[tslo.AvailabilitySLO(objective=0.99,
                                   rules=tslo.default_rules(3.0, 9.0))],
        event_log=tt.EventLog(path=str(logs / "monitor.jsonl")),
        clock=lambda: clock["t"], timeout_s=2.0)
    try:
        import urllib.request

        req = urllib.request.Request(
            url + "/predict", data=json.dumps({"x": x[:2].tolist()}).encode(),
            headers={"Content-Type": "application/json",
                     "X-Trace-Id": "tr-port-fleet"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.status == 200
        for _ in range(3):
            monitor.tick()
            clock["t"] += 1.0
        assert monitor.fleet_slo()["slos"]["availability"]["state"] == "OK"
    finally:
        httpd.shutdown()
        httpd.server_close()
        tt.configure()
    for _ in range(6):
        monitor.tick()
        clock["t"] += 1.0
    assert monitor.fleet_slo()["worst_state"] == "PAGE"
    assert not monitor.fleet_health()["replicas"]["replica_0"]["up"]
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / "trace_report.py"), "--fleet",
         str(logs)], capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr
    assert "fleet timeline" in out.stdout
    assert "-> PAGE" in out.stdout, out.stdout
    assert "tr-port-fleet" in out.stdout


# -- the serve CLI ------------------------------------------------------------
_SMOKE = re.compile(r"^\[(http|obs)-smoke\]")


def _smoke_lines(out: str) -> list:
    """The probes' lines with endpoints, line counts and the flood's codes
    masked (which of the flood's requests a 1/s bucket admits depends on
    the host's speed; the probe checked them before it printed the line)."""
    lines = [line for line in out.splitlines() if _SMOKE.match(line)]
    masked = []
    for line in lines:
        line = re.sub(r"http://127\.0\.0\.1:\d+", "EP", line)
        line = re.sub(r"\(\d+ lines\)", "(N lines)", line)
        match = re.search(r"codes=(\[[\d, ]+\]) .* shed=(\d+) ", line)
        if match:
            codes = json.loads(match.group(1))
            assert 429 in codes and int(match.group(2)) == codes.count(429)
            line = line.replace(match.group(1), "CODES").replace(
                f"shed={match.group(2)}", "shed=N")
        masked.append(line)
    return masked


def test_serve_cli_http_smoke_matches_reference(capsys):
    """``--http 127.0.0.1:0 --http-smoke --metrics`` (rate 1/s, burst 2):
    the port's CLI on the CPU prints the reference CLI's probe lines — the
    same health, predict, flood verdict, Retry-After and trace echo."""
    from repro.launch import serve as jserve

    flags = ["--max-n", "256", "--train-steps", "2", "--buckets", "8,32",
             "--http", "127.0.0.1:0", "--admission-qps", "1",
             "--admission-burst", "2", "--http-smoke", "--metrics"]
    jserve.main(flags)
    want = _smoke_lines(capsys.readouterr().out)
    tserve.main(["--device", "cpu", "--num-probes", "32", *flags])
    got = _smoke_lines(capsys.readouterr().out)
    assert len(want) == 3 and got == want


def test_serve_cli_fleet_smoke_two_cpu_workers(tmp_path, capsys, monkeypatch):
    """``--replicas 2 --artifact-store --monitor --fleet-smoke`` on the CPU:
    two spawned workers behind the monitor pass the whole fleet probe (the
    aggregate equals the replicas' counters, health matches /stats, a kill
    marks the replica down and pages), and the request and monitor logs
    land per replica."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    store, logs = tmp_path / "store", tmp_path / "logs"
    t0 = time.monotonic()
    tserve.main(["--device", "cpu", "--max-n", "256", "--train-steps", "2",
                 "--num-probes", "8", "--buckets", "8,32", "--http",
                 "127.0.0.1:0", "--replicas", "2", "--artifact-store",
                 str(store), "--monitor", "127.0.0.1:0", "--fleet-smoke",
                 "--request-log", str(logs)])
    out = capsys.readouterr().out
    assert "[fleet-smoke] 2 replicas up on /fleet/health" in out
    assert "[fleet-smoke] /fleet/metrics == per-replica /metrics: " \
        "{'replica_0': 5.0, 'replica_1': 5.0}" in out
    assert "replica_1 marked down" in out and "availability PAGE" in out
    assert sorted(os.listdir(logs)) == ["monitor.jsonl", "replica_0.jsonl",
                                        "replica_1.jsonl"]
    alerts = [json.loads(line) for line in open(logs / "monitor.jsonl")]
    assert any(e["kind"] == "slo_alert" and e["to_state"] == "PAGE"
               for e in alerts)
    assert tc.list_versions(str(store)) == ["v0000001"]
    assert time.monotonic() - t0 < 120
