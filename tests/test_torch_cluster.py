"""The port's cluster serving layer (``repro_torch.serve.cluster``) against the
JAX package's ``repro.serve.cluster``: admission decisions, the versioned
artifact store in both directions, the in-process HTTP front-end of each
package side by side on the same model and requests, the artifact poller,
the twin of ``test_concurrent_swap_during_enqueue``, and the supervised
replica processes (one CPU worker through v1, v2 and a respawn; a worker
asked for a card that is absent).

Inputs are ``tests/test_cluster.py``'s fixture: 128 fitted rows in 2-D, 8
probes, 64 RFF pairs, ``bm = bn = 64``; the reference fits and exports, and
the port serves the same artifact, carried across by
``repro_torch.interop.servable_from_numpy`` or read from a store the
reference published. Bounds: predictions rtol 1e-4 / atol 1e-6 (the port
runs its forward kernel's plain version on these CPU tensors, the reference
its jitted tiles); decisions, retry hints, status codes, error texts,
headers, versions and key sets equal.
"""
import functools
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import OuterConfig as JOuterConfig  # noqa: E402
from repro.core import init_outer_state as j_init  # noqa: E402
from repro.core import outer_step as j_step  # noqa: E402
from repro.data.synthetic import make_gp_regression  # noqa: E402
from repro.obs import metrics as jm  # noqa: E402
from repro.serve import BucketedEngine as JEngine  # noqa: E402
from repro.serve import MultiModelServer as JServer  # noqa: E402
from repro.serve import OnlineGP as JOnline  # noqa: E402
from repro.serve import export_servable as j_export  # noqa: E402
from repro.serve import servable_predict as j_predict  # noqa: E402
from repro.serve import cluster as jc  # noqa: E402
from repro.solvers import SolverConfig as JSolverConfig  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.outer import OuterConfig  # noqa: E402
from repro_torch.kernels import tiled  # noqa: E402
from repro_torch.obs import metrics as tm  # noqa: E402
from repro_torch.serve import BucketedEngine, MultiModelServer  # noqa: E402
from repro_torch.serve import OnlineGP, servable_predict  # noqa: E402
from repro_torch.serve import cluster as tc  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from repro_torch.serve.cluster.replica import _http_json  # noqa: E402
from repro_torch.solvers import SolverConfig  # noqa: E402

PRED_RTOL, PRED_ATOL = 1e-4, 1e-6
BUCKETS = (8, 32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensor ops: one intra-op thread beside the other workers of a
    parallel run (restored after)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_params(p):
    return {"raw_lengthscales": np.asarray(p.raw_lengthscales),
            "raw_signal": np.asarray(p.raw_signal),
            "raw_noise": np.asarray(p.raw_noise), "kernel": p.kernel}


def _np_servable(m):
    return {"x": np.asarray(m.x), "correction": np.asarray(m.correction),
            "rff": {"z": np.asarray(m.rff.z), "u": np.asarray(m.rff.u),
                    "w": np.asarray(m.rff.w), "kind": m.rff.kind},
            "params": _np_params(m.params), "kind": m.kind}


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


def _leaves(m) -> list:
    """A servable's arrays in the reference's leaf order, as numpy."""
    return [np.asarray(a) for a in (
        m.x, m.correction, m.rff.z, m.rff.u, m.rff.w, m.params.raw_lengthscales,
        m.params.raw_signal, m.params.raw_noise)]


@pytest.fixture(scope="module")
def fitted():
    """``tests/test_cluster.py``'s fit, exported by the reference and
    carried across to the port."""
    x, y = make_gp_regression(jax.random.PRNGKey(0), 160, 2, noise=0.2)
    xq = x[128:]
    x, y = x[:128], y[:128]
    solver = dict(name="cg", max_epochs=200, precond_rank=0)
    common = dict(estimator="pathwise", warm_start=True, num_probes=8,
                  num_rff_pairs=64, num_steps=2, bm=64, bn=64)
    jcfg = JOuterConfig(solver=JSolverConfig(**solver), **common)
    state = j_init(jax.random.PRNGKey(1), jcfg, x)
    for _ in range(jcfg.num_steps):
        state, _ = j_step(state, x, y, jcfg)
    jmodel = j_export(state, x)
    tmodel = interop.servable_from_numpy(_np_servable(jmodel))
    return {"x": x, "y": y, "xq": np.asarray(xq), "jcfg": jcfg,
            "tcfg": OuterConfig(solver=SolverConfig(**solver),
                                backend="cuda", **common),
            "state": state, "jmodel": jmodel, "tmodel": tmodel}


def _double(model):
    return model._replace(correction=model.correction * 2)


# -- admission ---------------------------------------------------------------
# (kwargs of both controllers, [(op, args)]): "admit" (rows, deadline_ms,
# priority, now) or "release" (service_s).
ADMISSION_CASES = {
    "rate": (dict(buckets=(8, 32), rate_qps=1.0, burst=2.0, max_inflight=100),
             [("admit", (4, None, "predict", 50.0))] * 3
             + [("admit", (20, None, "predict", 50.0)),
                ("admit", (4, None, "predict", 50.4)),
                ("admit", (4, None, "predict", 51.2)),
                ("admit", (40, None, "predict", 51.2))]),
    "inflight": (dict(max_inflight=2),
                 [("admit", (1, None, "predict", 1.0))] * 3
                 + [("release", 0.01), ("admit", (1, None, "predict", 2.0)),
                    ("admit", (1, None, "predict", 2.0))]),
    "deadline": (dict(max_inflight=100),
                 [("admit", (1, None, "predict", 1.0))] * 2
                 + [("release", 2.0), ("admit", (1, 100, "predict", 2.0)),
                    ("admit", (1, 60_000, "predict", 2.0)),
                    ("release", 0.5), ("release", None),
                    ("admit", (1, 1500, "predict", 3.0))]),
    "priority": (dict(rate_qps=0.001, burst=1.0, max_inflight=1),
                 [("admit", (1, None, "predict", 5.0)),
                  ("admit", (1, None, "predict", 5.0)),
                  ("admit", (1, None, "refresh", 5.0)),
                  ("admit", (1, None, "admin", 5.0)),
                  ("admit", (1, None, "predict", 9.0))]),
}


@pytest.mark.parametrize("case", sorted(ADMISSION_CASES))
def test_admission_decisions_match_reference(case):
    """One (rows, deadline, priority, now) sequence through both
    controllers: the same decisions, reasons, retry hints, inflight counts
    and ``as_dict()`` counters."""
    kw, ops = ADMISSION_CASES[case]
    j = jc.AdmissionController(registry=jm.NULL_REGISTRY, **kw)
    t = tc.AdmissionController(registry=tm.NULL_REGISTRY, **kw)
    for op, args in ops:
        if op == "release":
            j.release(args)
            t.release(args)
            continue
        rows, deadline, prio, now = args
        dj = j.admit(rows=rows, deadline_ms=deadline, now=now,
                     priority=jc.parse_priority(prio))
        dt = t.admit(rows=rows, deadline_ms=deadline, now=now,
                     priority=tc.parse_priority(prio))
        assert (dt.admitted, dt.reason, dt.retry_after_s) == (
            dj.admitted, dj.reason, dj.retry_after_s), (op, args)
        assert t.inflight == j.inflight
    assert t.stats.as_dict() == j.stats.as_dict()
    a, b = t.as_dict(), j.as_dict()
    assert sorted(a) == sorted(b)
    assert {k: v for k, v in a.items() if k != "bucket_tokens"} == {
        k: v for k, v in b.items() if k != "bucket_tokens"}
    assert sorted(a["bucket_tokens"]) == sorted(b["bucket_tokens"])


def test_priority_parsing_and_token_bucket_match_reference():
    for name in ("predict", "REFRESH", "Admin"):
        assert tc.parse_priority(name).value == jc.parse_priority(name).value
    with pytest.raises(ValueError) as te:
        tc.parse_priority("bogus")
    with pytest.raises(ValueError) as je:
        jc.parse_priority("bogus")
    assert str(te.value) == str(je.value)
    tb, jb = tc.TokenBucket(rate=2.0, burst=3.0), jc.TokenBucket(2.0, 3.0)
    for now in (100.0, 100.0, 100.0, 100.0, 100.5, 100.6, 103.0):
        assert tb.try_acquire(now=now) == jb.try_acquire(now=now)
        assert tb.available(now) == jb.available(now)


# -- artifact store ----------------------------------------------------------
def test_store_reference_publishes_port_fetches(tmp_path, fitted):
    """A store the reference published is listed, fetched and verified by the
    port, bitwise, onto the CPU; an old version stays readable."""
    store = str(tmp_path)
    assert tc.latest_version(store) is None
    v1 = jc.publish_servable(store, fitted["jmodel"], name="pol")
    v2 = jc.publish_servable(store, _double(fitted["jmodel"]))
    assert tc.list_versions(store) == jc.list_versions(store) == [v1, v2]
    assert tc.latest_version(store) == v2
    model, version, manifest = tc.fetch_servable(store, v1, device="cpu")
    assert version == v1 and manifest == jc.read_manifest(store, v1)
    assert manifest["name"] == "pol" and model.x.device.type == "cpu"
    for a, b in zip(_leaves(model), _leaves(fitted["jmodel"])):
        np.testing.assert_array_equal(a, b)
    latest, version, _ = tc.fetch_servable(store, device="cpu")
    assert version == v2
    np.testing.assert_array_equal(latest.correction.numpy(),
                                  2 * np.asarray(fitted["jmodel"].correction))


def test_store_port_publishes_reference_fetches(tmp_path, fitted):
    """A store the port published has the reference's layout and manifest,
    and the reference fetches and verifies it bitwise."""
    tstore, jstore = str(tmp_path / "t"), str(tmp_path / "j")
    v1 = tc.publish_servable(tstore, fitted["tmodel"], name="pol",
                             extra_metadata={"by": "port"})
    jc.publish_servable(jstore, fitted["jmodel"], name="pol")
    assert sorted(os.listdir(tstore)) == sorted(os.listdir(jstore))
    assert sorted(os.listdir(os.path.join(tstore, v1))) == sorted(
        os.listdir(os.path.join(jstore, v1)))
    tm_, jm_ = tc.read_manifest(tstore, v1), jc.read_manifest(jstore, v1)
    assert sorted(tm_) == sorted(jm_ | {"by": 0})
    assert sorted(tm_["files"]) == sorted(jm_["files"])
    model, version, manifest = jc.fetch_servable(tstore)
    assert version == v1 and manifest["by"] == "port"
    for a, b in zip(_leaves(model), _leaves(fitted["tmodel"])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("publisher", ["reference", "port"])
def test_both_verifiers_reject_a_corrupted_store(tmp_path, fitted, publisher):
    store = str(tmp_path)
    if publisher == "reference":
        v1 = jc.publish_servable(store, fitted["jmodel"])
    else:
        v1 = tc.publish_servable(store, fitted["tmodel"])
    payload = os.path.join(store, v1, "step_0.npz")
    with open(payload, "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01\x02\x03")
    with pytest.raises(ValueError, match="hash mismatch") as te:
        tc.fetch_servable(store, device="cpu")
    with pytest.raises(ValueError, match="hash mismatch") as je:
        jc.fetch_servable(store)
    assert str(te.value) == str(je.value)
    os.remove(payload)
    with pytest.raises(ValueError, match="missing") as te:
        tc.fetch_servable(store, device="cpu")
    with pytest.raises(ValueError, match="missing") as je:
        jc.fetch_servable(store)
    assert str(te.value) == str(je.value)


def _count_dispatches(monkeypatch):
    """Count the port engine's servable_predict calls; fail any kernel
    build or library load."""
    calls = []
    real = t_engine.servable_predict

    def counting(model, xq):
        calls.append(xq.shape[0])
        return real(model, xq)

    def refuse(*_a, **_k):
        raise AssertionError("the kernel library was built or loaded")

    monkeypatch.setattr(t_engine, "servable_predict", counting)
    monkeypatch.setattr(tiled, "build_kernels", refuse)
    monkeypatch.setattr(tiled, "_library", refuse)
    return calls


def test_poller_swaps_without_build_and_warms_like_reference(
        tmp_path, fitted, monkeypatch):
    """The poller fetches each new version, warms it with one dispatch per
    bucket (as many as the reference's warm-up dispatches), swaps without a
    kernel build or library load, and serves the new version."""
    store = str(tmp_path)
    jc.publish_servable(store, fitted["jmodel"])
    calls = _count_dispatches(monkeypatch)
    engine = BucketedEngine(None, buckets=BUCKETS)
    poller = tc.ArtifactPoller(store, engine, interval_s=60.0, device="cpu")
    assert poller.poll_once()
    warm = list(calls)
    xq = torch.tensor(fitted["xq"][:5])
    before = engine.submit(xq)
    jc.publish_servable(store, _double(fitted["jmodel"]))
    calls.clear()
    assert poller.poll_once()
    assert calls == warm == list(BUCKETS)
    after = engine.submit(xq)
    np.testing.assert_allclose(after.mean.numpy(), 2 * before.mean.numpy(),
                               rtol=1e-5)
    assert not poller.poll_once()
    assert poller.status() == {"version": "v0000002", "swaps": 2,
                               "last_error": None}

    jengine = JEngine(None, buckets=BUCKETS, bm=64, bn=64)
    jcalls = []
    real = jengine._predict

    def counting(model, xq, **kw):
        jcalls.append(xq.shape[0])
        return real(model, xq, **kw)

    jengine._predict = counting
    jserver = JServer(buckets=BUCKETS, engine=jengine)
    jserver.register("default", fitted["jmodel"], warmup=True)
    assert jcalls == warm


def test_poller_keeps_serving_after_a_failed_fetch(tmp_path, fitted):
    store = str(tmp_path)
    tc.publish_servable(store, fitted["tmodel"])
    server = MultiModelServer(buckets=BUCKETS)
    poller = tc.ArtifactPoller(store, server, interval_s=60.0, device="cpu")
    assert poller.poll_once() and server.names() == ("default",)
    v2 = tc.publish_servable(store, _double(fitted["tmodel"]))
    with open(os.path.join(store, v2, "step_0.npz"), "r+b") as f:
        f.write(b"garbage!")
    assert not poller.poll_once()
    status = poller.status()
    assert status["version"] == "v0000001" and "hash mismatch" in status[
        "last_error"]
    np.testing.assert_array_equal(server.get("default").correction.numpy(),
                                  fitted["tmodel"].correction.numpy())


# -- transport: each package's in-process server, side by side ---------------
def _start(pkg, store, fitted, **adm):
    """An in-process replica of one package over ``store`` (v1 fetched)."""
    if pkg == "reference":
        server = JServer(buckets=BUCKETS, bm=64, bn=64)
        admission = jc.AdmissionController(buckets=BUCKETS, **adm)
        frontend = jc.ServeFrontend(server, admission, store_dir=store)
        poller = jc.ArtifactPoller(store, server, interval_s=60.0)
        start = jc.start_http_server
    else:
        server = MultiModelServer(buckets=BUCKETS)
        admission = tc.AdmissionController(buckets=BUCKETS, **adm)
        frontend = tc.ServeFrontend(server, admission, store_dir=store,
                                    device="cpu")
        poller = tc.ArtifactPoller(store, server, interval_s=60.0,
                                   device="cpu")
        start = tc.start_http_server
    assert poller.poll_once()
    frontend.version = poller.status()["version"]
    httpd, _ = start(frontend)
    return {"url": f"http://127.0.0.1:{httpd.port}", "frontend": frontend,
            "httpd": httpd}


@pytest.fixture()
def servers(tmp_path, fitted):
    """Both packages' replicas over one store the reference published."""
    store = str(tmp_path / "store")
    jc.publish_servable(store, fitted["jmodel"])
    out = {pkg: _start(pkg, store, fitted) for pkg in ("reference", "port")}
    out["store"] = store
    yield out
    for pkg in ("reference", "port"):
        out[pkg]["httpd"].shutdown()
        out[pkg]["httpd"].server_close()


def _both(servers, path, payload=None, headers=None):
    """(status, body, headers) from each package's server."""
    out = {}
    for pkg in ("reference", "port"):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(
            servers[pkg]["url"] + path, data=data,
            headers={"Content-Type": "application/json", **(headers or {})},
            method="GET" if data is None else "POST")
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                status, raw, hdrs = resp.status, resp.read(), resp.headers
        except urllib.error.HTTPError as e:
            status, raw, hdrs = e.code, e.read(), e.headers
        text = raw.decode()
        try:
            body = json.loads(text)
        except json.JSONDecodeError:
            body = text
        out[pkg] = (status, body, hdrs)
    return out["reference"], out["port"]


def test_http_predict_matches_reference(servers, fitted):
    xq = fitted["xq"][:7]
    (js, jb, _), (ts, tb, _) = _both(servers, "/predict",
                                     {"x": xq.tolist(), "samples": True})
    assert js == ts == 200
    assert sorted(tb) == sorted(jb)
    for key in ("rows", "model", "version"):
        assert tb[key] == jb[key]
    for key in ("mean", "var", "samples"):
        np.testing.assert_allclose(tb[key], jb[key], rtol=PRED_RTOL,
                                   atol=PRED_ATOL)
    want = servable_predict(fitted["tmodel"], torch.tensor(xq))
    np.testing.assert_array_equal(np.float32(tb["mean"]), want.mean.numpy())
    np.testing.assert_array_equal(np.float32(tb["var"]), want.var.numpy())
    np.testing.assert_array_equal(np.float32(tb["samples"]),
                                  want.samples.numpy())


WIRE_ERRORS = {
    "missing_x": ("/predict", {}),
    "not_numeric": ("/predict", {"x": "nope"}),
    "ragged": ("/predict", {"x": [[0.1, 0.2], [0.3]]}),
    "non_finite": ("/predict", {"x": [[1.0, float("nan")]]}),
    "empty": ("/predict", {"x": []}),
    "deadline_negative": ("/predict", {"x": [[0.1, 0.2]], "deadline_ms": -5}),
    "priority_bogus": ("/predict", {"x": [[0.1, 0.2]], "priority": "bogus"}),
    "unknown_model": ("/predict", {"x": [[0.1, 0.2]], "model": "nope"}),
    "wrong_features": ("/predict", {"x": [[0.1, 0.2, 0.3]]}),
    "no_route_post": ("/nope", {"a": 1}),
    "no_route_get": ("/nope", None),
    "append_without_source": ("/append", {"x": [[0.1, 0.2]], "y": [1.0]}),
    "swap_missing_version": ("/admin/swap", {"version": "v0000099"}),
}


@pytest.mark.parametrize("case", sorted(WIRE_ERRORS))
def test_http_wire_errors_match_reference(servers, case):
    """400 / 404 / 405-free error paths: the same status and error text."""
    path, payload = WIRE_ERRORS[case]
    (js, jb, _), (ts, tb, _) = _both(servers, path, payload)
    assert js >= 400 and ts == js and tb == jb, (jb, tb)


def test_http_invalid_json_matches_reference(servers):
    out = []
    for pkg in ("reference", "port"):
        req = urllib.request.Request(
            servers[pkg]["url"] + "/predict", data=b"{not json",
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        out.append((e.value.code, json.loads(e.value.read())))
    assert out[0] == out[1] and out[0][0] == 400


def test_predict_deadline_expired_is_504_like_reference(servers, fitted):
    errors = []
    for pkg, mod in (("reference", jc), ("port", tc)):
        frontend = servers[pkg]["frontend"]
        with pytest.raises(mod.WireError) as e:
            frontend.predict({"x": fitted["xq"][:2].tolist(),
                              "deadline_ms": 50},
                             arrival=time.monotonic() - 1.0)
        errors.append((e.value.status, str(e.value).split("(")[0]))
        assert frontend.admission.inflight == 0
    assert errors[0] == errors[1] and errors[0][0] == 504


def _pin_admission_clock(ctrl, now):
    """Every token-bucket read of ``ctrl`` sees the instant ``now``: the
    admission decisions and ``/stats``' bucket fill go through
    ``admit(now=)`` and ``available(now=)``, which both packages take."""
    ctrl.admit = functools.partial(ctrl.admit, now=now)
    for lim in ctrl._limiters.values():
        lim.available = (lambda _now=None, _read=lim.available:
                         _read(now=now))


def test_http_flood_sheds_429_like_reference(tmp_path, fitted):
    """Burst 2 at a rate of one token per 1000 s, an engine target: the same
    code sequence, shed bodies and counts, a Retry-After of the same ~1000
    s; admin traffic is never rate-shed.

    Both controllers' token buckets read one pinned clock, so no token
    refills between the burst and the shed requests and the hint is
    ``ceil(1 / rate)``, however slow the host (on the wall clock a stall of
    more than 10 s took it below 990). The flood's handler threads are
    joined before ``/stats`` is read: each counts its reply's status only
    after writing the reply, so a read racing that thread could miss it."""
    results = {}
    for pkg, mod, model in (("reference", jc, fitted["jmodel"]),
                            ("port", tc, fitted["tmodel"])):
        ctrl = mod.AdmissionController(buckets=(8,), rate_qps=1e-3, burst=2.0)
        _pin_admission_clock(ctrl, now=time.monotonic())
        if pkg == "reference":
            engine = JEngine(model, buckets=(8,), bm=64, bn=64)
            frontend = mod.ServeFrontend(engine, ctrl)
        else:
            engine = BucketedEngine(model, buckets=(8,))
            frontend = mod.ServeFrontend(engine, ctrl, device="cpu")
        engine.warmup()
        httpd, _ = mod.start_http_server(frontend)
        url = f"http://127.0.0.1:{httpd.port}"
        try:
            codes, retry = [], []
            for _ in range(5):
                req = urllib.request.Request(
                    url + "/predict", data=json.dumps({"x": [[0.1, 0.2]]})
                    .encode(), headers={"Content-Type": "application/json"})
                try:
                    with urllib.request.urlopen(req, timeout=30) as resp:
                        codes.append(resp.status)
                except urllib.error.HTTPError as e:
                    codes.append(e.code)
                    retry.append(e.headers.get("Retry-After"))
                    body = json.loads(e.read())
            httpd._threads.join()
            _, stats = _http_json(url + "/stats")
            admin, _ = _http_json(url + "/predict", {"x": [[0.1, 0.2]],
                                                     "priority": "admin"})
            assert all(990 <= int(r) <= 1000 for r in retry), retry
            results[pkg] = (codes, len(retry), sorted(body), body["reason"],
                            stats["admission"]["shed_rate"],
                            stats["engine"]["requests"], admin,
                            stats["http"]["by_status"])
        finally:
            httpd.shutdown()
            httpd.server_close()
    assert results["port"] == results["reference"]
    assert results["port"][0] == [200, 200, 429, 429, 429]


def test_http_health_stats_and_metrics_match_reference(servers, fitted):
    """``/healthz`` bodies equal; ``/stats`` key sets and ``schema_version``
    equal; ``/metrics`` content type and the HTTP stack's ``# TYPE`` family
    lines equal; the inbound trace ID is echoed."""
    (js, jb, _), (ts, tb, _) = _both(servers, "/healthz")
    assert js == ts == 200 and tb == jb
    _both(servers, "/predict", {"x": fitted["xq"][:3].tolist()},
          headers={"X-Trace-Id": "tr-parity-1"})
    (_, jb, jh), (_, tb, th) = _both(servers, "/predict",
                                     {"x": fitted["xq"][:3].tolist()},
                                     headers={"X-Trace-Id": "tr-parity-2"})
    assert jh["X-Trace-Id"] == th["X-Trace-Id"] == "tr-parity-2"
    (js, jb, _), (ts, tb, _) = _both(servers, "/stats")
    assert js == ts == 200
    assert sorted(tb) == sorted(jb)
    for section in ("engine", "admission", "http"):
        assert sorted(tb[section]) == sorted(jb[section]), section
    assert tb["schema_version"] == jb["schema_version"] == 3
    for key in ("version", "models", "draining"):
        assert tb[key] == jb[key], key
    for key in ("requests", "batches", "rows", "padded_rows", "per_bucket"):
        assert tb["engine"][key] == jb["engine"][key], key
    (_, jtext, jh), (_, ttext, th) = _both(servers, "/metrics")
    assert th["Content-Type"] == jh["Content-Type"]

    def types(text):
        return sorted(line for line in text.splitlines()
                      if line.startswith("# TYPE gp_")
                      and line.split()[2].startswith(
                          ("gp_http_", "gp_admission_", "gp_engine_")))

    assert types(ttext) == types(jtext)
    assert len(types(ttext)) >= 10


def test_http_admin_swap_and_drain_match_reference(servers, fitted):
    jc.publish_servable(servers["store"], _double(fitted["jmodel"]))
    (js, jb, _), (ts, tb, _) = _both(servers, "/admin/swap", {})
    assert js == ts == 200 and tb == jb and tb["version"] == "v0000002"
    (_, jb, _), (_, tb, _) = _both(servers, "/healthz")
    assert tb == jb and tb["version"] == "v0000002"
    xq = fitted["xq"][:4]
    (_, jb, _), (_, tb, _) = _both(servers, "/predict", {"x": xq.tolist()})
    want = j_predict(fitted["jmodel"], xq, bm=64, bn=64)
    np.testing.assert_allclose(tb["mean"], 2 * np.asarray(want.mean),
                               rtol=PRED_RTOL, atol=PRED_ATOL)
    np.testing.assert_allclose(tb["mean"], jb["mean"], rtol=PRED_RTOL,
                               atol=PRED_ATOL)
    assert tb["version"] == jb["version"] == "v0000002"
    (js, jb, _), (ts, tb, _) = _both(servers, "/admin/drain", {})
    assert js == ts == 200 and tb == jb and tb["draining"]
    for path, payload in (("/predict", {"x": xq.tolist()}), ("/healthz", None)):
        (js, jb, _), (ts, tb, _) = _both(servers, path, payload)
        assert js == ts == 503 and tb == jb


def test_http_append_matches_reference(tmp_path, fitted):
    """``POST /append`` into each package's OnlineGP on the same fitted
    state: the same replies, wire errors and ``/stats`` refresh counters."""
    x, y = fitted["x"], fitted["y"]
    jon = JOnline(x, y, fitted["state"], fitted["jcfg"])
    ton = OnlineGP(torch.tensor(np.asarray(x)), torch.tensor(np.asarray(y)),
                   interop.outer_state_from_numpy(_np_state(fitted["state"])),
                   fitted["tcfg"])
    servers = {}
    for pkg, mod, model, online in (
            ("reference", jc, fitted["jmodel"], jon),
            ("port", tc, fitted["tmodel"], ton)):
        target = (JEngine(model, buckets=BUCKETS, bm=64, bn=64)
                  if pkg == "reference" else BucketedEngine(model, BUCKETS))
        kw = {} if pkg == "reference" else {"device": "cpu"}
        frontend = mod.ServeFrontend(target, refresh_source=online, **kw)
        httpd, _ = mod.start_http_server(frontend)
        servers[pkg] = {"url": f"http://127.0.0.1:{httpd.port}",
                        "httpd": httpd}
    try:
        xq = fitted["xq"]
        rows = {"x": xq[:4].tolist(), "y": [0.1, -0.2, 0.3, 0.0]}
        (js, jb, _), (ts, tb, _) = _both(servers, "/append", rows)
        assert js == ts == 200 and tb == jb and tb["appended"] == 4
        for bad in ({"x": xq[:2].tolist()}, {"x": xq[:2].tolist(), "y": [1.0]},
                    {"x": [[0.1, float("inf")]], "y": [1.0]},
                    {"x": [[0.1, 0.2, 0.3]], "y": [1.0]},
                    {"x": "nope", "y": [1.0]}):
            (js, jb, _), (ts, tb, _) = _both(servers, "/append", bad)
            assert js == ts == 400 and tb == jb, (bad, jb, tb)
        (_, jb, _), (_, tb, _) = _both(servers, "/stats")
        assert sorted(tb["refresh"]) == sorted(jb["refresh"])
        for key in ("n", "appends", "appended_rows", "pending_appends",
                    "refines"):
            assert tb["refresh"][key] == jb["refresh"][key], key
    finally:
        for s in servers.values():
            s["httpd"].shutdown()
            s["httpd"].server_close()


# -- concurrent swap vs in-flight traffic ------------------------------------
def test_concurrent_swap_during_enqueue(fitted, monkeypatch):
    """Twin of the reference's test: no queued request reads a torn model.
    Every response equals the reference's prediction of exactly one of the
    two versions, and the swaps build or load no kernel library."""
    calls = _count_dispatches(monkeypatch)
    model = fitted["tmodel"]
    model2 = _double(model)
    engine = BucketedEngine(model, buckets=BUCKETS)
    engine.warmup()
    xq = fitted["xq"][:4]
    want1 = np.asarray(j_predict(fitted["jmodel"], xq, bm=64, bn=64).mean)
    want2 = np.asarray(j_predict(_double(fitted["jmodel"]), xq, bm=64,
                                 bn=64).mean)
    stop = threading.Event()

    def swapper():
        flip = False
        while not stop.is_set():
            engine.swap_model(model2 if flip else model)
            flip = not flip

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    th = threading.Thread(target=swapper, daemon=True)
    th.start()
    try:
        futs = [engine.enqueue(torch.tensor(xq)) for _ in range(40)]
        results = [f.result(timeout=60).mean.numpy() for f in futs]
    finally:
        stop.set()
        th.join(timeout=10)
        engine.stop()
        sys.setswitchinterval(switch)
    assert not th.is_alive()
    for got in results:
        match1 = np.allclose(got, want1, rtol=PRED_RTOL, atol=PRED_ATOL)
        match2 = np.allclose(got, want2, rtol=PRED_RTOL, atol=PRED_ATOL)
        assert match1 or match2, "response matches neither model version"
    assert len(calls) >= len(BUCKETS) + 1


# -- supervised replica processes --------------------------------------------
def _wait(pred, timeout_s):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            if pred():
                return True
        except (FileNotFoundError, ValueError, OSError):
            pass
        time.sleep(0.2)
    return False


def test_replica_supervisor_serves_versions_and_respawns(tmp_path, fitted,
                                                         monkeypatch):
    """One CPU worker process: serves v1 (the port's predictions), picks up
    v2 from the store, and is respawned after a kill serving v2."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    store = str(tmp_path / "store")
    tc.publish_servable(store, fitted["tmodel"])
    sup = tc.ReplicaSupervisor(store, num_replicas=1, buckets=BUCKETS,
                               poll_interval_s=0.2, device="cpu")
    xq = fitted["xq"][:5]
    want = servable_predict(fitted["tmodel"], torch.tensor(xq)).mean.numpy()
    try:
        (url,) = sup.start(timeout_s=120)
        assert sup.startup_s[0] is not None and sup.startup_s[0] > 0
        status, body = _http_json(url + "/predict", {"x": xq.tolist()})
        assert status == 200 and body["version"] == "v0000001"
        np.testing.assert_allclose(body["mean"], want, rtol=PRED_RTOL,
                                   atol=PRED_ATOL)
        v2 = tc.publish_servable(store, _double(fitted["tmodel"]))
        assert _wait(lambda: _http_json(url + "/healthz")[1].get("version")
                     == v2, 60), "worker never picked up v2"
        status, body = _http_json(url + "/predict", {"x": xq.tolist()})
        np.testing.assert_allclose(body["mean"], 2 * want, rtol=PRED_RTOL,
                                   atol=PRED_ATOL)

        sup.kill(0)
        assert not sup._procs[0].is_alive()
        assert sup.check() == 1 and sup.restarts == 1

        def healthy_on_v2():
            with open(sup._port_file(0)) as f:
                sup.ports[0] = int(f.read().strip())
            status, body = _http_json(sup.endpoint(0) + "/healthz",
                                      timeout=2.0)
            return status == 200 and body.get("version") == v2

        assert _wait(healthy_on_v2, 120), "respawned replica never served v2"
    finally:
        sup.stop()
    assert all(not p.is_alive() for p in sup._procs)


def test_worker_asked_for_a_missing_card_makes_start_raise(tmp_path, fitted,
                                                           monkeypatch):
    """No fallback: a worker asked for ``cuda`` where there is no card dies,
    and ``start()`` raises with its exit code."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    store = str(tmp_path / "store")
    tc.publish_servable(store, fitted["tmodel"])
    sup = tc.ReplicaSupervisor(store, num_replicas=1, buckets=BUCKETS)
    try:
        with pytest.raises(RuntimeError,
                           match=r"replica 0 died during startup \(exitcode=1\)"):
            sup.start(timeout_s=120)
    finally:
        sup.stop(drain=False)
