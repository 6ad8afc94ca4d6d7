"""Serving driver of the port; port of ``repro.launch.serve``.

LM archs (``--arch <lm>``, :func:`serve_lm`): greedy autoregressive
generation from the arch's SMOKE config with random weights, through
``make_serve_step`` against a KV/SSM cache updated in place:

    python -m repro_torch.launch.serve --arch llama3-8b --batch 4 \\
        --tokens 32 --max-len 128

GP arch (``--arch gp-iterative``, the default): fit -> export
`ServableGP` -> bucketed engine; the GP half of the reference's driver
(``_fit_gp``, ``serve_gp``, ``serve_gp_compat``, ``serve_gp_http`` and
its smoke probes): a few outer marginal-likelihood steps
(pathwise estimator, warm-started CG without preconditioner, Adam), export
of the solver carry as the servable correction matrix, then ``--requests``
requests of 64 test rows answered with zero linear solves (eq. 16).
``--refresh-every N`` (any N > 0) then runs one warm online refresh into
the engine (the first 64 test rows appended, ``refresh_into`` with a
10-epoch budget) before the metrics request. ``--compat`` runs the legacy
per-request loop instead of the engine (``pathwise_predict`` per request,
the tail block padded to the request width).

    python -m repro_torch.launch.serve --dataset pol --max-n 2000 \\
        --train-steps 10 --requests 20 --buckets 16,64,256

``--http HOST:PORT`` serves the fitted model over HTTP instead
(:func:`serve_gp_http`): in this process, or with ``--artifact-store DIR``
as ``--replicas N`` supervised worker processes that poll the store, with
``--monitor HOST:PORT`` the fleet monitor beside them, and ``--http-smoke``
/ ``--metrics`` / ``--fleet-smoke`` probing the live servers and exiting:

    python -m repro_torch.launch.serve --max-n 256 --train-steps 2 \
        --buckets 8,32 --http 127.0.0.1:0 --replicas 2 \
        --artifact-store /tmp/store --monitor 127.0.0.1:0 --fleet-smoke

``--device`` defaults to ``cuda`` and fails without a card; ``--device cpu``
runs the plain PyTorch versions. Replica workers serve on the same device
and die without it. ``--max-n 0`` serves the full dataset.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import urllib.error
import urllib.request
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.driver import FitResult, fit
from repro_torch.core.outer import OuterConfig, OuterState
from repro_torch.core.predict import pathwise_predict, predictive_metrics
from repro_torch.data.synthetic import Dataset, load_dataset
from repro_torch.device import resolve_device
from repro_torch.models import init_cache, init_params, make_serve_step
from repro_torch.models.transformer import prefill_cross_cache
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.scrape import parse_prometheus
from repro_torch.serve.artifact import export_servable
from repro_torch.serve.cluster import (
    AdmissionController,
    ReplicaSupervisor,
    ServeFrontend,
    publish_servable,
    start_http_server,
)
from repro_torch.serve.cluster.monitor import (
    FleetMonitor,
    default_slos,
    start_monitor_server,
)
from repro_torch.serve.cluster.replica import _http_json
from repro_torch.serve.engine import BucketedEngine
from repro_torch.serve.multimodel import MultiModelServer
from repro_torch.serve.refresh import OnlineGP, RefreshReport
from repro_torch.solvers import SolverConfig

REQUEST_WIDTH = 64


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_lm(args, params: Optional[dict] = None) -> torch.Tensor:
    """Greedy decoding of ``args.arch``'s SMOKE config: ``args.tokens``
    steps x ``args.batch`` rows from token 0 against a ``args.max_len``
    cache (whisper: the cross cache filled from 0.3-scaled random frames
    of 32 positions). ``params`` (default: drawn from ``args.seed``) lets
    a caller hand weights over. Tokens stay on the device until the end;
    prints the reference's ``[serve]`` line and returns the tokens as a
    (tokens, batch) CPU tensor."""
    cfg = get_config(args.arch, smoke=True)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if params is None:
        params = init_params(gen, cfg)
    b, steps = args.batch, args.tokens
    enc_len = 32 if cfg.is_encdec else 0
    cache = init_cache(cfg, b, args.max_len, enc_len=enc_len, device=dev)
    if cfg.is_encdec:
        frames = torch.randn((b, enc_len, cfg.d_model), generator=gen,
                             device=dev) * 0.3
        cache = prefill_cross_cache(params, cfg, frames, cache)
    step = make_serve_step(cfg)
    toks = torch.zeros((b,), dtype=torch.int32, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    out = []
    for pos in range(steps):
        logits, cache = step(params, cache, toks, pos)
        toks = torch.argmax(logits[:, : cfg.vocab_size], dim=-1).to(
            torch.int32)
        out.append(toks)
    tokens = torch.stack(out).cpu()  # the one read back
    dt = time.perf_counter() - t0
    print(f"[serve] {args.arch}: {steps} steps x batch {b} in {dt:.2f}s "
          f"({steps*b/dt:.1f} tok/s); sample row: "
          f"{tokens[:16, 0].tolist()}", flush=True)
    return tokens


def gp_config(args) -> OuterConfig:
    """The reference's ``_fit_gp`` configuration, with the port's flags."""
    return OuterConfig(
        estimator="pathwise", warm_start=True, num_probes=args.num_probes,
        solver=SolverConfig(name="cg", max_epochs=100, precond_rank=0),
        num_steps=args.train_steps, bm=512, bn=512, backend=args.backend,
    )


def fit_gp(args):
    """Load the dataset and fit it as the reference's ``_fit_gp`` does."""
    ds = load_dataset(args.dataset, max_n=args.max_n, device=args.device)
    cfg = gp_config(args)
    gen = torch.Generator(device=ds.x_train.device).manual_seed(args.seed)
    res = fit(ds.x_train, ds.y_train, cfg, generator=gen, verbose=args.verbose)
    return ds, cfg, res


class ServeRun(NamedTuple):
    """What :func:`serve_gp` returns."""

    report: dict  # per-step solver numbers, MVM/dispatch counts, latencies
    engine: BucketedEngine  # serving the exported model
    dataset: Dataset
    cfg: OuterConfig
    fit: Optional[FitResult]  # None when the state was handed over
    state: OuterState  # the fitted state the engine serves
    refresh: Optional[RefreshReport] = None  # --refresh-every's refresh


def serve_gp_compat(args, ds: Dataset, state: OuterState) -> dict:
    """The reference's legacy per-request loop: ``pathwise_predict`` from
    the carry per request of 64 rows, the tail block padded to the request
    width; RMSE/LLH on the first 64 test rows."""
    width = REQUEST_WIDTH
    n_test = ds.x_test.shape[0]
    device = ds.x_train.device
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(args.requests):
            lo = (i * width) % max(1, n_test)
            xq = ds.x_test[lo:lo + width]
            if xq.shape[0] < width:  # pad the tail block to the width
                xq = torch.cat([xq, xq.new_zeros((width - xq.shape[0],
                                                  xq.shape[1]))])
            pathwise_predict(ds.x_train, xq, state.carry_v, state.probes,
                             state.params)
            _sync(device)
        dt = time.perf_counter() - t0
        m = predictive_metrics(
            ds.y_test[:width],
            pathwise_predict(ds.x_train, ds.x_test[:width], state.carry_v,
                             state.probes, state.params), state.params)
    report = {"requests": args.requests, "request_rows": width,
              "serve_seconds": dt,
              "queries_per_s": args.requests * width / dt,
              "rmse": float(m["rmse"]), "llh": float(m["llh"])}
    print(f"[serve-gp compat] {args.requests} requests x {width} in {dt:.2f}s "
          f"({report['queries_per_s']:.1f} q/s) — ZERO solves at serve time; "
          f"rmse={report['rmse']:.4f} llh={report['llh']:.4f}", flush=True)
    return report


def serve_gp(args, ds: Optional[Dataset] = None,
             cfg: Optional[OuterConfig] = None,
             state: Optional[OuterState] = None,
             refresh_rows: Optional[torch.Tensor] = None) -> ServeRun:
    """Fit (unless ``ds``, ``cfg`` and ``state`` are handed over), export,
    then serve ``args.requests`` requests of 64 test rows through the
    engine. ``refresh_rows`` hands over the base noise of
    ``--refresh-every``'s appended rows.

    The report's RMSE/LLH are on the first request's rows, as the
    reference's (after the refresh, when there is one).
    """
    res = None
    if ds is None:
        ds, cfg, res = fit_gp(args)
        state = res.state
    device = ds.x_train.device
    buckets = tuple(int(b) for b in args.buckets.split(","))
    model = export_servable(state, ds.x_train)
    engine = BucketedEngine(model, buckets=buckets)
    engine.warmup()
    _sync(device)

    n_test = ds.x_test.shape[0]
    lat = []
    t0 = time.perf_counter()
    for i in range(args.requests):
        lo = (i * REQUEST_WIDTH) % max(1, n_test - 1)
        ts = time.perf_counter()
        pred = engine.submit(ds.x_test[lo:lo + REQUEST_WIDTH])
        _sync(device)
        lat.append(time.perf_counter() - ts)
    dt = time.perf_counter() - t0

    refresh = None
    if args.refresh_every and n_test > 0:
        blk = min(REQUEST_WIDTH, n_test)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        online = OnlineGP(ds.x_train, ds.y_train, state, cfg, generator=gen)
        online.append(ds.x_test[:blk], ds.y_test[:blk], rows=refresh_rows)
        refresh = online.refresh_into(engine, budget_epochs=10.0)
        print(f"[serve-gp] online refresh: +{blk} rows -> n={refresh.n}, "
              f"{refresh.epochs:.1f} epochs, res_y={refresh.res_y:.3f}",
              flush=True)

    m = predictive_metrics(ds.y_test[:REQUEST_WIDTH],
                           engine.submit(ds.x_test[:REQUEST_WIDTH]),
                           state.params)
    p50, p99 = np.percentile(np.asarray(lat) * 1e3, [50, 99])
    h = res.history if res is not None else {
        k: [] for k in ("res_y", "res_z", "iters", "mvms", "host_syncs",
                        "step_time_s")}
    report = {
        "dataset": ds.name,
        "n_train": int(ds.x_train.shape[0]),
        "n_test": int(n_test),
        "d": int(ds.x_train.shape[1]),
        "num_probes": cfg.num_probes,
        "backend": cfg.backend,
        "steps": [
            {"step": i + 1, "res_y": float(h["res_y"][i]),
             "res_z": float(h["res_z"][i]), "iters": int(h["iters"][i]),
             "mvms": int(h["mvms"][i]), "host_syncs": int(h["host_syncs"][i]),
             "seconds": float(h["step_time_s"][i])}
            for i in range(len(h["res_y"]))
        ],
        "fit_seconds": res.wall_time_s if res is not None else 0.0,
        "cg_mvms": int(np.sum(h["mvms"])),
        "engine_dispatches": len(engine.buckets) + engine.stats.batches,
        "refresh": None if refresh is None else refresh._asdict(),
        "requests": args.requests,
        "request_rows": REQUEST_WIDTH,
        "serve_seconds": dt,
        "queries_per_s": args.requests * REQUEST_WIDTH / dt,
        "latency_ms_p50": float(p50),
        "latency_ms_p99": float(p99),
        "rmse": float(m["rmse"]),
        "llh": float(m["llh"]),
        "engine_stats": engine.stats_dict(),
    }
    print(f"[serve-gp] {args.requests} requests x {REQUEST_WIDTH} in {dt:.2f}s "
          f"({report['queries_per_s']:.1f} q/s, p50={p50:.1f}ms "
          f"p99={p99:.1f}ms) — buckets={buckets}, ZERO solves at serve time; "
          f"rmse={report['rmse']:.4f} llh={report['llh']:.4f}", flush=True)
    return ServeRun(report=report, engine=engine, dataset=ds, cfg=cfg,
                    fit=res, state=state, refresh=refresh)


# -- HTTP / cluster serving ---------------------------------------------------


def _rows(xq) -> list:
    """Query rows as the JSON wire format's nested lists."""
    return xq.detach().cpu().numpy().tolist()


def _metrics_smoke_probe(endpoints, xq) -> None:
    """Observability leg of the smoke: a /predict carrying an explicit
    ``X-Trace-Id`` must echo it back, and GET /metrics must serve Prometheus
    text exposing the request/admission/engine metric families."""
    required = (
        "gp_http_requests_total",
        "gp_admission_decisions_total",
        "gp_engine_batch_seconds",
        "gp_engine_queue_depth",
    )
    probe = json.dumps({"x": _rows(xq)}).encode()
    for ep in endpoints:
        tid = "smoke-" + obs_trace.new_trace_id()
        req = urllib.request.Request(
            ep + "/predict", data=probe,
            headers={"Content-Type": "application/json",
                     obs_trace.TRACE_HEADER: tid})
        with urllib.request.urlopen(req, timeout=30) as resp:
            echoed = resp.headers.get(obs_trace.TRACE_HEADER)
        if echoed != tid:
            raise SystemExit(
                f"[obs-smoke] {ep} trace header not echoed: sent {tid!r}, "
                f"got {echoed!r}")
        with urllib.request.urlopen(ep + "/metrics", timeout=10) as resp:
            ctype = resp.headers.get("Content-Type", "")
            text = resp.read().decode()
        if "version=0.0.4" not in ctype:
            raise SystemExit(f"[obs-smoke] {ep}/metrics content type {ctype!r}")
        missing = [f for f in required if f"# TYPE {f} " not in text]
        if missing:
            raise SystemExit(
                f"[obs-smoke] {ep}/metrics missing families {missing}; "
                f"got {len(text)} bytes")
        print(f"[obs-smoke] {ep}: trace echo ok, /metrics ok "
              f"({len(text.splitlines())} lines)", flush=True)


def _fleet_smoke_probe(sup, monitor, monitor_ep, endpoints, xq) -> dict:
    """The fleet-observability smoke against a live cluster + monitor.

    Sequence: every replica must show up on ``/fleet/health``; after a
    burst of traffic the aggregated ``/fleet/metrics`` ``/predict``
    counters must EQUAL the per-replica ``/metrics`` totals (exact — the
    scraper re-exports samples verbatim); ``/fleet/health`` EWMA/shed-rate
    must match each replica's own ``/stats``; then one replica is
    hard-killed and ``gp_fleet_replica_up`` must flip to 0 within a couple
    of scrape intervals, with the availability burn-rate rule escalating
    to PAGE. Raises SystemExit on any violation; returns the seconds from
    the kill to the replica's down mark and to PAGE.
    """
    interval = monitor.interval_s

    def wait_for(pred, timeout_s, what):
        deadline = time.monotonic() + timeout_s
        t0 = time.monotonic()
        while time.monotonic() < deadline:
            try:
                if pred():
                    return time.monotonic() - t0
            except OSError:
                pass
            time.sleep(max(0.05, interval / 4))
        raise SystemExit(f"[fleet-smoke] timed out waiting for {what}")

    names = [f"replica_{i}" for i in range(len(endpoints))]

    # 1. Every replica reports up on /fleet/health.
    def all_up():
        status, h = _http_json(monitor_ep + "/fleet/health")
        return status == 200 and h["num_up"] == len(endpoints)

    wait_for(all_up, 30 * interval + 30, "all replicas up on /fleet/health")
    print(f"[fleet-smoke] {len(endpoints)} replicas up on /fleet/health",
          flush=True)

    # 2. Traffic: a burst of predicts against every replica, then stop —
    # quiescent counters are what makes the exactness check exact.
    probe = {"x": _rows(xq)}
    for _ in range(5):
        for ep in endpoints:
            status, body = _http_json(ep + "/predict", probe)
            if status not in (200, 429):
                raise SystemExit(
                    f"[fleet-smoke] {ep}/predict -> {status}: {body}")

    def parse_url(url):
        with urllib.request.urlopen(url, timeout=10) as resp:
            return parse_prometheus(resp.read().decode("utf-8"))

    def predict_total(fams, where=None):
        fam = fams.get("gp_http_requests_total")
        total = 0.0
        for s in (fam.samples if fam else ()):
            if s.labels.get("path") != "/predict":
                continue
            if where is None or where(s.labels):
                total += s.value
        return total

    direct = {
        name: predict_total(parse_url(ep + "/metrics"))
        for name, ep in zip(names, endpoints)
    }

    # 3. /fleet/metrics totals must EQUAL the per-replica counters once the
    # scraper's cache catches up (a couple of intervals at most).
    def fleet_matches():
        fams = parse_url(monitor_ep + "/fleet/metrics")
        got = {
            name: predict_total(
                fams, where=lambda lbl, n=name: lbl.get("replica") == n)
            for name in names
        }
        return got == direct

    wait_for(fleet_matches, 10 * interval + 30,
             f"/fleet/metrics to equal per-replica totals {direct}")
    print(f"[fleet-smoke] /fleet/metrics == per-replica /metrics: {direct}",
          flush=True)

    # 4. /fleet/health load signals must match each replica's own /stats.
    def health_matches():
        _, h = _http_json(monitor_ep + "/fleet/health")
        for name, ep in zip(names, endpoints):
            entry = h["replicas"].get(name)
            if entry is None:
                return False
            _, stats = _http_json(ep + "/stats")
            adm = stats["admission"]
            admitted, shed = adm.get("admitted", 0), adm.get("shed", 0)
            want_shed = shed / (admitted + shed) if (admitted + shed) else 0.0
            got_ewma = entry["service_ewma_ms"]
            if got_ewma is None or \
                    abs(got_ewma - adm["service_ewma_ms"]) > 1e-9:
                return False
            if abs((entry["shed_rate"] or 0.0) - want_shed) > 1e-9:
                return False
        return True

    wait_for(health_matches, 10 * interval + 30,
             "/fleet/health EWMA/shed-rate to match replica /stats")
    print("[fleet-smoke] /fleet/health EWMA + shed-rate match /stats",
          flush=True)

    # 5. Availability must settle at OK before the chaos step.
    def avail_ok():
        _, s = _http_json(monitor_ep + "/fleet/slo")
        return s["slos"].get("availability", {}).get("state") == "OK"

    wait_for(avail_ok, 60 * interval + 30, "availability SLO to settle OK")

    # 6. Chaos: hard-kill the last replica. Up must flip within ~2 scrape
    # intervals; the availability burn rate must escalate OK -> PAGE.
    victim = len(endpoints) - 1
    sup.kill(victim)
    t_kill = time.monotonic()

    def victim_down():
        _, h = _http_json(monitor_ep + "/fleet/health")
        entry = h["replicas"].get(names[victim])
        return entry is not None and not entry["up"]

    took = wait_for(victim_down, 4 * interval + 15,
                    f"gp_fleet_replica_up 0 for {names[victim]}")
    print(f"[fleet-smoke] {names[victim]} marked down "
          f"{took:.1f}s after kill (interval {interval}s)", flush=True)

    def paged():
        _, s = _http_json(monitor_ep + "/fleet/slo")
        return s["slos"].get("availability", {}).get("state") == "PAGE"

    slow = max(r.slow_window_s
               for slo in monitor.slo_engine._states.values()
               for r in slo.slo.rules)
    wait_for(paged, slow + 60 * interval + 30,
             "availability burn-rate PAGE after replica kill")
    to_page = time.monotonic() - t_kill
    print(f"[fleet-smoke] availability PAGE {to_page:.1f}s after kill — OK",
          flush=True)
    return {"kill_to_down_s": took, "kill_to_page_s": to_page}


def _http_smoke_probe(endpoints, xq, metrics=False) -> None:
    """The smoke sequence against live endpoints: /healthz and /predict
    must 200 with finite predictions; a flood past the admission cap must
    shed 429 WITH a Retry-After hint; with ``metrics``, after waiting that
    hint out, :func:`_metrics_smoke_probe`. Raises SystemExit on any
    violation."""
    for ep in endpoints:
        status, body = _http_json(ep + "/healthz")
        if status != 200:
            raise SystemExit(f"[http-smoke] {ep}/healthz -> {status}: {body}")
        status, body = _http_json(ep + "/predict", {"x": _rows(xq)})
        if status != 200:
            raise SystemExit(f"[http-smoke] {ep}/predict -> {status}: {body}")
        mean = np.asarray(body["mean"])
        if mean.shape != (xq.shape[0],) or not np.all(np.isfinite(mean)):
            raise SystemExit(f"[http-smoke] non-finite/misshapen mean: {body}")
        print(f"[http-smoke] {ep}: healthz ok, predict ok "
              f"(version={body.get('version')})", flush=True)

    # Flood one endpoint past the admission cap: sequential requests drain
    # the token bucket, so with burst B requests B+1.. must shed.
    ep = endpoints[0]
    codes, retry_after = [], None
    probe = json.dumps({"x": _rows(xq[:1])}).encode()
    for _ in range(10):
        req = urllib.request.Request(
            ep + "/predict", data=probe,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                codes.append(resp.status)
        except urllib.error.HTTPError as e:
            codes.append(e.code)
            if e.code == 429 and retry_after is None:
                retry_after = e.headers.get("Retry-After")
    if 429 not in codes:
        raise SystemExit(f"[http-smoke] flood never shed: {codes}")
    if retry_after is None or int(retry_after) < 1:
        raise SystemExit(f"[http-smoke] 429 without Retry-After: {codes}")
    stats_status, stats = _http_json(ep + "/stats")
    if stats_status != 200 or stats["admission"]["shed"] < codes.count(429):
        raise SystemExit(f"[http-smoke] stats disagree with flood: {stats}")
    if "schema_version" not in stats or "ts" not in stats:
        raise SystemExit(f"[http-smoke] /stats missing ts/schema_version: "
                         f"{sorted(stats)}")
    print(f"[http-smoke] flood codes={codes} Retry-After={retry_after} "
          f"shed={stats['admission']['shed']} — OK", flush=True)
    if metrics:
        # The flood emptied the token bucket: honour its Retry-After before
        # the metrics leg's /predict, which a fast server would shed too.
        time.sleep(int(retry_after))
        _metrics_smoke_probe(endpoints, xq)


class HTTPServing(NamedTuple):
    """Live HTTP serving started by :func:`start_gp_http`.

    In process: ``frontend`` (its engine and admission), ``httpd`` and, with
    ``--refresh-every``, the ``online`` refresh source. Supervised:
    ``supervisor``, the published ``version`` and, with ``--monitor``,
    ``monitor`` / ``monitor_server`` / ``monitor_ep``. ``xq`` holds the
    probe rows (the first 16 test rows).
    """

    endpoints: list
    xq: torch.Tensor
    frontend: Optional[ServeFrontend] = None
    httpd: object = None
    online: Optional[OnlineGP] = None
    supervisor: Optional[ReplicaSupervisor] = None
    version: Optional[str] = None
    monitor: Optional[FleetMonitor] = None
    monitor_server: object = None
    monitor_ep: Optional[str] = None
    owns_log: bool = False  # this serving configured the process's log

    def close(self) -> None:
        """Stop everything :func:`start_gp_http` started (drains replicas)."""
        if self.monitor_server is not None:
            self.monitor_server.shutdown()
            self.monitor.stop()
        if self.supervisor is not None:
            self.supervisor.stop()
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
        if self.owns_log:
            obs_trace.configure()


def start_gp_http(args, ds: Dataset, cfg: OuterConfig,
                  state: OuterState) -> HTTPServing:
    """Export the fitted model and start serving it over HTTP.

    ``--replicas 1`` without ``--artifact-store`` serves in this process
    (the full transport/admission stack on the model's device). With a
    store, the model is published and ``--replicas`` worker processes,
    spawned on the same device, serve it and pick up every later publish
    without a restart; ``--monitor`` adds the fleet monitor. On the card the
    kernel library is built here, before any worker starts, so workers only
    load it.
    """
    host, port = args.http.rsplit(":", 1)
    port = int(port)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    device = ds.x_train.device
    model = export_servable(state, ds.x_train)
    xq = ds.x_test[:min(16, ds.x_test.shape[0])]

    if args.replicas > 1 and not args.artifact_store:
        raise SystemExit("--replicas > 1 needs --artifact-store (the store "
                         "is how worker processes receive the model)")
    if args.fleet_smoke and not (args.artifact_store and args.monitor):
        raise SystemExit("--fleet-smoke needs --artifact-store (supervised "
                         "replicas) and --monitor HOST:PORT")

    if args.artifact_store:
        if device.type == "cuda":
            from repro_torch.kernels import tiled

            tiled.build_kernels()
        version = publish_servable(args.artifact_store, model)
        print(f"[serve-http] published {version} -> {args.artifact_store}",
              flush=True)
        sup = ReplicaSupervisor(
            args.artifact_store, num_replicas=args.replicas, host=host,
            base_port=port, buckets=buckets, rate_qps=args.admission_qps,
            burst=args.admission_burst, max_inflight=args.max_inflight,
            request_log_dir=args.request_log, device=str(device),
        )
        try:
            endpoints = sup.start()
        except BaseException:
            sup.stop(drain=False)
            raise
        print(f"[serve-http] {args.replicas} replica(s): {endpoints}",
              flush=True)
        serving = HTTPServing(endpoints=endpoints, xq=xq, supervisor=sup,
                              version=version)
        if not args.monitor:
            return serving
        mhost, mport = args.monitor.rsplit(":", 1)
        interval = args.monitor_interval
        slos = None
        if args.fleet_smoke:
            # Short windows so the burn-rate PAGE fires within the smoke's
            # patience rather than the production 5min/1h.
            interval = min(interval, 0.5)
            slos = default_slos(fast_window_s=6 * interval,
                                slow_window_s=18 * interval)
        mlog = None
        if args.request_log:
            mlog = obs_trace.EventLog(
                path=os.path.join(args.request_log, "monitor.jsonl"))
        monitor = FleetMonitor(supervisor=sup, interval_s=interval, slos=slos,
                               event_log=mlog)
        monitor_server, _ = start_monitor_server(monitor, host=mhost,
                                                 port=int(mport))
        monitor_ep = f"http://{mhost}:{monitor_server.port}"
        print(f"[serve-http] fleet monitor: {monitor_ep}/fleet/"
              f"{{metrics,slo,health}} (interval {interval}s)", flush=True)
        return serving._replace(monitor=monitor, monitor_server=monitor_server,
                                monitor_ep=monitor_ep)

    if args.request_log:
        # In-process replica: one log file, the layout the supervisor uses.
        obs_trace.configure(
            path=os.path.join(args.request_log, "replica_0.jsonl"))
    server = MultiModelServer(buckets=buckets)
    server.register("default", model, warmup=True)
    admission = AdmissionController(
        buckets=buckets, rate_qps=args.admission_qps,
        burst=args.admission_burst, max_inflight=args.max_inflight,
    )
    online = None
    if args.refresh_every:
        # In-place refresh replica: expose the refresher's counters
        # (escalations, coupling residuals, capacity growth) on GET /stats.
        gen = torch.Generator(device=device).manual_seed(args.seed)
        online = OnlineGP(ds.x_train, ds.y_train, state, cfg, generator=gen)
    frontend = ServeFrontend(server, admission, refresh_source=online,
                             device=device)
    httpd, _ = start_http_server(frontend, host=host, port=port)
    endpoint = f"http://{host}:{httpd.port}"
    print(f"[serve-http] in-process replica: {endpoint}", flush=True)
    return HTTPServing(endpoints=[endpoint], xq=xq, frontend=frontend,
                       httpd=httpd, online=online,
                       owns_log=bool(args.request_log))


def serve_gp_http(args, ds: Dataset, cfg: OuterConfig,
                  state: OuterState) -> HTTPServing:
    """HTTP serving: start (:func:`start_gp_http`), then run the smoke
    probes the flags ask for (``--fleet-smoke``, else ``--http-smoke`` with
    ``--metrics``), or serve ``--serve-seconds`` (0: until interrupted),
    then stop everything. Returns the stopped serving (its engine and
    admission counters stay readable)."""
    serving = start_gp_http(args, ds, cfg, state)
    try:
        if args.fleet_smoke:
            _fleet_smoke_probe(serving.supervisor, serving.monitor,
                               serving.monitor_ep, serving.endpoints,
                               serving.xq)
        elif args.http_smoke:
            _http_smoke_probe(serving.endpoints, serving.xq,
                              metrics=args.metrics)
        elif args.serve_seconds:
            time.sleep(args.serve_seconds)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        serving.close()
    return serving


def build_parser() -> argparse.ArgumentParser:
    """The CLI flags (reference names and defaults, plus the port's own)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="gp-iterative")
    ap.add_argument("--dataset", default="pol")
    ap.add_argument("--max-n", type=int, default=2000,
                    help="row cap on the dataset (0 = the full dataset)")
    ap.add_argument("--train-steps", type=int, default=10)
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--buckets", default="16,64,256",
                    help="comma-separated GP engine row buckets")
    ap.add_argument("--num-probes", type=int, default=32,
                    help="probe systems s (the reference CLI uses 32; the "
                         "gp-iterative config uses 64)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", default="cuda",
                    help="HOperator backend: cuda (the tile kernel), "
                         "streamed or dense")
    ap.add_argument("--verbose", action="store_true",
                    help="print one line per outer step")
    ap.add_argument("--compat", action="store_true",
                    help="legacy per-request GP loop (pathwise_predict per "
                         "request, tail padded)")
    ap.add_argument("--refresh-every", type=int, default=0,
                    help="if set, run one warm online refresh after serving")
    ap.add_argument("--http", default=None, metavar="HOST:PORT",
                    help="serve GP predictions over HTTP (port 0 = ephemeral)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="worker processes behind --http (>1 needs "
                         "--artifact-store; replica i binds PORT+i)")
    ap.add_argument("--artifact-store", default=None, metavar="DIR",
                    help="publish the fitted artifact here and serve from it "
                         "(replicas poll LATEST and hot-swap new publishes)")
    ap.add_argument("--admission-qps", type=float, default=None,
                    help="admitted requests/s per bucket class (None = no "
                         "rate limit)")
    ap.add_argument("--admission-burst", type=float, default=None,
                    help="token-bucket burst (default 2x qps)")
    ap.add_argument("--max-inflight", type=int, default=64,
                    help="concurrent in-compute requests before shedding")
    ap.add_argument("--serve-seconds", type=float, default=0,
                    help="serve for S seconds then exit (0 = run forever)")
    ap.add_argument("--http-smoke", action="store_true",
                    help="probe /healthz + /predict + overload shedding "
                         "against the live server, then exit")
    ap.add_argument("--metrics", action="store_true",
                    help="with --http-smoke: also assert X-Trace-Id echo and "
                         "the Prometheus families on GET /metrics")
    ap.add_argument("--request-log", default=None, metavar="DIR",
                    help="write per-replica structured JSONL request logs "
                         "(request/admission/engine span events) under DIR")
    ap.add_argument("--monitor", default=None, metavar="HOST:PORT",
                    help="run the fleet monitor alongside the supervisor "
                         "(scrapes every replica, serves /fleet/metrics, "
                         "/fleet/slo, /fleet/health; port 0 = ephemeral)")
    ap.add_argument("--monitor-interval", type=float, default=1.0,
                    help="monitor scrape/evaluate period in seconds")
    ap.add_argument("--fleet-smoke", action="store_true",
                    help="probe the fleet plane (aggregate==per-replica "
                         "counters, health contract, kill-one-replica "
                         "staleness + burn-rate PAGE), then exit")
    return ap


def main(argv=None):
    """CLI entry: parse flags; an LM ``--arch`` runs :func:`serve_lm` and
    returns its tokens. ``gp-iterative`` fits and runs
    :func:`serve_gp_compat` under ``--compat``, :func:`serve_gp_http`
    under ``--http``, else :func:`serve_gp`."""
    args = build_parser().parse_args(argv)
    if args.arch != "gp-iterative":
        return serve_lm(args)
    if args.compat:
        ds, _, res = fit_gp(args)
        serve_gp_compat(args, ds, res.state)
    elif args.http:
        ds, cfg, res = fit_gp(args)
        serve_gp_http(args, ds, cfg, res.state)
    else:
        serve_gp(args)


if __name__ == "__main__":
    main()
