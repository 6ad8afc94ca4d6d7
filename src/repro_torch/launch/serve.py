"""GP serving driver of the port: fit -> export `ServableGP` -> bucketed engine.

Port of the in-process modes of ``repro.launch.serve`` (``_fit_gp``,
``serve_gp``, ``serve_gp_compat``): a few outer marginal-likelihood steps
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

``--device`` defaults to ``cuda`` and fails without a card; ``--device cpu``
runs the plain PyTorch versions. ``--max-n 0`` serves the full dataset.
``--http`` (and the reference's replica, admission, monitor and smoke
flags) belong to the HTTP/cluster layer, which is not ported yet: the flag
is refused with a message.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.driver import FitResult, fit
from repro_torch.core.outer import OuterConfig, OuterState
from repro_torch.core.predict import pathwise_predict, predictive_metrics
from repro_torch.data.synthetic import Dataset, load_dataset
from repro_torch.serve.artifact import export_servable
from repro_torch.serve.engine import BucketedEngine
from repro_torch.serve.refresh import OnlineGP, RefreshReport
from repro_torch.solvers import SolverConfig

REQUEST_WIDTH = 64


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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


def build_parser() -> argparse.ArgumentParser:
    """The CLI flags (reference names and defaults, plus the port's own)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", default="pol")
    ap.add_argument("--max-n", type=int, default=2000,
                    help="row cap on the dataset (0 = the full dataset)")
    ap.add_argument("--train-steps", type=int, default=10)
    ap.add_argument("--requests", type=int, default=20)
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
                    help="refused: the HTTP/cluster layer is not ported yet")
    return ap


def main(argv=None):
    """CLI entry: parse flags, then fit and run :func:`serve_gp_compat`
    under ``--compat``, else :func:`serve_gp`."""
    args = build_parser().parse_args(argv)
    if args.http:
        raise SystemExit(
            "--http needs the HTTP/cluster serving layer, which the port "
            "does not have yet (ROADMAP Queue 1 item 4)")
    if args.compat:
        ds, _, res = fit_gp(args)
        serve_gp_compat(args, ds, res.state)
    else:
        serve_gp(args)


if __name__ == "__main__":
    main()
