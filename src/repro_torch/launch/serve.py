"""GP serving driver of the port: fit -> export `ServableGP` -> bucketed engine.

Port of the engine mode of ``repro.launch.serve`` (``_fit_gp`` +
``serve_gp``): a few outer marginal-likelihood steps (pathwise estimator,
warm-started CG without preconditioner, Adam), export of the solver carry as
the servable correction matrix, then ``--requests`` requests of 64 test rows
answered with zero linear solves (eq. 16).

    python -m repro_torch.launch.serve --dataset pol --max-n 2000 \\
        --train-steps 10 --requests 20 --buckets 16,64,256

``--device`` defaults to ``cuda`` and fails without a card; ``--device cpu``
runs the plain PyTorch versions. ``--max-n 0`` serves the full dataset.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.driver import FitResult, fit
from repro_torch.core.outer import OuterConfig
from repro_torch.core.predict import predictive_metrics
from repro_torch.data.synthetic import Dataset, load_dataset
from repro_torch.serve.artifact import export_servable
from repro_torch.serve.engine import BucketedEngine
from repro_torch.solvers import SolverConfig

REQUEST_WIDTH = 64


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit_gp(args):
    """Load the dataset and fit it as the reference's ``_fit_gp`` does."""
    ds = load_dataset(args.dataset, max_n=args.max_n, device=args.device)
    cfg = OuterConfig(
        estimator="pathwise", warm_start=True, num_probes=args.num_probes,
        solver=SolverConfig(name="cg", max_epochs=100, precond_rank=0),
        num_steps=args.train_steps, bm=512, bn=512, backend=args.backend,
    )
    gen = torch.Generator(device=ds.x_train.device).manual_seed(args.seed)
    res = fit(ds.x_train, ds.y_train, cfg, generator=gen, verbose=args.verbose)
    return ds, cfg, res


class ServeRun(NamedTuple):
    """What :func:`serve_gp` returns."""

    report: dict  # per-step solver numbers, MVM/dispatch counts, latencies
    engine: BucketedEngine  # serving the exported model
    dataset: Dataset
    cfg: OuterConfig
    fit: FitResult


def serve_gp(args) -> ServeRun:
    """Fit, export, then serve ``args.requests`` requests of 64 test rows.

    The report's RMSE/LLH are on the first request's rows, as the
    reference's.
    """
    ds, cfg, res = fit_gp(args)
    device = ds.x_train.device
    buckets = tuple(int(b) for b in args.buckets.split(","))
    model = export_servable(res.state, ds.x_train)
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

    m = predictive_metrics(ds.y_test[:REQUEST_WIDTH],
                           engine.submit(ds.x_test[:REQUEST_WIDTH]),
                           res.state.params)
    p50, p99 = np.percentile(np.asarray(lat) * 1e3, [50, 99])
    h = res.history
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
        "fit_seconds": res.wall_time_s,
        "cg_mvms": int(np.sum(h["mvms"])),
        "engine_dispatches": len(engine.buckets) + engine.stats.batches,
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
    return ServeRun(report=report, engine=engine, dataset=ds, cfg=cfg, fit=res)


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
    return ap


def main(argv=None):
    """CLI entry: parse flags and run :func:`serve_gp`."""
    serve_gp(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
