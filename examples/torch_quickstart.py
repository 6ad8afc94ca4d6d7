"""Quickstart on the PyTorch port: a twin of ``examples/quickstart.py`` that
imports only ``repro_torch``.

Trains GP hyperparameters on a synthetic UCI-shaped dataset with the
pathwise estimator and warm-started CG (the paper's fastest
configuration), then predicts by pathwise conditioning with zero extra
linear solves. The defaults are the reference example's: pol's (n, d)
signature cut to 2000 rows, 32 probes, CG to 0.01 within 200 epochs with a
rank-50 preconditioner, Adam at 0.1, 40 steps, eval every 10.

    PYTHONPATH=src python examples/torch_quickstart.py            # on a card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The fit draws from a ``torch.Generator`` seeded 0 where the reference uses
``PRNGKey(0)``, so the numbers differ from the reference's.
"""
import argparse

import torch

from repro_torch.core.driver import fit
from repro_torch.core.outer import OuterConfig
from repro_torch.core.predict import pathwise_predict, predictive_metrics
from repro_torch.data.synthetic import load_dataset
from repro_torch.solvers import SolverConfig
from repro_torch.train.adam import AdamConfig


def build_parser() -> argparse.ArgumentParser:
    """The reference example's settings, with its sizes as flags."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--max-n", type=int, default=2000,
                    help="row cap on pol (0 = the full dataset)")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--eval-every", type=int, default=10)
    return ap


def config(args) -> OuterConfig:
    """The reference example's three-level hierarchy (paper Fig. 2), on the
    port's kernels: Adam / pathwise estimator / warm-started CG."""
    return OuterConfig(
        estimator="pathwise",   # paper §3
        warm_start=True,        # paper §4
        num_probes=32,          # s (paper uses 64; 32 is quick)
        solver=SolverConfig(name="cg", tolerance=0.01, max_epochs=200,
                            precond_rank=50),
        adam=AdamConfig(learning_rate=0.1),
        num_steps=args.steps,
        backend="cuda",
        bm=512, bn=512,
    )


def run(ds, args, state=None) -> dict:
    """Fit, then predict at the test inputs; prints what the reference
    prints. ``state`` starts the fit from a given state (how a test hands
    over the reference's draws). Returns the `FitResult` and the metrics."""
    print(f"dataset={ds.name} n_train={ds.x_train.shape[0]} "
          f"d={ds.x_train.shape[1]}", flush=True)
    cfg = config(args)
    res = fit(ds.x_train, ds.y_train, cfg,
              generator=torch.Generator(device=ds.x_train.device).manual_seed(0),
              state=state, x_test=ds.x_test, y_test=ds.y_test,
              eval_every=args.eval_every, verbose=True)
    print(f"total wall time: {res.wall_time_s:.1f}s; "
          f"solver iterations/step: {res.history['iters'].tolist()}")
    # Amortised prediction (eq. 16): the probe solutions are posterior
    # samples; no further solves.
    st = res.state
    with torch.no_grad():
        pred = pathwise_predict(ds.x_train, ds.x_test, st.carry_v, st.probes,
                                st.params)
        m = predictive_metrics(ds.y_test, pred, st.params)
    print(f"test RMSE={float(m['rmse']):.4f} "
          f"test LLH={float(m['llh']):.4f} "
          f"({pred.samples.shape[1]} posterior samples, 0 extra solves)")
    return {"fit": res, "rmse": float(m["rmse"]), "llh": float(m["llh"])}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    return run(load_dataset("pol", max_n=args.max_n, device=args.device), args)


if __name__ == "__main__":
    main()
