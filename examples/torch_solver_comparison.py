"""Solver comparison (paper Table 1, one dataset) on the PyTorch port: a twin
of ``examples/solver_comparison.py`` that imports only ``repro_torch``.

CG vs AP vs SGD under the four estimator / warm-start variants (standard or
pathwise, cold or warm), each solve run to tolerance 0.01 with no epoch
budget: the total solver epochs over the fit, its wall time and the test
LLH at the end. The defaults are the reference example's: elevators' (n, d)
signature cut to 1500 rows (1350 training rows, padded to 1400 for AP's
100-row blocks and SGD's 100-row batches), 32 probes, 500 RFF pairs, a
rank-20 preconditioner for CG, SGD at lr 2.0, 15 outer steps.

    PYTHONPATH=src python examples/torch_solver_comparison.py            # on a card
    PYTHONPATH=src python examples/torch_solver_comparison.py --max-n 0  # full elevators
    PYTHONPATH=src python examples/torch_solver_comparison.py --device cpu \\
        --max-n 334 --steps 2

``run_variant`` is the twin of the reference's
``benchmarks/common.py::run_variant``. Its draws come from a
``torch.Generator`` seeded 0 where the reference uses ``PRNGKey(0)``, so
the numbers differ from the reference's unless the draws are handed over
(``state=`` and ``draws=``).
"""
import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.core.driver import FitResult, fit
from repro_torch.core.outer import OuterConfig, OuterState
from repro_torch.data.synthetic import load_dataset, pad_to_block_multiple
from repro_torch.solvers import NO_EPOCH_BUDGET, SolverConfig

# The reference example's 12 rows, in its order.
VARIANTS = tuple((solver, pathwise, warm) for solver in ("cg", "ap", "sgd")
                 for pathwise in (False, True) for warm in (False, True))
HEADER = (f"{'solver':6s} {'estimator':10s} {'warm':5s} "
          f"{'epochs':>8s} {'time(s)':>8s} {'LLH':>8s}")


def bench_dataset(name="pol", max_n=800, device="cuda"):
    """The port's ``load_dataset`` on ``device`` (raises without a card
    unless ``device="cpu"``)."""
    return load_dataset(name, max_n=max_n, device=device)


def variant_config(solver: str, pathwise: bool, warm: bool, steps: int = 20,
                   probes: int = 32, budget: float = 0.0,
                   block_size: int = 100, batch_size: int = 100,
                   sgd_lr: float = 2.0, precond_rank: int = 20,
                   tolerance: float = 0.01,
                   record_history: int = 0) -> OuterConfig:
    """The `OuterConfig` the reference's ``run_variant`` builds, on the
    port's kernels (``bm``/``bn`` have no counterpart here)."""
    scfg = SolverConfig(
        name=solver, tolerance=tolerance,
        max_epochs=budget if budget > 0 else NO_EPOCH_BUDGET,
        precond_rank=precond_rank, block_size=block_size,
        batch_size=batch_size, learning_rate=sgd_lr,
        record_history=record_history,
    )
    return OuterConfig(
        estimator="pathwise" if pathwise else "standard",
        warm_start=warm, num_probes=probes, num_rff_pairs=500,
        solver=scfg, num_steps=steps, backend="cuda",
    )


def fit_variant(
    ds,
    solver: str,
    pathwise: bool,
    warm: bool,
    *,
    steps: int = 20,
    probes: int = 32,
    budget: float = 0.0,
    block_size: int = 100,
    batch_size: int = 100,
    sgd_lr: float = 2.0,
    precond_rank: int = 20,
    tolerance: float = 0.01,
    seed=0,
    eval_at_end: bool = True,
    record_history: int = 0,
    budget_policy=None,
    state: Optional[OuterState] = None,
    draws: Optional[dict] = None,
) -> tuple[FitResult, dict]:
    """:func:`run_variant`, also returning the `FitResult` (its history
    accounts for every kernel launch of the fit)."""
    x, y = ds.x_train, ds.y_train
    if solver in ("ap", "sgd"):
        blk = block_size if solver == "ap" else batch_size
        x, y, _ = pad_to_block_multiple(x, y, blk)
    cfg = variant_config(solver, pathwise, warm, steps, probes, budget,
                         block_size, batch_size, sgd_lr, precond_rank,
                         tolerance, record_history)
    generator = (seed if isinstance(seed, torch.Generator) else
                 torch.Generator(device=x.device).manual_seed(int(seed)))
    res = fit(x, y, cfg, generator=generator, state=state,
              x_test=ds.x_test, y_test=ds.y_test,
              eval_every=steps if eval_at_end else 0,
              budget_policy=budget_policy, **(draws or {}))
    h = res.history
    cum_epochs = np.cumsum(h["epochs"])
    out = {
        "solver": solver, "pathwise": pathwise, "warm": warm,
        "budget": budget,
        "total_time_s": res.wall_time_s,
        "total_epochs": float(cum_epochs[-1]),
        "cum_epochs": cum_epochs,
        "total_iters": int(h["iters"].sum()),
        "final_res_y": float(h["res_y"][-1]),
        "final_res_z": float(h["res_z"][-1]),
        "mean_res_z": float(h["res_z"].mean()),
        "hypers": h["hypers"],
        "res_z_per_step": h["res_z"],
        "iters_per_step": h["iters"],
    }
    if budget_policy is not None:
        out["budget_alloc_per_step"] = h["budget_alloc"]
        out["budget_pool_left"] = float(h["budget_pool"][-1])
    if eval_at_end and len(h["eval_llh"]):
        out["test_llh"] = float(h["eval_llh"][-1])
        out["test_rmse"] = float(h["eval_rmse"][-1])
    return res, out


def run_variant(
    ds,
    solver: str,
    pathwise: bool,
    warm: bool,
    steps: int = 20,
    probes: int = 32,
    budget: float = 0.0,
    block_size: int = 100,
    batch_size: int = 100,
    sgd_lr: float = 2.0,
    precond_rank: int = 20,
    tolerance: float = 0.01,
    seed=0,
    eval_at_end: bool = True,
    record_history: int = 0,
    budget_policy=None,
    state: Optional[OuterState] = None,
    draws: Optional[dict] = None,
) -> dict:
    """One (solver x estimator x warm-start [x budget]) cell; the
    reference's ``run_variant`` with its parameters and returned keys.

    ``budget <= 0`` runs each solve to tolerance (``NO_EPOCH_BUDGET``);
    ``budget_policy`` (a ``repro_torch.solvers.adaptive.BudgetPolicy``,
    needs ``record_history >= 2``) allocates each step's budget. AP and SGD
    pad the rows to a multiple of their block or batch. ``cum_epochs`` is
    the running total over steps. Unlike the reference, ``seed`` is an int
    or a ``torch.Generator``, ``state`` starts the fit from a given state,
    and ``draws`` (``fit``'s ``probes``, ``batch_idx``, ``eval_probes``,
    ``eval_batch_idx``) hands over the per-step draws."""
    return fit_variant(
        ds, solver, pathwise, warm, steps=steps, probes=probes,
        budget=budget, block_size=block_size, batch_size=batch_size,
        sgd_lr=sgd_lr, precond_rank=precond_rank, tolerance=tolerance,
        seed=seed, eval_at_end=eval_at_end, record_history=record_history,
        budget_policy=budget_policy, state=state, draws=draws)[1]


def format_row(r: dict) -> str:
    """One row of the reference example's table."""
    return (f"{r['solver']:6s} "
            f"{'pathwise' if r['pathwise'] else 'standard':10s} "
            f"{str(r['warm']):5s} {r['total_epochs']:8.1f} "
            f"{r['total_time_s']:8.1f} "
            f"{r.get('test_llh', float('nan')):8.3f}")


def variant_kwargs(args) -> list:
    """The keyword arguments of :func:`fit_variant` for each of the 12
    rows, in the reference's order."""
    return [dict(solver=solver, pathwise=pathwise, warm=warm,
                 steps=args.steps, sgd_lr=2.0)
            for solver, pathwise, warm in VARIANTS]


def build_parser() -> argparse.ArgumentParser:
    """The reference example's settings, with its sizes as flags."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dataset", default="elevators")
    ap.add_argument("--max-n", type=int, default=1500,
                    help="row cap (0 = the full dataset)")
    ap.add_argument("--steps", type=int, default=15)
    return ap


def run(ds, args) -> list:
    """The header and the 12 rows, as the reference prints them; returns
    each row's ``run_variant`` dict."""
    print(HEADER, flush=True)
    rows = []
    for kw in variant_kwargs(args):
        r = run_variant(ds, **kw)
        print(format_row(r), flush=True)
        rows.append(r)
    return rows


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    return run(bench_dataset(args.dataset, max_n=args.max_n,
                             device=args.device), args)


if __name__ == "__main__":
    main()
