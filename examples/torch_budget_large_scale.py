"""Large-data regime (paper §5) on the PyTorch port: a twin of
``examples/budget_large_scale.py`` that imports only ``repro_torch``.

Under a budget of a few solver epochs per outer step, warm starting lets
solver progress accumulate across steps (the residuals fall over the
trajectory), while the cold-started solver's residuals stagnate. AP solver,
pathwise estimator, 32 probes, 3 epochs per step, Adam at 0.03, after the
large-dataset initialisation heuristic (exact MLL on nearest-neighbour
subsets). The defaults are the reference example's CPU size: 3droad's
(n, d) signature cut to 4000 rows, 200-row blocks, the heuristic on
500-row subsets around 3 centroids for 15 steps, 15 outer steps.

    PYTHONPATH=src python examples/torch_budget_large_scale.py --device cpu
    PYTHONPATH=src python examples/torch_budget_large_scale.py --max-n 0 \\
        --block-size 1000 --subset-size 10000 --num-centroids 10 \\
        --heuristic-steps 30 --steps 5          # full 3droad on a card

Draws come from ``torch.Generator``s seeded 1 (the heuristic's centroids)
and 0 (the fit), where the reference uses ``PRNGKey(1)`` and
``PRNGKey(0)``; the numbers differ from the reference's.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import init_hypers_heuristic
from repro_torch.core.driver import fit
from repro_torch.core.outer import OuterConfig, init_outer_state
from repro_torch.data.synthetic import load_dataset, pad_to_block_multiple
from repro_torch.solvers import SolverConfig
from repro_torch.train.adam import AdamConfig


def build_parser() -> argparse.ArgumentParser:
    """The reference example's settings, with its sizes as flags."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--max-n", type=int, default=4000,
                    help="row cap on 3droad (0 = the full dataset)")
    ap.add_argument("--block-size", type=int, default=200)
    ap.add_argument("--steps", type=int, default=15,
                    help="outer steps per start mode (eval at the last)")
    ap.add_argument("--subset-size", type=int, default=500)
    ap.add_argument("--num-centroids", type=int, default=3)
    ap.add_argument("--heuristic-steps", type=int, default=15)
    return ap


def config(args, warm: bool) -> OuterConfig:
    """The reference example's `OuterConfig`, on the port's kernels."""
    return OuterConfig(
        estimator="pathwise",
        warm_start=warm,
        num_probes=32,
        solver=SolverConfig(name="ap", tolerance=0.01,
                            max_epochs=3,  # tiny budget!
                            block_size=args.block_size),
        adam=AdamConfig(learning_rate=0.03),
        num_steps=args.steps,
        backend="cuda",
        bm=512, bn=512,
    )


def run(ds, args, centroids=None, probes=None) -> dict:
    """The heuristic, then a cold-start and a warm-start fit from its
    hyperparameters; prints what the reference prints. ``centroids`` (the
    heuristic's rows) and ``probes`` (``{warm: ProbeState}``, the initial
    probe draws) replace the draws when given (how a test hands over the
    reference's). Returns the init and the `FitResult` of each start mode
    (keys ``False`` and ``True``)."""
    x, y, _ = pad_to_block_multiple(ds.x_train, ds.y_train, args.block_size)
    init = init_hypers_heuristic(
        torch.Generator(device=x.device).manual_seed(1), x, y,
        subset_size=args.subset_size, num_centroids=args.num_centroids,
        num_steps=args.heuristic_steps, centroids=centroids)
    print("heuristic init:", {
        "lengthscales":
            np.round(init.lengthscales.double().cpu().numpy(), 3).tolist(),
        "signal": round(float(init.signal), 3),
        "noise": round(float(init.noise), 3)}, flush=True)
    out = {"init": init}
    for warm in (False, True):
        cfg = config(args, warm)
        gen = torch.Generator(device=x.device).manual_seed(0)
        state = init_outer_state(cfg, x, init_params=init, generator=gen,
                                 probes=None if probes is None else probes[warm])
        res = fit(x, y, cfg, generator=gen, state=state, x_test=ds.x_test,
                  y_test=ds.y_test, eval_every=args.steps)
        rz = res.history["res_z"]
        print(f"warm_start={warm}: res_z first->last "
              f"{rz[0]:.3f} -> {rz[-1]:.3f}; "
              f"test LLH={res.history['eval_llh'][-1]:.4f}", flush=True)
        out[warm] = res
    return out


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    ds = load_dataset("3droad", max_n=args.max_n, device=args.device)
    return run(ds, args)


if __name__ == "__main__":
    main()
