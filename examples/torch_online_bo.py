"""Online Bayesian optimisation on the PyTorch port: a twin of
``examples/online_bo.py`` that imports only ``repro_torch``.

Fits a GP surrogate on a handful of observations of a multi-modal
objective (four Gaussian bumps in 2-D), then runs the sequential acquire ->
observe -> append -> refresh loop (`repro_torch.online.run_bo`): every round
predicts over a fixed candidate set through the bucketed serving engine,
picks the UCB argmax, appends the observation via `OnlineGP`, and refreshes
with the warm block path (damped old-row correction, auto-escalation). The
defaults are the reference example's: 64 initial points, 8 probes, 128 RFF
pairs, CG to 0.01 without preconditioner, 5 fit steps, 40 rounds of 256
candidates.

    PYTHONPATH=src python examples/torch_online_bo.py            # on a card
    PYTHONPATH=src python examples/torch_online_bo.py --device cpu

Draws come from ``torch.Generator``s seeded 0 where the reference uses
``PRNGKey(0)``, so the numbers differ from the reference's; ``run`` takes
the reference's draws handed over.
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core.driver import fit
from repro_torch.core.outer import OuterConfig
from repro_torch.gp.hyperparams import HyperParams
from repro_torch.online import BOConfig, make_gaussian_bumps, run_bo
from repro_torch.solvers import SolverConfig


def build_parser() -> argparse.ArgumentParser:
    """The reference example's settings; the device and the round count
    are flags."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--rounds", type=int, default=40)
    return ap


def config() -> OuterConfig:
    """The surrogate: pathwise estimator + warm-started CG, on the port's
    kernels (the engine's variance comes from the pathwise sample paths,
    and the warm carry is what makes per-round refreshes cheap)."""
    return OuterConfig(
        estimator="pathwise", num_probes=8, num_rff_pairs=128,
        solver=SolverConfig(name="cg", tolerance=1e-2, precond_rank=0),
        num_steps=5, backend="cuda", bm=256, bn=256,
    )


def run(args, cfg=None, objective=None, f_opt=None, x0=None, state=None,
        candidates=None, reserve_rows=None) -> dict:
    """Fit the surrogate, then run the loop; prints what the reference
    prints. The config is :func:`config` unless handed over. The objective,
    the initial points, the fit's initial state, the candidates and the
    reserve's base noise are drawn from seeded generators unless handed
    over (how a test gives the reference's). Returns the `BOResult` and the
    fit."""
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    if objective is None:
        objective, f_opt = make_gaussian_bumps(2, generator=gen, device=device)
    if x0 is None:
        x0 = -1.0 + 2.0 * torch.rand((64, 2), generator=gen, device=device)
    x0 = x0.to(device)
    y0 = objective(x0)
    cfg = config() if cfg is None else cfg
    res = fit(x0, y0, cfg, generator=gen, state=state,
              init_params=HyperParams.create(2, lengthscale=0.3, signal=1.0,
                                             noise=0.1, device=device))
    out = run_bo(
        objective, x0, y0, res.state, cfg,
        bo=BOConfig(rounds=args.rounds, num_candidates=256,
                    refresh_mode="auto", correction="damped"),
        bounds=(-1.0, 1.0), f_opt=f_opt, generator=gen,
        candidates=candidates, reserve_rows=reserve_rows)
    for e in out.history[::8]:
        print(f"  round {e['round']:3d}: y={e['y']:+.3f} "
              f"best={e['best_y']:+.3f} regret={e['regret']:.4f} "
              f"mode={e.get('mode', '-')} epochs={e.get('epochs', 0.0):.2f}"
              f"{' [corrected]' if e.get('corrected') else ''}"
              f"{' [escalated]' if e.get('escalated') else ''}")
    print(f"best y={out.best_y:.4f} (optimum ~{f_opt:.4f}, "
          f"regret {out.regret:.4f}) after {len(out.history)} rounds")
    print(f"solver cost: {out.cum_epochs:.1f} cumulative epochs, "
          f"{out.escalations} escalations, {out.corrections} corrections "
          f"({out.rounds_per_sec:.1f} rounds/s)")
    return {"bo": out, "fit": res}


def main(argv=None):
    """CLI entry: parse flags and :func:`run`."""
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
