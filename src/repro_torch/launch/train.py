"""CLI training driver of the port; port of ``repro.launch.train``.

Two paths behind one entry point:

    python -m repro_torch.launch.train --arch gp-iterative --dataset pol \\
        --pathwise --warm-start --steps 20 --eval-every 10

    python -m repro_torch.launch.train --solver ap --pathwise --warm-start \
        --budget 10 --max-n 0

    python -m repro_torch.launch.train --arch llama3-8b --steps 5

Fits the dataset with CG (rank ``--precond-rank`` pivoted-Cholesky
preconditioner), AP (``--block-size``) or SGD (``--batch-size``, learning
rate ``--sgd-lr``, or the paper's grid when it is 0), the standard or
pathwise estimator, warm-started or not, and Adam, with evaluation every
``--eval-every`` steps and checkpoints in ``--ckpt-dir``; prints the
reference's JSON summary (and writes it to ``--out``). For AP and SGD the
training rows are padded with phantom points to a multiple of the block.
``--device`` defaults to ``cuda`` and fails without a card; ``--device
cpu`` runs the plain PyTorch versions. ``--max-n 0`` trains on the full
dataset.

Any other ``--arch`` is an LM architecture of ``repro_torch.configs``
(an unknown name raises ``KeyError``): its reduced SMOKE config trains for
``--steps`` Adam steps on synthetic tokens at ``SMOKE_SHAPES["train_4k"]``
(whisper on random frames with its decoder-length text, internvl2 with a
random patch prefix), printing ``[train-lm] <arch> step <i>: loss=<x>``
as the reference does.
"""
from __future__ import annotations

import argparse
import json
import os
from dataclasses import replace
from typing import NamedTuple

import torch

from repro_torch.configs import SMOKE_SHAPES, get_config
from repro_torch.core.driver import FitResult, fit, pick_sgd_learning_rate
from repro_torch.core.outer import OuterConfig
from repro_torch.data.synthetic import (load_dataset, make_lm_batch,
                                        pad_to_block_multiple)
from repro_torch.device import resolve_device
from repro_torch.gp.hyperparams import HyperParams
from repro_torch.models import init_params, make_train_step
from repro_torch.solvers import SolverConfig
from repro_torch.train.adam import AdamConfig, adam_init


class GPRun(NamedTuple):
    """What :func:`run_gp` returns."""

    summary: dict  # the reference's JSON summary
    fit: FitResult
    cfg: OuterConfig  # the config the fit ran (the SGD lr the grid chose)
    # (lr, SolveResult) of each SGD learning-rate grid solve; empty unless
    # the grid ran (``--solver sgd --sgd-lr 0``).
    lr_trials: list


def build_config(args) -> OuterConfig:
    """The `OuterConfig` the CLI flags describe (as the reference's)."""
    solver = SolverConfig(
        name=args.solver, tolerance=args.tolerance,
        max_epochs=args.budget if args.budget > 0 else 1e9,
        precond_rank=args.precond_rank, block_size=args.block_size,
        batch_size=args.batch_size, learning_rate=args.sgd_lr)
    return OuterConfig(
        estimator="pathwise" if args.pathwise else "standard",
        warm_start=args.warm_start, num_probes=args.probes, solver=solver,
        adam=AdamConfig(learning_rate=args.lr), num_steps=args.steps,
        backend=args.backend, bm=args.tile, bn=args.tile)


def run_gp(args) -> GPRun:
    """Load the dataset (padded to the block for AP and SGD), pick the SGD
    learning rate when asked, fit, and print the JSON summary."""
    cfg = build_config(args)
    ds = load_dataset(args.dataset, max_n=args.max_n, device=args.device)
    x, y = ds.x_train, ds.y_train
    if args.solver in ("ap", "sgd"):
        block = args.block_size if args.solver == "ap" else args.batch_size
        x, y, _ = pad_to_block_multiple(x, y, block)
    gen = torch.Generator(device=x.device).manual_seed(args.seed)
    trials = []
    if args.solver == "sgd" and args.sgd_lr <= 0:
        lr = pick_sgd_learning_rate(
            x, y, HyperParams.create(x.shape[1], device=x.device), cfg,
            generator=gen, trials=trials)
        print(f"[train] sgd lr grid -> {lr}", flush=True)
        cfg = replace(cfg, solver=replace(cfg.solver, learning_rate=lr))
    res = fit(x, y, cfg, generator=gen,
              x_test=ds.x_test, y_test=ds.y_test, eval_every=args.eval_every,
              ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
              verbose=True)
    h = res.history
    out = {
        "dataset": ds.name,
        "solver": args.solver,
        "pathwise": args.pathwise,
        "warm_start": args.warm_start,
        "total_time_s": res.wall_time_s,
        "total_epochs": float(h["epochs"].sum()),
        "final_res_y": float(h["res_y"][-1]),
        "final_res_z": float(h["res_z"][-1]),
        "eval_rmse": h["eval_rmse"].tolist(),
        "eval_llh": h["eval_llh"].tolist(),
    }
    print(json.dumps(out, indent=2), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return GPRun(summary=out, fit=res, cfg=cfg, lr_trials=trials)


def lm_train_batch(cfg, gen: torch.Generator, rows: int, seq: int,
                   device) -> dict:
    """One synthetic train batch of ``cfg``'s inputs, as the reference's
    ``run_lm`` builds it: ``make_lm_batch`` tokens; for an encoder-decoder,
    random (rows, seq, d_model) frames and the text cut to
    ``cfg.decoder_len``; for a vision prefix, random patch embeddings."""
    batch = make_lm_batch(gen, rows, seq, cfg.vocab_size, device=device)
    if cfg.is_encdec:
        return {
            "frames": torch.randn((rows, seq, cfg.d_model), generator=gen,
                                  device=gen.device).to(device),
            "tokens": batch["tokens"][:, : cfg.decoder_len],
            "labels": batch["labels"][:, : cfg.decoder_len],
            "mask": batch["mask"][:, : cfg.decoder_len],
        }
    if cfg.frontend.kind == "vision":
        batch["patch_embeds"] = torch.randn(
            (rows, cfg.frontend.num_prefix, cfg.frontend.embed_dim),
            generator=gen, device=gen.device).to(device)
    return batch


def run_lm(args) -> list:
    """Train the SMOKE config of ``args.arch`` for ``args.steps`` steps, one
    fresh synthetic batch a step; prints and returns the losses."""
    cfg = get_config(args.arch, smoke=True)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(gen, cfg)
    opt = adam_init(params)
    step = make_train_step(cfg, num_microbatches=1)
    shape = SMOKE_SHAPES["train_4k"]
    losses = []
    for i in range(args.steps):
        batch = lm_train_batch(cfg, gen, shape.global_batch, shape.seq_len,
                               dev)
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
        print(f"[train-lm] {args.arch} step {i}: loss={losses[-1]:.4f}",
              flush=True)
    return losses


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags and defaults, plus ``--device``."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="gp-iterative")
    ap.add_argument("--dataset", default="pol")
    ap.add_argument("--max-n", type=int, default=4000,
                    help="row cap on the dataset (0 = the full dataset)")
    ap.add_argument("--solver", default="cg", choices=["cg", "ap", "sgd"])
    ap.add_argument("--pathwise", action="store_true")
    ap.add_argument("--warm-start", action="store_true")
    ap.add_argument("--probes", type=int, default=64)
    ap.add_argument("--budget", type=float, default=0.0,
                    help="solver epochs per outer step; 0 = to tolerance")
    ap.add_argument("--tolerance", type=float, default=0.01)
    ap.add_argument("--precond-rank", type=int, default=100)
    ap.add_argument("--block-size", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=500)
    ap.add_argument("--sgd-lr", type=float, default=0.0)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--backend", default="cuda",
                    choices=["dense", "streamed", "cuda"],
                    help="HOperator backend: cuda (the tile kernels), "
                         "streamed or dense")
    ap.add_argument("--tile", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None):
    """CLI entry: parse flags and run the GP path or an LM architecture's."""
    args = build_parser().parse_args(argv)
    if args.arch == "gp-iterative":
        return run_gp(args)
    return run_lm(args)


if __name__ == "__main__":
    main()
