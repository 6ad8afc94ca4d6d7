"""One-program multi-scenario sweeps: kernel x seed x solver-config grids
as lanes.

Port of ``repro.launch.batch``. Partitions a
``configs.gp_iterative.KERNEL_SWEEP`` x seed x numerics grid by static
signature (kernel, solver, estimator, shapes, preconditioner rank) and runs
each group as ONE lane-stacked fit (:func:`repro_torch.core.driver.fit_batch`):
seeds and the numeric solver settings (tolerance, epoch budget, SGD
learning rate) ride as lanes, so every solver iteration of the group is one
launch of each CUDA kernel for all its lanes, and every outer step one
fused backward launch. A ``--precond-ranks`` grid changes shapes, so each
rank is its own group and its cells carry an ``__rk<r>`` tag. Per-cell
JSON artifacts and ``_sweep_status.json`` keep the reference's names and
keys; done cells are skipped on re-run.

    python -m repro_torch.launch.batch --out artifacts/batch --dataset pol \\
        --max-n 512 --kernels matern12,matern32 --seeds 2 --steps 5 \\
        --smoke --tolerances 0.01,0.05 --device cpu

``num_compiles`` in the status counts the lane-batched programs run, i.e.
the ``fit_batch`` calls (PyTorch compiles nothing per group; the CUDA
kernels are built once per process); ``--expect-one-compile-per-group``
fails the run unless it equals the groups run. ``--isolate`` runs one
subprocess per cell instead (the same artifacts). ``--device`` defaults to
``cuda`` and fails without a card; ``--device cpu`` runs the kernels' plain
versions. ``--shard-lanes`` shards each group's lanes over a 1-D lane
mesh (:func:`repro_torch.launch.mesh.make_lane_mesh`): every visible card
under ``--device cuda``, the one CPU under ``--device cpu``; a group whose
lane count does not divide by the mesh size runs unsharded. The lane
groups of the mesh's positions run in turn (see ``fit_batch``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple, Optional

from repro_torch.configs.gp_iterative import KERNEL_SWEEP, SMOKE, GPArchConfig

# fit_batch calls made by run_batched in this process: the lane-batched
# programs that ``num_compiles`` reports.
FIT_BATCH_CALLS = [0]


class Cell(NamedTuple):
    """One sweep cell: an arch at one seed and one solver setting; ``rank``
    (preconditioner rank) is the one static solver axis a grid may take."""

    arch: GPArchConfig
    seed: int
    tolerance: float
    lr: float
    epochs: float
    rank: int  # preconditioner rank (static: partitions groups)
    tag: str  # filename suffix for the numeric axes ("" for 1-point grids)


def cell_filename(arch_name: str, seed: int, tag: str = "") -> str:
    return f"{arch_name}__s{seed}{tag}.json"


def cell_done(out_dir: str, arch_name: str, seed: int, tag: str = "") -> bool:
    return os.path.exists(
        os.path.join(out_dir, cell_filename(arch_name, seed, tag)))


def sweep_archs(kernels: Optional[list], smoke: bool) -> list:
    """KERNEL_SWEEP entries (optionally filtered), at SMOKE sizes if asked."""
    archs = list(KERNEL_SWEEP)
    if kernels:
        archs = [a for a in archs if a.kind in kernels]
        missing = set(kernels) - {a.kind for a in archs}
        if missing:
            raise KeyError(f"kernels not in KERNEL_SWEEP: {sorted(missing)}")
    if smoke:
        archs = [dataclasses.replace(
            a, num_probes=SMOKE.num_probes, num_rff_pairs=SMOKE.num_rff_pairs,
            solver_epochs=SMOKE.solver_epochs) for a in archs]
    return archs


def _parse_grid(text: Optional[str], default: float) -> list:
    if not text:
        return [default]
    return [float(v) for v in text.split(",")]


def make_cells(archs: list, seeds: list, args) -> list:
    """arch x seed x tolerance x lr x epoch-budget x precond-rank grid, with
    filename tags only for the solver axes that have more than one point;
    raises where two distinct cells would share an artifact name."""
    tols = _parse_grid(args.tolerances, args.tolerance)
    lrs = _parse_grid(args.sgd_lrs, args.sgd_lr)
    budgets = _parse_grid(getattr(args, "epoch_budgets", None), 0.0)
    ranks_text = getattr(args, "precond_ranks", None)
    ranks = ([int(v) for v in ranks_text.split(",")] if ranks_text
             else [None])
    cells, seen = [], set()
    for arch in archs:
        for seed in seeds:
            for tol in tols:
                for lr in lrs:
                    for ep in budgets:
                        for rk in ranks:
                            epochs = ep or float(arch.solver_epochs)
                            rank = rk if rk is not None else arch.precond_rank
                            parts = []
                            if len(tols) > 1:
                                parts.append(f"tol{tol:g}")
                            if len(lrs) > 1:
                                parts.append(f"lr{lr:g}")
                            if len(budgets) > 1:
                                parts.append(f"ep{epochs:g}")
                            if len(ranks) > 1:
                                parts.append(f"rk{rank:g}")
                            tag = "".join("__" + p for p in parts)
                            cell = Cell(arch, seed, tol, lr, epochs, rank, tag)
                            if cell not in seen:
                                seen.add(cell)
                                cells.append(cell)
    by_path: dict = {}
    for c in cells:
        path = cell_filename(c.arch.name, c.seed, c.tag)
        if path in by_path:
            raise ValueError(
                f"grid cells {by_path[path][2:-1]} and {c[2:-1]} collide on "
                f"artifact name {path!r}; choose grid values that differ "
                f"within 6 significant digits")
        by_path[path] = c
    return cells


def solver_config_for(arch: GPArchConfig, args, cell: Optional[Cell] = None):
    """The full per-cell SolverConfig (numeric values included)."""
    from repro_torch.solvers import SolverConfig

    return SolverConfig(
        name=args.solver or arch.solver,
        tolerance=cell.tolerance if cell else args.tolerance,
        kind=arch.kind,
        max_epochs=float(cell.epochs if cell else arch.solver_epochs),
        precond_rank=cell.rank if cell else arch.precond_rank,
        block_size=args.block_size,
        batch_size=args.batch_size,
        learning_rate=cell.lr if cell else args.sgd_lr,
    )


def outer_config_for(arch: GPArchConfig, args, cell: Optional[Cell] = None,
                     static: bool = False):
    """The OuterConfig of one cell; ``static=True`` strips the numeric
    fields (the group key under which a grid's numerics ride as lanes).
    The operator runs on the CUDA kernels (their plain versions for
    ``--device cpu``)."""
    from repro_torch.core.outer import OuterConfig
    from repro_torch.solvers import strip_numerics

    scfg = solver_config_for(arch, args, cell)
    if static:
        scfg = strip_numerics(scfg)
    return OuterConfig(
        estimator=arch.estimator, warm_start=arch.warm_start,
        num_probes=arch.num_probes, num_rff_pairs=arch.num_rff_pairs,
        kind=arch.kind, solver=scfg, num_steps=args.steps, backend="cuda",
        bm=args.bm, bn=args.bn)


def cell_numerics(cell: Cell, args):
    """The cell's numeric settings (scalar-leaf SolverNumerics)."""
    from repro_torch.solvers import numerics_of

    return numerics_of(solver_config_for(cell.arch, args, cell))


def group_cells(cells: list, args) -> dict:
    """Static signature (the numerics-stripped OuterConfig) -> its cells."""
    groups: dict = {}
    for cell in cells:
        key = outer_config_for(cell.arch, args, cell, static=True)
        groups.setdefault(key, []).append(cell)
    return groups


def _load_data(archs: list, args):
    """Shared (x, y) on ``args.device``, padded for every block solver any
    cell runs."""
    from repro_torch.data.synthetic import load_dataset, pad_to_block_multiple

    ds = load_dataset(args.dataset, max_n=args.max_n, split=args.split,
                      device=args.device)
    x, y = ds.x_train, ds.y_train
    solvers = {args.solver or a.solver for a in archs}
    blocks = [args.block_size if s == "ap" else args.batch_size
              for s in solvers if s in ("ap", "sgd")]
    if blocks:
        x, y, _ = pad_to_block_multiple(x, y, math.lcm(*blocks))
    return x, y


def _cell_record(cell: Cell, res, mode: str, group_size: int) -> dict:
    hist = res.history
    return {
        "arch": cell.arch.name,
        "kernel": cell.arch.kind,
        "seed": cell.seed,
        "tolerance": cell.tolerance,
        "learning_rate": cell.lr,
        "max_epochs": cell.epochs,
        "precond_rank": cell.rank,
        "mode": mode,
        "lanes": group_size,
        "wall_time_s": res.wall_time_s,
        "solver_time_s": res.solver_time_s,
        "grad_time_s": res.grad_time_s,
        "final_hypers": [float(v) for v in hist["hypers"][-1]],
        "history": {
            "res_y": [float(v) for v in hist["res_y"]],
            "res_z": [float(v) for v in hist["res_z"]],
            "iters": [int(v) for v in hist["iters"]],
            "epochs": [float(v) for v in hist["epochs"]],
            "solver_frac_iters": [float(v) for v in hist["solver_frac_iters"]],
        },
    }


def _write_cell(out_dir: str, cell: Cell, record: dict):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, cell_filename(cell.arch.name, cell.seed,
                                               cell.tag))
    with open(path, "w") as f:
        json.dump(record, f, indent=2)


def run_batched(cells, x, y, args, on_group=None) -> dict:
    """All groups in this process: one ``fit_batch`` call per group, every
    cell of the group (across archs, seeds and the numeric grid) a lane.
    ``on_group(cfg, cells, results, seconds)``, when given, sees each
    group's results (how ``chip_smoke.py`` reads them)."""
    from repro_torch.core.driver import fit_batch
    from repro_torch.solvers import stack_numerics

    mesh = None
    if args.shard_lanes:
        mesh = lane_mesh(args)
        print(f"[batch] lane mesh: {mesh.size} device(s)")
    calls0 = FIT_BATCH_CALLS[0]
    failures, num_groups, num_cells, sharded_groups = [], 0, 0, 0
    for cfg, members in group_cells(cells, args).items():
        todo = [c for c in members
                if not cell_done(args.out, c.arch.name, c.seed, c.tag)]
        for c in members:
            if c not in todo:
                print(f"[batch] skip (done): {c.arch.name} s{c.seed}{c.tag}")
        if not todo:
            continue
        num_groups += 1
        label = ",".join(sorted({c.arch.name for c in todo}))
        t0 = time.time()
        nums = stack_numerics([cell_numerics(c, args) for c in todo])
        group_mesh = mesh
        if mesh is not None and len(todo) % mesh.size != 0:
            print(f"[batch] note: group {label} has {len(todo)} lanes, not "
                  f"a multiple of {mesh.size} devices; running unsharded")
            group_mesh = None
        try:
            FIT_BATCH_CALLS[0] += 1
            results = fit_batch(x, y, cfg, [c.seed for c in todo],
                                numerics=nums, mesh=group_mesh)
        except Exception as e:  # noqa: BLE001 - the sweep keeps going
            print(f"[batch] FAIL group {label}: {e}", file=sys.stderr)
            failures.extend([(c.arch.name, c.seed, c.tag) for c in todo])
            continue
        dt = time.time() - t0
        if group_mesh is not None:
            sharded_groups += 1
        shard_note = (f", sharded x{mesh.size}" if group_mesh is not None
                      else "")
        print(f"[batch] OK {label} x {len(todo)} lanes ({dt:.1f}s"
              f"{shard_note})", flush=True)
        if on_group is not None:
            on_group(cfg, todo, results, dt)
        for c, res in zip(todo, results):
            _write_cell(args.out, c, _cell_record(c, res, "batched",
                                                  len(todo)))
            num_cells += 1
    # Only claim sharding that happened: a mesh was built and at least one
    # group ran on it.
    return {"failures": failures, "groups": num_groups,
            "num_compiles": FIT_BATCH_CALLS[0] - calls0, "cells": num_cells,
            "mode": "batched",
            "shard_devices": mesh.size if mesh is not None and sharded_groups
            else 0,
            "sharded_groups": sharded_groups}


def lane_mesh(args):
    """The lane mesh of ``--shard-lanes``: every visible card under
    ``--device cuda`` (raises without one), the one CPU under ``--device
    cpu``."""
    import torch

    from repro_torch.launch.mesh import make_lane_mesh

    if torch.device(args.device).type == "cpu":
        return make_lane_mesh(devices=[args.device])
    return make_lane_mesh()


def run_isolated(cells, args, argv_passthrough: list) -> dict:
    """One subprocess per cell; each cell's numerics travel as flags."""
    failures, num_cells = [], 0
    for c in cells:
        if cell_done(args.out, c.arch.name, c.seed, c.tag):
            print(f"[batch] skip (done): {c.arch.name} s{c.seed}{c.tag}")
            continue
        cmd = [
            sys.executable, "-m", "repro_torch.launch.batch",
            "--only-cell", f"{c.arch.kind}:{c.seed}",
            "--tolerance", str(c.tolerance),
            "--sgd-lr", str(c.lr),
            "--solver-epochs", str(c.epochs),
            "--precond-rank", str(c.rank),
        ] + (["--cell-tag", c.tag] if c.tag else []) + argv_passthrough
        src = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        inherited = os.environ.get("PYTHONPATH")
        pypath = src + (os.pathsep + inherited if inherited else "")
        t0 = time.time()
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=args.timeout,
                           env={**os.environ, "PYTHONPATH": pypath})
        dt = time.time() - t0
        if r.returncode == 0:
            num_cells += 1
            print(f"[batch] OK {c.arch.name} s{c.seed}{c.tag} ({dt:.1f}s)",
                  flush=True)
        else:
            failures.append((c.arch.name, c.seed, c.tag))
            print(f"[batch] FAIL {c.arch.name} s{c.seed}{c.tag} ({dt:.1f}s)\n"
                  f"{(r.stderr or r.stdout)[-2000:]}", flush=True)
    return {"failures": failures, "groups": num_cells, "num_compiles": None,
            "cells": num_cells, "mode": "isolated", "shard_devices": 0,
            "sharded_groups": 0}


def single_cell_fit(cell: Cell, args, x, y):
    """The single ``fit`` of one cell: its config with its numerics baked
    in, and a generator seeded with its seed on x's device, as its lane
    of a group draws."""
    import torch

    from repro_torch.core.driver import fit

    cfg = outer_config_for(cell.arch, args, cell)
    gen = torch.Generator(device=x.device).manual_seed(cell.seed)
    return fit(x, y, cfg, generator=gen, steps_per_round=0)


def run_single_cell(archs, args) -> int:
    """--only-cell kernel:seed: one cell in this process (isolate worker)."""
    kind, seed = args.only_cell.rsplit(":", 1)
    matches = [a for a in archs if a.kind == kind]
    if not matches:
        print(f"[batch] unknown cell kernel {kind!r}", file=sys.stderr)
        return 1
    arch = matches[0]
    epochs = float(args.solver_epochs) if args.solver_epochs else float(
        arch.solver_epochs)
    rank = (args.precond_rank if args.precond_rank is not None
            else arch.precond_rank)
    cell = Cell(arch, int(seed), args.tolerance, args.sgd_lr, epochs, rank,
                args.cell_tag)
    x, y = _load_data([arch], args)
    res = single_cell_fit(cell, args, x, y)
    _write_cell(args.out, cell, _cell_record(cell, res, "isolated", 1))
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags and defaults, plus ``--device``."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="artifacts/batch")
    ap.add_argument("--dataset", default="pol")
    ap.add_argument("--max-n", type=int, default=512,
                    help="row cap on the dataset (0 = the full dataset)")
    ap.add_argument("--split", type=int, default=0)
    ap.add_argument("--kernels", default=None,
                    help="comma list (default: every KERNEL_SWEEP kernel)")
    ap.add_argument("--seeds", type=int, default=2,
                    help="seed grid 0..seeds-1 per kernel")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--smoke", action="store_true",
                    help="SMOKE probe/RFF/budget sizes")
    ap.add_argument("--solver", default=None, choices=[None, "cg", "ap", "sgd"],
                    help="override the sweep's solver")
    ap.add_argument("--tolerance", type=float, default=0.01)
    ap.add_argument("--tolerances", default=None,
                    help="comma floats: solver-tolerance grid (lanes of "
                         "each group)")
    ap.add_argument("--block-size", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--sgd-lr", type=float, default=2.0)
    ap.add_argument("--sgd-lrs", default=None,
                    help="comma floats: SGD learning-rate grid (lanes)")
    ap.add_argument("--epoch-budgets", default=None,
                    help="comma floats: solver epoch-budget grid (lanes); "
                         "0 means the arch's default budget")
    ap.add_argument("--precond-ranks", default=None,
                    help="comma ints: preconditioner-rank grid (static: "
                         "each rank is its own group; cells gain an __rk<r> "
                         "tag)")
    ap.add_argument("--shard-lanes", action="store_true",
                    help="shard each group's lanes across the visible cards "
                         "(1-D lane mesh; the one CPU under --device cpu)")
    ap.add_argument("--bm", type=int, default=256)
    ap.add_argument("--bn", type=int, default=256)
    ap.add_argument("--isolate", action="store_true",
                    help="one subprocess per cell")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--only-cell", default=None,
                    help="internal: run one kernel:seed cell in-process")
    ap.add_argument("--solver-epochs", type=float, default=0.0,
                    help="internal (isolate worker): the cell's epoch budget")
    ap.add_argument("--precond-rank", type=int, default=None,
                    help="internal (isolate worker): the cell's "
                         "preconditioner rank")
    ap.add_argument("--cell-tag", default="",
                    help="internal (isolate worker): artifact filename tag")
    ap.add_argument("--expect-one-compile-per-group", action="store_true",
                    help="fail unless fit_batch calls == groups run")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None, on_group=None) -> int:
    """CLI entry; ``on_group`` is passed to :func:`run_batched`."""
    args = build_parser().parse_args(argv)
    kernels = args.kernels.split(",") if args.kernels else None
    archs = sweep_archs(kernels, args.smoke)
    if args.only_cell:
        return run_single_cell(archs, args)
    cells = make_cells(archs, list(range(args.seeds)), args)
    t0 = time.time()
    if args.isolate:
        passthrough = [
            "--out", args.out, "--dataset", args.dataset,
            "--max-n", str(args.max_n), "--split", str(args.split),
            "--steps", str(args.steps),
            "--block-size", str(args.block_size),
            "--batch-size", str(args.batch_size),
            "--bm", str(args.bm), "--bn", str(args.bn),
            "--device", args.device,
        ]
        if args.smoke:
            passthrough.append("--smoke")
        if args.solver:
            passthrough += ["--solver", args.solver]
        status = run_isolated(cells, args, passthrough)
    else:
        x, y = _load_data(archs, args)
        status = run_batched(cells, x, y, args, on_group=on_group)
    status["wall_time_s"] = time.time() - t0
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "_sweep_status.json"), "w") as f:
        json.dump(status, f, indent=2)
    print(f"[batch] {status['cells']} cells in {status['wall_time_s']:.1f}s "
          f"({status['groups']} groups, compiles={status['num_compiles']}, "
          f"{len(status['failures'])} failures)")
    ok = not status["failures"]
    if args.expect_one_compile_per_group and not args.isolate:
        if status["num_compiles"] != status["groups"]:
            print(f"[batch] RETRACE VIOLATION: {status['num_compiles']} "
                  f"fit_batch calls for {status['groups']} groups",
                  file=sys.stderr)
            ok = False
        else:
            print(f"[batch] one lane-batched program per group verified "
                  f"({status['groups']} groups == {status['num_compiles']} "
                  f"fit_batch calls)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
