"""Run the full dry-run sweep: every runnable (arch x shape) x both meshes;
port of ``repro.launch.sweep``.

Each cell runs in a fresh subprocess (``python -m
repro_torch.launch.dryrun``: memory hygiene, and a failing cell cannot
take the others down); completed cells are skipped on re-run, so the
sweep is resumable. As many cells run at once as the host has cores (each
is CPU-bound).

    PYTHONPATH=src python -m repro_torch.launch.sweep --out artifacts/dryrun
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from repro_torch.configs import runnable_cells

_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cell_done(out_dir: str, arch: str, shape: str, mesh: str) -> bool:
    return os.path.exists(os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json"))


def _run(arch: str, shape: str, mesh: str, out: str, timeout: int) -> tuple:
    """(ok, seconds, output tail) of one cell's subprocess."""
    t0 = time.time()
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--out", out]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, env={**os.environ,
                                                 "PYTHONPATH": _SRC})
        ok, tail = r.returncode == 0, (r.stderr or r.stdout)[-2000:]
    except subprocess.TimeoutExpired:
        ok, tail = False, "TIMEOUT"
    return ok, time.time() - t0, tail


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--only-arch", default=None)
    args = ap.parse_args(argv)

    cells = [c for c in runnable_cells() if c[2] == "run"]
    if args.only_arch:
        cells = [c for c in cells if c[0] == args.only_arch]
    todo = []
    for arch, shape, _ in cells:
        for mesh in args.meshes.split(","):
            if cell_done(args.out, arch, shape, mesh):
                print(f"[sweep] skip (done): {arch} x {shape} x {mesh}")
            else:
                todo.append((arch, shape, mesh))
    failures = []
    t_start = time.time()

    def one(cell):
        # one write per line: the cells' threads share stdout
        print(f"[sweep] RUN {' x '.join(cell)}\n", end="", flush=True)
        return cell, _run(*cell, args.out, args.timeout)

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for cell, (ok, dt, tail) in pool.map(one, todo):
            if ok:
                print(f"[sweep] OK  {' x '.join(cell)} ({dt:.0f}s)",
                      flush=True)
            else:
                failures.append(cell)
                print(f"[sweep] FAIL {' x '.join(cell)} ({dt:.0f}s)\n{tail}",
                      flush=True)
    print(f"[sweep] finished in {(time.time()-t_start)/60:.1f} min; "
          f"{len(failures)} failures: {failures}")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "_sweep_status.json"), "w") as f:
        json.dump({"failures": failures}, f)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
