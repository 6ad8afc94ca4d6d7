"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. It needs as many CUDA cards as the cell asks
for and never falls back to the CPU. The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared with its limit); the last lines of standard error
repeat the checks. A traced run writes its chrome trace under
``bench/out/``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# Top-level module names that must not be loaded in a run: JAX and the JAX
# package the program was ported from.
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench import core

    plan = core.plan_cell(core.load_spec(ROOT), args.workload, ROOT)
    chips = plan.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA card(s); "
              f"cuda available={torch.cuda.is_available()}, "
              f"cards={torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = core.run_cell(plan, args.seed, args.seconds, bool(args.trace),
                        device="cuda", t_start=T_START)
    loaded = sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"bench: modules loaded in the run that must not be: {loaded}",
              file=sys.stderr)
        return 3
    for name, check in out["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
