"""Readings that the limits of ``correct`` are set from (not part of a run).

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--mode program|control|unchanged|half_batch|answer]

``program`` runs the cell as ``bench/run.py`` does, with a window of one
segment; ``control`` puts the plain reference in the program's place with
its products in TF32; a fault name plants that fault in the program
(``bench/faults.py``). One JSON line of readings per seed, all seeds in one
process, on the card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=0)
    args = ap.parse_args(argv)

    import contextlib

    from bench import core, faults

    plan = core.plan_cell(core.load_spec(ROOT), args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.mode == "control":
            readings, correct = core.run_control(plan, seed, args.device,
                                                 args.rows), None
        else:
            planted = (contextlib.nullcontext() if args.mode == "program"
                       else faults.plant(args.mode))
            with planted:
                out = core.run_cell(plan, seed, 0.0, False, args.device,
                                    rows=args.rows)
            readings, correct = out["readings"], out["correct"]
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "correct": correct,
                          "seconds": time.perf_counter() - t0,
                          "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
