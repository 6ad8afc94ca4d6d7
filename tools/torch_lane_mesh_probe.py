"""What bounds ``fit_batch(mesh=)`` when its lane groups run at once.

    python3 tools/torch_lane_mesh_probe.py [mode ...]   # on a machine with a card

Runs ``chip_smoke.py``'s phase 12 (e) configuration (4 CG lanes at full
pol, Matérn-3/2 x 2 seeds x tolerances 0.01 / 0.05, 10 steps) three ways:
unsharded, the two groups of 2 lanes alone in turn (``fit_batch`` over a
group's lanes, no mesh), and concurrent over 2 virtual ``cuda:0`` lane
positions. Each warmed up once, then timed after a synchronise. Modes (all
by default), one JSON line each:

* ``issue``: three rounds in the order ABC CBA ABC; per round of each
  group, its host wait (inside ``bool()`` of a tensor, ``.cpu()`` and
  ``Stream.synchronize``) and the rest of its wall, its host issue;
* ``turns``: the concurrent run with the round's turn taken and given up
  (as shipped) against free threads (``taking_turns`` a no-op), alternating;
* ``syncs``: every call that synchronises with the card in one unsharded
  run (``torch.cuda.set_sync_debug_mode("warn")``), by source line;
* ``profile``: one run of each under ``torch.profiler``: the card's busy
  seconds (the union of the kernels' intervals) and the kernels' sum;
* ``stalls``: the three runs with a fresh process, after filling the
  caching allocator with 72 GiB, with a fresh stream per call instead of
  one per position, after ``empty_cache``, beside four sleeping pollers
  and beside one thread running Python without pause; each run's device
  allocations and allocation retries;
* ``heap``: beside a 3-million-object heap, the concurrent run at switch
  intervals of 5, 1 and 0.1 ms against the other two, 10 rounds, then
  without the heap.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import sys
import threading
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MODES = ("issue", "turns", "syncs", "profile", "stalls", "heap")


def setup():
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch import lanes as lanes_mod
    from repro_torch.core.driver import fit_batch
    from repro_torch.data.synthetic import load_dataset
    from repro_torch.kernels import tiled
    from repro_torch.launch import batch
    from repro_torch.launch.mesh import make_lane_mesh
    from repro_torch.solvers import stack_numerics

    if not torch.cuda.is_available():
        sys.exit("torch_lane_mesh_probe: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    tiled.build_kernels()
    pol = load_dataset("pol", max_n=0, device="cuda")
    x, y = pol.x_train, pol.y_train
    args = cs._batch_args(dataset="pol", max_n=0, kernels="matern32",
                          seeds=2, tolerances="0.01,0.05", steps=10,
                          device="cuda", shard_lanes=True,
                          out=str(ROOT / "build" / "lane_mesh_probe"))
    cells = batch.make_cells(batch.sweep_archs(["matern32"], args.smoke),
                             [0, 1], args)
    (cfg, members), = batch.group_cells(cells, args).items()
    nums = stack_numerics([batch.cell_numerics(c, args) for c in members])
    seeds = [c.seed for c in members]
    mesh = make_lane_mesh(devices=[torch.device("cuda", 0)] * 2)

    def alone():
        out = []
        for g in range(2):
            sl = slice(2 * g, 2 * g + 2)
            out += fit_batch(x, y, cfg, seeds[sl],
                             numerics=lanes_mod.tree_map(lambda t: t[sl], nums))
        return out

    runs = {"unsharded": lambda: fit_batch(x, y, cfg, seeds, numerics=nums),
            "groups_alone_in_turn": alone,
            "concurrent": lambda: fit_batch(x, y, cfg, seeds, numerics=nums,
                                            mesh=mesh)}
    for fn in runs.values():
        fn()
    return torch, cs, runs


def timed(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def mode_issue(torch, cs, runs):
    from repro_torch.core import driver

    wait = collections.defaultdict(float)
    rounds = []

    def waited(orig):
        def call(*a, **k):
            t = time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                wait[threading.get_ident()] += time.perf_counter() - t
        return call

    patched = [(torch.Tensor, "__bool__"), (torch.Tensor, "cpu"),
               (torch.cuda.Stream, "synchronize"), (driver._LaneGroup, "run")]
    saved = [getattr(o, n) for o, n in patched]
    run = driver._LaneGroup.run

    def run_timed(self, *a):
        tid = threading.get_ident()
        w0, t0 = wait[tid], time.perf_counter()
        out = run(self, *a)
        rounds.append({"lo": self.lo, "round_s": time.perf_counter() - t0,
                       "wait_s": wait[tid] - w0})
        return out

    for (o, n), f in zip(patched[:3], saved[:3]):
        setattr(o, n, waited(f))
    driver._LaneGroup.run = run_timed
    try:
        for rep in range(3):
            for name in list(runs)[::1 if rep % 2 == 0 else -1]:
                rounds.clear()
                wall = timed(torch, runs[name])
                print(json.dumps({"mode": "issue", "run": name, "wall_s": wall,
                                  "wait_s": [r["wait_s"] for r in rounds],
                                  "issue_s": [r["round_s"] - r["wait_s"]
                                              for r in rounds]}), flush=True)
    finally:
        for (o, n), f in zip(patched, saved):
            setattr(o, n, f)


def mode_turns(torch, cs, runs):
    from repro_torch.core import driver

    turns = driver.taking_turns
    try:
        for rep in range(4):
            for mode in ("turns", "free")[::1 if rep % 2 == 0 else -1]:
                driver.taking_turns = turns if mode == "turns" else (
                    lambda turn: contextlib.nullcontext())
                print(json.dumps({"mode": "turns", "threads": mode,
                                  "concurrent_s": timed(torch, runs["concurrent"])}),
                      flush=True)
    finally:
        driver.taking_turns = turns


def mode_syncs(torch, cs, runs):
    sites = collections.Counter()

    def show(*_a, **_k):
        stack = [f"{f.filename.split('src/')[-1]}:{f.lineno}"
                 for f in traceback.extract_stack()[:-1]
                 if "repro_torch" in f.filename]
        sites[" < ".join(stack[-3:][::-1])] += 1

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            runs["unsharded"]()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(json.dumps({"mode": "syncs", "sites": sites.most_common(20)}),
          flush=True)


def mode_profile(torch, cs, runs):
    for name, fn in runs.items():
        print(json.dumps({"mode": "profile", "run": name,
                          **cs._device_busy(torch, fn)}), flush=True)


def mode_stalls(torch, cs, runs):
    from repro_torch.core import driver

    keys = ("num_device_alloc", "num_alloc_retries")

    def measure(case):
        out = {n: [] for n in runs}
        for rep in range(2):
            for name in list(runs)[::1 if rep % 2 == 0 else -1]:
                s0 = torch.cuda.memory_stats()
                t = timed(torch, runs[name])
                s1 = torch.cuda.memory_stats()
                out[name].append([t] + [s1.get(k, 0) - s0.get(k, 0)
                                        for k in keys])
        print(json.dumps({"mode": "stalls", "case": case,
                          "runs_s_allocs_retries": out}), flush=True)

    measure("fresh_process")
    blocks = [torch.empty(2**30, dtype=torch.uint8, device="cuda")
              for _ in range(72)]
    del blocks
    measure("cache_full_72gib")
    stream = driver._group_stream
    driver._group_stream = lambda device, index: torch.cuda.Stream(device)
    try:
        measure("cache_full_fresh_stream_per_call")
    finally:
        driver._group_stream = stream
    torch.cuda.empty_cache()
    measure("after_empty_cache")
    stop = threading.Event()

    def sleeper(dt):
        while not stop.is_set():
            time.sleep(dt)

    def spinner():
        while not stop.is_set():
            sum(range(1000))

    for case, targets in (("beside_4_sleeping_pollers",
                           [(sleeper, (dt,)) for dt in (0.5, 0.5, 0.01, 0.001)]),
                          ("beside_1_python_spinner", [(spinner, ())])):
        stop.clear()
        threads = [threading.Thread(target=f, args=a, daemon=True)
                   for f, a in targets]
        for t in threads:
            t.start()
        measure(case)
        stop.set()
        for t in threads:
            t.join()


def mode_heap(torch, cs, runs):
    junk = [{"a": [i, str(i)], "b": (i, i + 1)} for i in range(3_000_000)]
    cases = [("concurrent", 5e-3), ("concurrent", 1e-3), ("concurrent", 1e-4),
             ("groups_alone_in_turn", 5e-3), ("unsharded", 5e-3)]
    out = collections.defaultdict(list)
    try:
        for _ in range(10):
            for name, interval in cases:
                sys.setswitchinterval(interval)
                out[f"{name}@{interval}"].append(timed(torch, runs[name]))
        del junk
        gc.collect()
        for _ in range(10):
            for interval in (5e-3, 1e-4):
                sys.setswitchinterval(interval)
                out[f"concurrent@{interval}_no_heap"].append(
                    timed(torch, runs["concurrent"]))
    finally:
        sys.setswitchinterval(5e-3)
    print(json.dumps({"mode": "heap", "runs_s": out}), flush=True)


def main(argv) -> int:
    modes = argv or list(MODES)
    unknown = set(modes) - set(MODES)
    if unknown:
        sys.exit(f"torch_lane_mesh_probe: unknown modes {sorted(unknown)}; "
                 f"choose from {MODES}")
    torch, cs, runs = setup()
    print(json.dumps({"card": cs.nvidia_smi()}), flush=True)
    for mode in modes:
        globals()[f"mode_{mode}"](torch, cs, runs)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
