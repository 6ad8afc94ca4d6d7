"""One run of one cell: set-up, the measured window, the judge, the result.

Everything is found by name. A cell is an entry of ``BENCHMARK.json``'s
``workloads``; its configuration is ``bench/configs/<config>.json``, its
traffic mix ``bench/workloads/<cell>.json``, and each per-layer metric is
read by ``bench/metrics/<metric>.py``'s ``read(ctx)``.

A run makes its inputs from the seed (``bench/data.py``), builds the
program's state from them, and fits ``warmup_steps`` outer steps through
``repro_torch.core.driver.fit`` (``fit_batch`` for lanes) as set-up: the
first step alone, then the rest. The window then runs segments of
``segment_steps`` steps from a fresh copy of that state, again and again,
until ``--seconds`` have passed: each segment fits to its next-to-last
step, then its last step alone, so every segment does the same work
whatever the program's speed. With ``--trace 1`` the window's first
segment runs under ``torch.profiler``. After the window the judge
(``bench/reference/judge.py``) checks the first step, the window's last
step against the plain reference, lane by lane.

Every cell fits with the pathwise estimator and warm starts, the regime
whose targets, gradient and solves the reference works out; the traffic
names the solver, which the reference finds as
``bench/reference/solve_<name>.py``.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import time
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from bench import data, trace
from bench.reference import judge

ROOT = Path(__file__).resolve().parents[1]
OUT = "bench/out"


# -- finding things by name ----------------------------------------------------


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def named(items: list, name: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no entry named {name!r}")


def load_json(root: Path, kind: str, name: str) -> dict:
    return json.loads((Path(root) / "bench" / kind / f"{name}.json").read_text())


def load_metric(root: Path, name: str):
    """``bench/metrics/<name>.py`` as a module (its ``read(ctx)``)."""
    path = Path(root) / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def plan_cell(spec: dict, name: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell's entry, configuration, traffic and metric names."""
    cell = named(spec["workloads"], name)
    traffic = load_json(root, "workloads", name)
    if traffic["traffic"] != cell["traffic"]:
        raise ValueError(f"{name}: traffic file is {traffic['traffic']!r}, "
                         f"BENCHMARK.json says {cell['traffic']!r}")
    e2e = [m["name"] for m in spec["end_to_end"] if reports(m, name)]
    layer = [m["name"] for m in spec["per_layer"]
             if reports(m, name) and m["moves"] in e2e]
    config = load_json(root, "configs", cell["config"])
    if (config["kernel"], config["precision"]) != ("matern32", "float32"):
        raise ValueError(f"{cell['config']}: the reference computes the "
                         "Matérn-3/2 kernel in float32 only")
    return SimpleNamespace(name=name, cell=cell, root=Path(root),
                           config=config, traffic=traffic, end_to_end=e2e,
                           per_layer=layer)


# -- inputs and the program ---------------------------------------------------------


def make_problem(plan, seed: int, device, rows: int = 0) -> tuple:
    """The inputs of one run: (problem for the judge, draws per lane,
    initial raw leaves). ``rows`` > 0 cuts the data (the CPU tests)."""
    cfg, tr = plan.config, plan.traffic
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n_real, d = rows or cfg["n"], cfg["d"]
    x, y = data.make_data(gen, n_real, d, device)
    if "block_size" in tr["solver"]:
        x, y = data.pad_rows(x, y, tr["solver"]["block_size"])
    draws = [data.make_draws(gen, x.shape[0], d, tr["num_probes"],
                             cfg["num_rff_pairs"], device)
             for _ in range(tr["lanes"])]
    prob = {"x": x, "y": y, "n_real": n_real, "solver": dict(tr["solver"]),
            "adam_lr": tr["adam_lr"]}
    return prob, draws, data.initial_raw(d, cfg["init"], device)


class Program:
    """The system under test, driven through its public entry points."""

    def __init__(self, plan, prob: dict, draws: list, raw0: list):
        from repro_torch.core.estimators import ProbeState
        from repro_torch.core.outer import (OuterConfig, init_outer_state,
                                            stack_states)
        from repro_torch.gp.hyperparams import HyperParams
        from repro_torch.gp.rff import RFFState
        from repro_torch.solvers import SolverConfig
        from repro_torch.train.adam import AdamConfig

        tr, kind = plan.traffic, plan.config["kernel"]
        s = dict(tr["solver"])
        if s["max_epochs"] is None:
            s["max_epochs"] = 1e9
        self.cfg = OuterConfig(
            estimator="pathwise", warm_start=True,
            num_probes=tr["num_probes"],
            num_rff_pairs=plan.config["num_rff_pairs"],
            solver=SolverConfig(**s),
            adam=AdamConfig(learning_rate=tr["adam_lr"]), backend="cuda")
        self.x, self.y = prob["x"], prob["y"]
        self.lanes = tr["lanes"]
        self.stack = stack_states
        states = [init_outer_state(
            self.cfg, self.x,
            init_params=HyperParams(*[t.clone() for t in raw0], kernel=kind),
            probes=ProbeState("pathwise", None,
                              RFFState(dr["z"], dr["u"], dr["w"], kind),
                              dr["w_eps"]))
            for dr in draws]
        self.initial = states[0] if self.lanes == 1 else stack_states(states)
        self.gen = torch.Generator(device=self.x.device).manual_seed(0)

    def fit(self, state, upto: int) -> tuple:
        """Fit ``state`` on to step ``upto``; (state, history with
        ``iters`` (steps, lanes), ``host_syncs``, ``res``, ``hypers``)."""
        from repro_torch.core.driver import fit, fit_batch

        cfg = replace(self.cfg, num_steps=upto)
        if self.lanes == 1:
            res = fit(self.x, self.y, cfg, generator=self.gen, state=state)
            results, new = [res], res.state
        else:
            results = fit_batch(self.x, self.y, cfg,
                                generators=list(range(self.lanes)),
                                states=state)
            new = self.stack([r.state for r in results])
        hist = {k: np.stack([np.asarray(r.history[k], dtype=np.float64)
                             .reshape(len(r.history["iters"]), -1)
                             for r in results], axis=1)
                for k in ("iters", "host_syncs", "res_y", "res_z", "hypers")}
        return new, hist

    @staticmethod
    def fresh(state):
        """A copy of everything a step produces anew."""
        from repro_torch import lanes

        return state._replace(params=lanes.tree_map(torch.clone, state.params),
                              adam=lanes.tree_map(torch.clone, state.adam),
                              carry_v=state.carry_v.clone())

    def plain(self, state) -> list:
        """The state as plain tensors, one dict per lane."""
        out = []
        for lane in range(self.lanes):
            def pick(t, lane=lane):
                return t.detach() if self.lanes == 1 else t[lane].detach()
            out.append({"raw": [pick(t) for t in state.params.leaves],
                        "mu": [pick(t) for t in state.adam.mu.leaves],
                        "nu": [pick(t) for t in state.adam.nu.leaves],
                        "step": int(state.adam.step),
                        "v": pick(state.carry_v)})
        return out

    def probes_changed(self, state, draws: list) -> int:
        """Base draws in ``state`` that differ from the harness's."""
        p = state.probes
        got = [p.rff.z, p.rff.u, p.rff.w, p.w_eps]
        changed = 0
        for lane, dr in enumerate(draws):
            for g, key in zip(got, ("z", "u", "w", "w_eps")):
                g = g if self.lanes == 1 else g[lane]
                changed += int(not torch.equal(g, dr[key]))
        return changed


def _merge(*hists) -> dict:
    return {k: np.concatenate([h[k] for h in hists]) for k in hists[0]}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# -- the run --------------------------------------------------------------------------


def run_cell(plan, seed: int, seconds: float, traced: bool, device="cuda",
             t_start: float = None, rows: int = 0) -> dict:
    """Set-up, the window, the judge; the result's fields."""
    t_start = time.perf_counter() if t_start is None else t_start
    tr = plan.traffic
    warm, seg = tr["warmup_steps"], tr["segment_steps"]
    if warm < 1 or seg < 2:
        raise ValueError("a cell needs warmup_steps >= 1 and segment_steps >= 2")
    last = warm + seg
    marks = [("start", time.perf_counter())]
    prob, draws, raw0 = make_problem(plan, seed, device, rows)
    prog = Program(plan, prob, draws, raw0)
    _sync(device)
    marks.append(("inputs", time.perf_counter()))
    s0 = prog.initial
    s1, h_first = prog.fit(prog.fresh(s0), 1)
    _sync(device)
    marks.append(("first_step", time.perf_counter()))
    kept, _ = prog.fit(s1, warm) if warm > 1 else (s1, None)
    if traced:
        trace.warm_up(device)
    _sync(device)
    marks.append(("warm_up", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    # Where set-up went: imports and the card's context before run_cell,
    # then each stage (a slow set-up names its stage in the timing).
    parts = {"before_run_s": marks[0][1] - t_start}
    parts.update({f"{name}_s": t - t0 for (_, t0), (name, t)
                  in zip(marks, marks[1:])})
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()

    hists, walls, traced_seg, steps = [], [], None, 0
    t0 = time.perf_counter()
    while True:
        profile = (trace.profiler(device) if traced and traced_seg is None
                   else contextlib.nullcontext())
        ts = time.perf_counter()
        with profile as prof:
            pre, h1 = prog.fit(prog.fresh(kept), last - 1)
            post, h2 = prog.fit(pre, last)
            _sync(device)
        hist = _merge(h1, h2)
        if prof is not None:
            traced_seg = (prof, time.perf_counter() - ts, hist)
        else:
            walls.append(time.perf_counter() - ts)
        hists.append(hist)
        steps += seg
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0

    window = _merge(*hists)
    pairs = [(prog.plain(s0), prog.plain(s1)),
             (prog.plain(pre), prog.plain(post))]
    changed = prog.probes_changed(post, draws)
    del kept, prog
    if device != "cpu":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    readings = judge_pairs(prob, draws, pairs)
    timing = {"setup_s": setup_s, "setup_parts": parts, "window_s": window_s,
              "judge_s": time.perf_counter() - t_judge}
    readings["probes_changed"] = changed
    readings["res_reported"] = float(max(
        np.max(np.maximum(h["res_y"][-1], h["res_z"][-1]))
        for h in (h_first, h2)))
    readings["nonfinite_steps"] = int(np.sum(~np.all(np.isfinite(
        np.concatenate([window[k] for k in ("res_y", "res_z", "hypers")],
                       axis=-1)), axis=(1, 2))))

    metrics = {}
    if traced:
        t_reduce = time.perf_counter()
        ctx = layer_context(plan, window, traced_seg, seg, prob["x"].shape[0],
                            walls)
        timing["trace_reduce_s"] = time.perf_counter() - t_reduce
        for name in plan.per_layer:
            value = load_metric(plan.root, name).read(ctx)
            if value is not None:
                metrics[name] = {"value": float(value),
                                 "unit": unit_of(plan, name)}
    else:
        e2e = {"step_s": window_s / steps, "setup_s": setup_s,
               "res_norm": readings.get("res_norm")}
        for name in plan.end_to_end:
            if e2e.get(name) is not None:
                metrics[name] = {"value": float(e2e[name]),
                                 "unit": unit_of(plan, name)}
    checks = {name: {"value": readings[name], "limit": limit}
              for name, limit in tr["limits"].items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    out = {"correct": correct, "attempted": steps,
           "failed": readings["nonfinite_steps"], "metrics": metrics,
           "device": device_info(device, peak),
           "readings": readings}
    if traced:
        t = ctx.trace
        out["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        out["breakdown"] = t.breakdown
        t_export = time.perf_counter()
        export_trace(plan, seed, traced_seg[0])
        timing["trace_export_s"] = time.perf_counter() - t_export
    out["timing"] = timing
    out["checks"] = checks
    return out


def judge_pairs(prob: dict, draws: list, pairs: list) -> dict:
    """The worst readings over the judged steps and lanes; the residuals
    of a cell to tolerance at every judged step, of a cell under a budget
    (and its excess over the reference's own solve) at the last."""
    budget = prob["solver"]["max_epochs"] is not None
    worst: dict = {}
    for i, (pre, post) in enumerate(pairs):
        final = i == len(pairs) - 1
        for lane, dr in enumerate(draws):
            r = judge.judge_step(prob, dr, pre[lane], post[lane],
                                 residual=not budget or final,
                                 excess=budget and final)
            for key, value in r.items():
                if key == "res_norm" and not final:
                    continue
                worst[key] = max(worst.get(key, -math.inf), value)
    return worst


def layer_context(plan, window: dict, traced_seg, seg: int, n: int,
                  walls: list) -> SimpleNamespace:
    """What a per-layer metric's ``read`` sees: the window's history, the
    traced segment's history and trace, the system's shape (``n`` rows),
    and ``segment_s``, the mean wall time of the window's untraced segments
    (the same work as the traced one, without the trace's cost on the
    host; the traced segment's own when none ran)."""
    prof, wall, hist = traced_seg
    cfg, tr = plan.config, plan.traffic
    return SimpleNamespace(
        plan=plan, window=window,
        shape=SimpleNamespace(n=n, d=cfg["d"], t=1 + tr["num_probes"],
                              solver=tr["solver"], lanes=tr["lanes"]),
        traced=SimpleNamespace(history=hist, steps=seg),
        trace=trace.reduce(prof, wall),
        segment_s=sum(walls) / len(walls) if walls else wall,
        metric=lambda name: load_metric(plan.root, name))


def unit_of(plan, name: str) -> str:
    spec = load_spec(plan.root)
    return named(spec["end_to_end"] + spec["per_layer"], name)["unit"]


def device_info(device, peak: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak)}


def export_trace(plan, seed: int, prof) -> None:
    out = plan.root / OUT
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / f"{plan.name}.{seed}.trace.json.gz"))


def run_control(plan, seed: int, device="cuda", rows: int = 0) -> dict:
    """The reference in the program's place, its products in TF32 (the
    control): the steps a run takes, from the same inputs, judged as the
    program's are. Its readings."""
    from bench.reference.gp import Arith

    tr = plan.traffic
    last = tr["warmup_steps"] + tr["segment_steps"]
    prob, draws, raw0 = make_problem(plan, seed, device, rows)
    ar = Arith(lower=True)
    shape = (prob["x"].shape[0], 1 + tr["num_probes"])
    runs = []
    for dr in draws:
        states = [{"raw": [r.clone() for r in raw0],
                   "mu": [torch.zeros_like(r) for r in raw0],
                   "nu": [torch.zeros_like(r) for r in raw0], "step": 0,
                   "v": torch.zeros(shape, device=prob["x"].device)}]
        for _ in range(last):
            states.append(judge.reference_step(ar, prob, dr, states[-1]))
        runs.append(states)
    readings = judge_pairs(prob, draws, [([r[a] for r in runs],
                                          [r[b] for r in runs])
                                         for a, b in ((0, 1), (last - 1, last))])
    readings["probes_changed"] = 0
    readings["nonfinite_steps"] = sum(
        not all(bool(torch.isfinite(t).all()) for t in s["raw"])
        for states in runs for s in states[1:])
    return readings
