"""The fit loop with evaluation and checkpoints, the lane-batched fit, the
SGD learning-rate grid and the large-dataset initialisation heuristic; port
of ``repro.core.driver``.

``fit`` runs ``cfg.num_steps`` outer steps in rounds of up to
``steps_per_round`` (:func:`repro_torch.core.outer.outer_scan`: the
metrics stay on the device within a round and are read once per round),
never crossing an evaluation or checkpoint boundary, so the trajectory does
not depend on the round size. It keeps the reference's per-step history
(the solve and gradient time split by epoch accounting), evaluates on
``(x_test, y_test)`` every ``eval_every`` steps, checkpoints every
``ckpt_every`` steps and at the end with the reference's restart semantics,
and takes the adaptive budget controller (``budget_policy=``).
``fit_batch`` fits B lanes that share the data and the static config in
one lane-stacked run.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import lanes as lanes_mod
from repro_torch.checkpoint import (
    latest_step,
    load_metadata,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.core.estimators import (
    PATHWISE,
    ProbeState,
    build_system_targets,
    init_probes,
)
from repro_torch.core.outer import (
    OuterConfig,
    OuterState,
    _host_metrics,
    _require_history,
    effective_kind,
    init_outer_state,
    init_outer_state_lanes,
    num_lanes,
    outer_scan,
    unstack_state,
)
from repro_torch.core.predict import pathwise_predict, predictive_metrics
from repro_torch.gp.exact import exact_mll
from repro_torch.gp.hyperparams import HyperParams
from repro_torch.solvers import HOperator, SolverNumerics, solve
from repro_torch.solvers.adaptive import (
    BudgetPolicy,
    broadcast_policy,
    resolve_horizon,
)
from repro_torch.solvers.base import (
    broadcast_numerics,
    max_iters_from_epochs,
    taking_turns,
)
from repro_torch.solvers.sgd import draw_schedule
from repro_torch.train.adam import AdamConfig, adam_init, adam_update

SGD_LR_GRID = [5.0, 10.0, 20.0, 30.0, 50.0, 60.0, 70.0, 80.0, 90.0, 100.0]

# Divergence cut-off of the SGD learning-rate grid (paper Appendix B: "the
# largest learning rate which does not cause divergence"). Systems are
# normalised to ||b~|| = 1, so a cold-started probe solve begins at relative
# residual ~1 per family; res_y + res_z above 2 + 2 after the probe epochs
# means both families grew past twice their start.
SGD_DIVERGENCE_THRESHOLD = 4.0

# Epoch-equivalents charged to gradient assembly when a round's time is
# split into solve and gradient/Adam time (the reference's): the gradient's
# forward touches every entry of H once, its backward ~twice more.
GRAD_EPOCH_EQUIV = 3.0

# Per-step history columns of a round (the reference's, plus the port's
# ``mvms`` and ``host_syncs``), and the evaluation columns.
HISTORY_KEYS = ("res_y", "res_z", "iters", "epochs", "mvms", "host_syncs",
                "hypers", "grad_norm", "data_fit", "step_time_s",
                "solver_frac_iters")
EVAL_KEYS = ("eval_step", "eval_rmse", "eval_llh", "eval_mvms")


@dataclass
class FitResult:
    """What `fit`/`fit_batch` return: final state + per-step history."""

    state: OuterState
    history: dict  # str -> np.ndarray over steps (eval_* over evaluations)
    wall_time_s: float
    solver_time_s: float = 0.0  # estimated inner-solve share (epochs)
    grad_time_s: float = 0.0  # estimated gradient + Adam share


def _sync(x: torch.Tensor) -> None:
    """Wait for the work issued so far on the current stream of ``x``'s
    device: the caller's, or a lane group's own in a sharded
    :func:`fit_batch`, never the other groups' on the same card."""
    if x.device.type == "cuda":
        torch.cuda.current_stream(x.device).synchronize()


def _empty_history() -> dict:
    return {k: [] for k in HISTORY_KEYS + EVAL_KEYS}


def _round_size(step: int, num_steps: int, steps_per_round: int,
                *boundaries: int) -> int:
    """Steps to run this round: capped by ``steps_per_round`` (<= 0 means
    all remaining) and never crossing an eval/checkpoint boundary."""
    k = num_steps - step
    if steps_per_round > 0:
        k = min(k, steps_per_round)
    for every in boundaries:
        if every:
            k = min(k, every - step % every)
    return k


def _append_round(history: dict, metrics: dict, dt: float, k: int,
                  lane: Optional[int] = None, event_log=None,
                  solver: str = "", lane_tag: Optional[int] = None) -> float:
    """Append one round's host metrics (leading axis k steps, then the lane
    axis when ``lane`` is given) to the per-step history; returns the
    round's estimated solve time. The solve vs gradient/Adam split is the
    reference's epoch accounting: each step's ``epochs`` against
    :data:`GRAD_EPOCH_EQUIV` (``solver_frac_iters``). The residual rings
    (``res_history``, time-ordered per step) and the ``budget_*`` columns
    join the history when the metrics carry them.

    With ``event_log`` (a :class:`repro_torch.obs.trace.EventLog`) each
    step emits the reference's ``solve_step`` event (``step, solver, lane,
    res_y, res_z, iters, epochs, step_time_s``, and the step's finite ring
    rows as ``res_history`` when the ring is on), and under a budget policy
    a ``budget_decision`` event with the ``budget_*`` columns; their
    ``lane`` is ``lane_tag`` when given (a group's lane in the whole
    batch), else ``lane``."""
    from repro_torch.solvers.base import unroll_history

    def col(name, dtype=float):
        a = np.asarray(metrics[name])
        if lane is not None and a.ndim > 1:
            a = a[:, lane]
        return np.asarray(a, dtype=dtype)

    epochs = col("epochs", np.float64)
    frac = epochs / (epochs + GRAD_EPOCH_EQUIV)
    iters = col("iters", int)
    history["res_y"].extend(col("res_y"))
    history["res_z"].extend(col("res_z"))
    history["iters"].extend(iters)
    history["epochs"].extend(epochs)
    history["mvms"].extend(col("mvms", int))
    history["host_syncs"].extend(col("host_syncs", int))
    history["hypers"].extend(col("hypers", None))
    history["grad_norm"].extend(col("grad_norm"))
    history["data_fit"].extend(col("data_fit"))
    history["step_time_s"].extend([dt / k] * k)
    history["solver_frac_iters"].extend(frac)
    rings = None
    if "res_history" in metrics:
        # torch-lint: disable=trace-host-sync -- the rings are numpy here (after _host_metrics); unroll_history reads only a tensor
        rings = [unroll_history(h, i)
                 for h, i in zip(col("res_history", None), iters)]
        history.setdefault("res_history", []).extend(rings)
    budget_cols = {name: col(name) for name in metrics
                   if name.startswith("budget_")}
    for name, vals in budget_cols.items():
        history.setdefault(name, []).extend(vals)
    if event_log is not None:
        _emit_round(event_log, metrics, k,
                    lane if lane_tag is None else lane_tag, solver, dt,
                    rings, budget_cols, col)
    return float(np.sum(dt / k * frac))


def _emit_round(event_log, metrics: dict, k: int, lane: Optional[int],
                solver: str, dt: float, rings, budget_cols: dict,
                col) -> None:
    """The reference's per-step ``solve_step`` (and ``budget_decision``)
    events of one round."""
    steps = np.asarray(metrics["step"], dtype=int).reshape(-1)
    res_y, res_z = col("res_y"), col("res_z")
    iters, epochs = col("iters", int), col("epochs", np.float64)
    for j in range(k):
        fields = dict(step=int(steps[j]), solver=solver, lane=lane,
                      res_y=float(res_y[j]), res_z=float(res_z[j]),
                      iters=int(iters[j]), epochs=float(epochs[j]),
                      step_time_s=dt / k)
        if rings is not None:
            row = rings[j]
            # torch-lint: disable=trace-host-sync -- a numpy row of the host rings, not a tensor
            fields["res_history"] = row[np.isfinite(row[:, 0])].tolist()
        event_log.emit("solve_step", **fields)
        if budget_cols:
            event_log.emit("budget_decision", step=int(steps[j]),
                           solver=solver, lane=lane, **{
                               name[len("budget_"):]: float(vals[j])
                               for name, vals in budget_cols.items()})


def fit(
    x: torch.Tensor,
    y: torch.Tensor,
    cfg: OuterConfig,
    generator: Optional[torch.Generator] = None,
    init_params: Optional[HyperParams] = None,
    state: Optional[OuterState] = None,
    x_test: Optional[torch.Tensor] = None,
    y_test: Optional[torch.Tensor] = None,
    eval_every: int = 0,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    resume: bool = True,
    verbose: bool = False,
    steps_per_round: int = 8,
    numerics: Optional[SolverNumerics] = None,
    event_log=None,
    budget_policy: Optional[BudgetPolicy] = None,
) -> FitResult:
    """Run ``cfg.num_steps`` outer MLL steps with optional eval/checkpoints.

    ``generator`` draws the probes of a fresh state, the fresh probes of
    every step without warm starting, SGD's batch schedules and the standard
    estimator's eval probes (a generator on ``x``'s device seeded with 0
    when None).
    ``state`` starts from a given state instead (e.g. the reference's
    initial state carried across by :mod:`repro_torch.interop`).

    The steps run in rounds of up to ``steps_per_round`` (<= 0: all the
    remaining steps), the metrics read once per round; a round never
    crosses an evaluation or checkpoint boundary, and the trajectory does
    not depend on the round size. ``step_time_s`` is the round's time
    (host clock after a device synchronise) over its steps.

    Restart semantics (the reference's): if ``ckpt_dir`` holds a checkpoint
    and ``resume``, training continues from it, carry and probes included;
    the generator's state rides in the checkpoint's sidecar, so a resumed
    fit draws what an uninterrupted one would. Evaluation runs after every
    step that is a multiple of ``eval_every`` (when ``x_test`` is given),
    a checkpoint after every multiple of ``ckpt_every`` and one at the end.

    ``numerics`` (scalar leaves) overrides the solver's numeric settings.
    ``budget_policy`` (a scalar-leaf
    :class:`repro_torch.solvers.adaptive.BudgetPolicy`) turns on the
    adaptive budget controller: each step's ``max_epochs`` is its
    allocation, calibrated from the solver's residual rings, which needs
    ``cfg.solver.record_history >= 2`` (``ValueError`` otherwise); an
    ``AUTO_HORIZON`` horizon becomes ``cfg.num_steps``, the history gains
    the ``budget_*`` columns, and the policy rides across rounds on the
    device. ``event_log`` (a :class:`repro_torch.obs.trace.EventLog`)
    receives one ``solve_step`` event per step (and ``budget_decision``
    under a budget policy, see :func:`_append_round`) and a ``fit_done``
    event at the end, as the reference's.
    """
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    policy = budget_policy
    if policy is not None:
        _require_history(cfg)
        policy = resolve_horizon(policy.to(x.device), cfg.num_steps)
    if state is None:
        state = init_outer_state(cfg, x, init_params=init_params,
                                 generator=generator)
    if ckpt_dir and resume and latest_step(ckpt_dir) is not None:
        state, _ = restore_checkpoint(ckpt_dir, state)
        saved = load_metadata(ckpt_dir).get("generator")
        if saved is not None:
            generator.set_state(torch.tensor(saved, dtype=torch.uint8))

    def checkpoint(step: int) -> None:
        save_checkpoint(ckpt_dir, step, state,
                        metadata={"generator": generator.get_state().tolist()})

    history = _empty_history()
    solver_time = 0.0
    t0 = time.perf_counter()
    while state.step < cfg.num_steps:
        k = _round_size(state.step, cfg.num_steps, steps_per_round,
                        eval_every if x_test is not None else 0,
                        ckpt_every if ckpt_dir else 0)
        ts = time.perf_counter()
        if policy is None:
            state, metrics = outer_scan(state, x, y, cfg, k,
                                        numerics=numerics,
                                        generators=generator)
        else:
            (state, policy), metrics = outer_scan(
                state, x, y, cfg, k, numerics=numerics, budget=policy,
                generators=generator)
        # torch-lint: disable=trace-host-sync -- one synchronise per round of steps, to time the round on the card's clock
        _sync(state.carry_v)
        dt = time.perf_counter() - ts
        # torch-lint: disable=trace-host-sync -- the round's metrics read once per round of steps, one copy per metric
        metrics = _host_metrics(metrics)
        solver_time += _append_round(history, metrics, dt, k,
                                     event_log=event_log,
                                     solver=cfg.solver.name)
        step = state.step
        if eval_every and x_test is not None and step % eval_every == 0:
            m = evaluate(x, state, cfg, x_test, y_test, generator=generator,
                         numerics=numerics)
            for key, val in (("eval_step", step), ("eval_rmse", m["rmse"]),
                             ("eval_llh", m["llh"]), ("eval_mvms", m["mvms"])):
                history[key].append(val)
            if verbose:
                print(f"[fit] step {step}: rmse={m['rmse']:.4f} "
                      f"llh={m['llh']:.4f}", flush=True)
        if ckpt_dir and ckpt_every and step % ckpt_every == 0:
            # torch-lint: disable=trace-host-sync -- the generator's state is a CPU tensor, read at a checkpoint step only
            checkpoint(step)
        if verbose:
            print(f"[fit] step {step}/{cfg.num_steps} "
                  f"res_y={history['res_y'][-1]:.4f} "
                  f"res_z={history['res_z'][-1]:.4f} "
                  f"iters={history['iters'][-1]} ({dt:.2f}s/{k} steps)",
                  flush=True)
    if ckpt_dir:
        checkpoint(cfg.num_steps)
    wall = time.perf_counter() - t0
    hist = {k: np.asarray(v) for k, v in history.items()}
    if event_log is not None:
        event_log.emit(
            "fit_done", solver=cfg.solver.name, num_steps=cfg.num_steps,
            total_iters=int(np.sum(hist["iters"])),
            total_epochs=float(np.sum(hist["epochs"])),
            wall_time_s=wall, solver_time_s=solver_time)
    return FitResult(state=state, history=hist, wall_time_s=wall,
                     solver_time_s=solver_time,
                     grad_time_s=float(np.sum(hist["step_time_s"]))
                     - solver_time)


def _lane_generators(generators, device) -> list:
    """One generator per lane: given, or seeded from ints on ``device``."""
    return [g if isinstance(g, torch.Generator)
            else torch.Generator(device=device).manual_seed(int(g))
            for g in generators]


def fit_batch(
    x: torch.Tensor,
    y: torch.Tensor,
    cfg: OuterConfig,
    generators: Sequence,
    init_params: Optional[HyperParams] = None,
    states: Optional[OuterState] = None,
    x_test: Optional[torch.Tensor] = None,
    y_test: Optional[torch.Tensor] = None,
    verbose: bool = False,
    steps_per_round: int = 0,
    numerics: Optional[SolverNumerics] = None,
    mesh=None,
    event_log=None,
    budget_policy: Optional[BudgetPolicy] = None,
    batch_idx: Optional[Sequence] = None,
) -> list:
    """Fit B scenario lanes sharing one dataset and static config in one
    lane-stacked run: every solver iteration is one launch of each kernel
    for all lanes, and every step one fused backward launch.

    Lanes differ in their draws (``generators``: one ``torch.Generator``
    or one int seed per lane, seeded per cell), optionally in their initial
    hyperparameters (``init_params`` lane-stacked, or shared) or their
    whole initial state (``states``, lane-stacked, e.g. the reference's
    carried across by :mod:`repro_torch.interop`), and optionally in their
    numeric solver settings (``numerics`` with (B,) leaves: a tolerance x
    budget x lr grid). Lane l advances as ``fit`` with lane l's generator,
    state and numerics would (the solvers' freeze mask). ``batch_idx``,
    when given, hands over SGD's block schedules: one (B, iters) array per
    step run, in place of draws from the generators.

    ``mesh`` (a 1-D lane mesh, see
    :func:`repro_torch.launch.mesh.make_lane_mesh`) shards the lanes over
    its positions: B must be a multiple of the mesh size, each position
    runs a contiguous group of B / size lanes (its states, numerics,
    policy, schedules and a copy of x and y on its device) through the
    same lane-stacked rounds, and the histories merge in lane order. The
    groups run at once, as the reference's one sharded program does: each
    round starts one host thread per position, which runs its group's
    round on a CUDA stream of its own on the group's device (on the CPU,
    the thread alone), and joins them all before the histories merge; an
    error in any group is raised after every thread has ended. The
    threads take turns to issue work: a group gives up its turn for each
    host read (the solvers' stopping read, the round's metrics), which
    waits on its own stream only, so another group issues and its kernels
    run meanwhile, on the same card or on another. Each lane's arithmetic
    is the one its group runs alone (``fit_batch`` over the group's lanes,
    no mesh); a group's column split plans round unlike the whole batch's,
    so per-lane results agree with the unsharded run to fp32 accumulation
    order. A mesh of one position runs as ``mesh=None`` does, without
    threads.

    ``steps_per_round <= 0`` (default) runs all steps in one round. No
    checkpoints; per-lane eval once at the end when ``x_test`` is given.
    Each lane's ``wall_time_s`` is the shared wall clock over B, and its
    ``solver_time_s`` splits its share by its own epoch accounting.
    ``budget_policy`` gives every lane the adaptive controller: scalar
    leaves are broadcast, (B,) leaves give each lane its own pool, floor or
    ceiling. ``event_log`` receives lane-tagged ``solve_step`` events
    (see :func:`fit`).
    """
    lanes = len(generators)
    if numerics is not None:
        numerics = broadcast_numerics(numerics, lanes)
    policy = budget_policy
    if policy is not None:
        _require_history(cfg)
        policy = broadcast_policy(resolve_horizon(policy, cfg.num_steps),
                                  lanes)
    if states is not None and num_lanes(states) != lanes:
        raise ValueError(f"{num_lanes(states)} lanes of states for "
                         f"{lanes} generators")
    if mesh is None:
        devices = [x.device]
    else:
        devices = list(mesh.devices)
        if lanes % len(devices) != 0:
            raise ValueError(
                f"lanes={lanes} must be a multiple of the lane-mesh device "
                f"count {len(devices)} (pad the grid or drop --shard-lanes)")
    groups = [_LaneGroup(g, lanes // len(devices), dev, x, y, cfg,
                         generators, init_params, states, numerics, policy)
              for g, dev in enumerate(devices)]
    histories = [_empty_history() for _ in range(lanes)]
    solver_times = [0.0] * lanes
    t0 = time.perf_counter()
    step, done = groups[0].states.step, 0
    while step < cfg.num_steps:
        k = _round_size(step, cfg.num_steps, steps_per_round)
        ts = time.perf_counter()
        rounds = _run_round(groups, cfg, k, None if batch_idx is None
                            else batch_idx[done:done + k])
        dt = time.perf_counter() - ts
        for grp, metrics in zip(groups, rounds):
            for local in range(grp.size):
                lane = grp.lo + local
                solver_times[lane] += _append_round(
                    histories[lane], metrics, dt / lanes, k, lane=local,
                    event_log=event_log, solver=cfg.solver.name,
                    lane_tag=lane)
        step, done = groups[0].states.step, done + k
        if verbose:
            print(f"[fit_batch] step {step}/{cfg.num_steps} x {lanes} lanes "
                  f"({dt:.2f}s/{k} steps)", flush=True)
    wall = time.perf_counter() - t0
    results = []
    for grp in groups:
        for local in range(grp.size):
            lane = grp.lo + local
            lane_state = unstack_state(grp.states, local)
            hist = histories[lane]
            if x_test is not None:
                m = evaluate(grp.x, lane_state, cfg, x_test.to(grp.device),
                             y_test.to(grp.device),
                             generator=grp.gens[local],
                             numerics=None if grp.numerics is None
                             else lanes_mod.lane(grp.numerics, local))
                hist["eval_step"].append(cfg.num_steps)
                hist["eval_rmse"].append(m["rmse"])
                hist["eval_llh"].append(m["llh"])
                hist["eval_mvms"].append(m["mvms"])
            hist = {k_: np.asarray(v) for k_, v in hist.items()}
            results.append(FitResult(
                state=lane_state, history=hist, wall_time_s=wall / lanes,
                solver_time_s=solver_times[lane],
                grad_time_s=float(np.sum(hist["step_time_s"]))
                - solver_times[lane]))
    return results


def _run_round(groups: list, cfg: OuterConfig, k: int, batch_idx) -> list:
    """One round of ``k`` steps of every lane group; their host metrics in
    group order. One group runs in this thread on the caller's stream;
    several run at once, one thread each on the group's own stream
    (:meth:`_LaneGroup.own_stream`), taking turns to issue work
    (:func:`repro_torch.solvers.base.taking_turns`). Every thread is
    joined before the first group's error (in group order) is raised."""
    if len(groups) == 1:
        return [groups[0].run(cfg, k, batch_idx)]
    turn = threading.Lock()
    for grp in groups:
        grp.share_host(turn)
    out, errors = [None] * len(groups), [None] * len(groups)

    def work(i: int) -> None:
        try:
            with groups[i].own_stream():
                out[i] = groups[i].run(cfg, k, batch_idx)
        except BaseException as err:  # raised below, once all are joined
            errors[i] = err

    threads = [threading.Thread(target=work, args=(i,),
                                name=f"fit_batch-group-{i}")
               for i in range(len(groups))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for err in errors:
        if err is not None:
            raise err
    return out


# One stream per (device, lane position), kept across fit_batch calls: the
# caching allocator pools memory per stream, so a fresh stream each call
# would allocate its round's working set from the device anew.
_group_streams: dict = {}
_group_streams_lock = threading.Lock()


def _group_stream(device: torch.device, index: int):
    with _group_streams_lock:
        key = (device, index)
        if key not in _group_streams:
            _group_streams[key] = torch.cuda.Stream(device)
        return _group_streams[key]


def _record(tensors, stream) -> None:
    """Mark every CUDA tensor of ``tensors`` (trees) as used on ``stream``:
    the caching allocator then hands its memory out again only after the
    work issued there so far."""
    for tree in tensors:
        if tree is not None:
            lanes_mod.tree_map(
                lambda t: t.record_stream(stream) if t.is_cuda else None,
                tree)


class _LaneGroup:
    """The contiguous lanes ``[lo, lo + size)`` of a ``fit_batch`` on one
    device: their generators, lane-stacked states, numerics and policy,
    and the data, all there."""

    def __init__(self, index: int, size: int, device, x, y, cfg, generators,
                 init_params, states, numerics, policy):
        lo = self.lo = index * size
        self.size, self.device = size, device
        sl = slice(lo, lo + size)
        self.x, self.y = x.to(device), y.to(device)
        self.gens = _lane_generators(generators[sl], device)
        if states is None:
            if init_params is not None:
                init_params = (init_params if init_params.lanes is None
                               else lanes_mod.tree_map(lambda t: t[sl],
                                                       init_params))
                init_params = lanes_mod.tree_map(lambda t: t.to(device),
                                                 init_params)
            self.states = init_outer_state_lanes(cfg, self.x, self.gens,
                                                 init_params=init_params)
        else:
            self.states = lanes_mod.tree_map(lambda t: t[sl].to(device),
                                             states)
        self.numerics = (None if numerics is None else
                         lanes_mod.tree_map(lambda t: t[sl], numerics))
        self.policy = (None if policy is None else
                       lanes_mod.tree_map(lambda t: t[sl].to(device), policy))
        self.home = self.stream = self.turn = None

    def share_host(self, turn: threading.Lock) -> None:
        """Run beside other groups: issue work only while holding ``turn``
        (shared by the round's groups), on the stream of the group's
        position on its device (none on the CPU), ordered against the
        calling thread's current stream there, which made the states and
        reads the results (see :meth:`own_stream`)."""
        self.turn = turn
        if self.stream is None and self.device.type == "cuda":
            self.home = torch.cuda.current_stream(self.device)
            self.stream = _group_stream(self.device, self.lo // self.size)

    @contextlib.contextmanager
    def own_stream(self):
        """Run the block on the group's device and stream, after the work
        the caller's stream has issued so far, and order the caller's
        stream after it; the group's tensors are recorded on each stream
        that uses them. On the CPU the block runs as it is."""
        if self.stream is None:
            yield
            return
        tensors = (self.x, self.y, self.states, self.numerics, self.policy)
        self.stream.wait_stream(self.home)
        _record(tensors, self.stream)
        try:
            with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
                yield
        finally:
            self.home.wait_stream(self.stream)
            _record((self.states, self.policy), self.home)

    def run(self, cfg: OuterConfig, k: int, batch_idx) -> dict:
        """One round of ``k`` steps, issued in the group's turns when it
        shares the host; its metrics read to the host."""
        sched = (None if batch_idx is None else
                 [np.asarray(b)[self.lo:self.lo + self.size]
                  for b in batch_idx])
        with taking_turns(self.turn):
            if self.policy is None:
                self.states, metrics = outer_scan(
                    self.states, self.x, self.y, cfg, k, lanes=True,
                    numerics=self.numerics, generators=self.gens,
                    batch_idx=sched)
            else:
                (self.states, self.policy), metrics = outer_scan(
                    self.states, self.x, self.y, cfg, k, lanes=True,
                    numerics=self.numerics, budget=self.policy,
                    generators=self.gens, batch_idx=sched)
        _sync(self.states.carry_v)
        return _host_metrics(metrics)


def pick_sgd_learning_rate(
    x: torch.Tensor,
    y: torch.Tensor,
    params: HyperParams,
    cfg: OuterConfig,
    generator: Optional[torch.Generator] = None,
    probes: Optional[ProbeState] = None,
    batch_idx: Optional[Sequence[int]] = None,
    grid=None,
    probe_epochs: float = 3.0,
    halve: bool = False,
    divergence_threshold: float = SGD_DIVERGENCE_THRESHOLD,
    trials: Optional[list] = None,
) -> float:
    """Paper protocol: the largest grid lr whose first-step solve does not
    diverge; ``halve=True`` returns half of it (the large-dataset rule).

    The grid is swept in ascending order; each lr solves the first step's
    system cold for ``probe_epochs`` epochs with the freeze on divergence
    off, and "diverged" reads the FINAL ``res_y + res_z``: non-finite or
    above ``divergence_threshold``. The sweep stops at the first lr that
    diverges. Every lr sees the same probes and the same batch schedule
    (the reference reuses one key): ``probes`` and ``batch_idx`` when
    given, else drawn from ``generator``. ``trials``, when given, receives
    ``(lr, SolveResult)`` for each solve run.
    """
    grid = sorted(grid or SGD_LR_GRID)
    n, d = x.shape
    kind = effective_kind(cfg, params)
    if probes is None:
        probes = init_probes(generator, cfg.estimator, n, d, cfg.num_probes,
                             cfg.num_rff_pairs, kind=kind, dtype=x.dtype,
                             device=x.device)
    base = replace(cfg.solver, name="sgd", max_epochs=probe_epochs, kind=kind,
                   divergence_threshold=float("inf"))
    if batch_idx is None:
        nb = n // base.batch_size
        batch_idx = draw_schedule(
            generator, nb, max_iters_from_epochs(probe_epochs, float(nb)))
    with torch.no_grad():
        targets = build_system_targets(probes, x, y, params)
        op = HOperator(x=x, params=params, kind=kind, backend=cfg.backend,
                       bm=cfg.bm, bn=cfg.bn)
        best = grid[0]
        for lr in grid:
            res = solve(op, targets, None, replace(base, learning_rate=lr),
                        batch_idx=batch_idx)
            if trials is not None:
                trials.append((lr, res))
            # torch-lint: disable=trace-host-sync -- the lr grid reads each trial's residuals to pick the next lr: one read per solve
            r = float(res.res_y) + float(res.res_z)
            if np.isfinite(r) and r < divergence_threshold:
                best = lr
            else:
                break
    return best / 2.0 if halve else best


def nearest_rows(x: torch.Tensor, i: int, size: int) -> torch.Tensor:
    """Indices of the ``size`` rows of ``x`` nearest row ``i`` by squared
    distance, nearest first; a stable sort, so ties keep row order (the
    reference's ``argsort(sum((x - x[i])**2, axis=1))[:size]``)."""
    dist = torch.sum((x - x[i]) ** 2, dim=1)
    return torch.argsort(dist, stable=True)[:size]


def init_hypers_heuristic(
    generator: Optional[torch.Generator],
    x: torch.Tensor,
    y: torch.Tensor,
    subset_size: int = 10_000,
    num_centroids: int = 10,
    num_steps: int = 30,
    adam_lr: float = 0.1,
    kind: str = "matern32",
    centroids: Optional[Sequence[int]] = None,
) -> HyperParams:
    """Large-dataset initialisation heuristic (paper Appendix B / Lin et al.).

    For each of ``num_centroids`` centroid rows: take its ``subset_size``
    nearest rows (:func:`nearest_rows`), start from the paper's initial
    hyperparameters and run ``num_steps`` Adam ascent steps on the EXACT
    subset MLL; return the mean of the results' raw leaves. The centroids
    are ``centroids`` when given (how a test hands over the reference's
    ``randint`` draws), else drawn uniformly from ``generator``. Runs on
    ``x``'s device.
    """
    n, d = x.shape
    subset_size = min(subset_size, n)
    if centroids is None:
        centroids = torch.randint(0, n, (num_centroids,), generator=generator,
                                  device=x.device).tolist()
    if len(centroids) != num_centroids:
        raise ValueError(f"{len(centroids)} centroids given, "
                         f"num_centroids={num_centroids}")
    cfg = AdamConfig(learning_rate=adam_lr)
    acc = None
    for i in centroids:
        idx = nearest_rows(x, i, subset_size)
        xc, yc = x[idx], y[idx]
        params = HyperParams.create(d, dtype=x.dtype, kernel=kind,
                                    device=x.device)
        adam = adam_init(params)
        for _ in range(num_steps):
            leaves = [p.detach().requires_grad_(True) for p in params.leaves]
            with torch.enable_grad():
                mll = exact_mll(xc, yc, params.with_leaves(leaves), kind=kind)
                grads = torch.autograd.grad(mll, leaves)
            with torch.no_grad():
                params, adam = adam_update(params.with_leaves(grads), adam,
                                           params, cfg, maximize=True)
        acc = params.leaves if acc is None else [
            a + p for a, p in zip(acc, params.leaves)]
    return params.with_leaves([a / num_centroids for a in acc])


def evaluate(
    x: torch.Tensor,
    state: OuterState,
    cfg: OuterConfig,
    x_test: torch.Tensor,
    y_test: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    eval_probes: Optional[ProbeState] = None,
    batch_idx: Optional[Sequence[int]] = None,
    numerics: Optional[SolverNumerics] = None,
) -> dict:
    """Test RMSE / mean predictive LLH, and the H MVMs the eval solves took.

    Pathwise estimator: zero extra solves (eq. 16) from the current carry.
    Standard estimator: the s pathwise eval solves the paper charges to the
    standard path (Fig. 1), from zero, with eval probes drawn from
    ``generator`` unless given (``eval_probes``), and SGD's schedule from
    it unless given (``batch_idx``); ``v_y`` comes from the carry.
    ``numerics`` overrides the eval solves' numeric settings.
    """
    kind = effective_kind(cfg, state.params)
    with torch.no_grad():
        if cfg.estimator == PATHWISE:
            v, probes, mvms = state.carry_v, state.probes, 0
        else:
            n, d = x.shape
            if eval_probes is None:
                eval_probes = init_probes(
                    generator, PATHWISE, n, d, state.carry_v.shape[1] - 1,
                    cfg.num_rff_pairs, kind=kind, dtype=x.dtype,
                    device=x.device)
            targets = build_system_targets(
                eval_probes, x, torch.zeros((n,), dtype=x.dtype,
                                            device=x.device), state.params)
            op = HOperator(x=x, params=state.params, kind=kind,
                           backend=cfg.backend, bm=cfg.bm, bn=cfg.bn)
            scfg = (cfg.solver if cfg.solver.kind == kind
                    else replace(cfg.solver, kind=kind))
            res = solve(op, targets[:, 1:], None, scfg, batch_idx=batch_idx,
                        generator=generator, numerics=numerics)
            v = torch.cat([state.carry_v[:, :1], res.v], dim=1)
            probes, mvms = eval_probes, res.mvms
        pred = pathwise_predict(x, x_test, v, probes, state.params, kind=kind)
        m = predictive_metrics(y_test, pred, state.params)
    return {"rmse": float(m["rmse"]), "llh": float(m["llh"]), "mvms": mvms}
