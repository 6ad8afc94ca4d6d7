"""Shared solver types: config, result, normalisation, budget accounting.

Port of ``repro.solvers.base``. One solver epoch is every entry of H
computed once: CG's iteration is one epoch, an AP or SGD iteration with
block (batch) size b touches an (n x b) slab, b/n of an epoch, so
``max_iters = (n / b) * max_epochs``. Each system ``H u = b`` is solved
normalised, ``b~ = b / (||b|| + eps)``, and rescaled afterwards
(Appendix B). Termination: BOTH the mean-system residual norm and the probe
average must reach the tolerance; SGD also stops on divergence
(:func:`lane_diverged`).

Lanes: every solver takes B independent systems stacked on a leading axis
(one system is B = 1). The loop runs on the host and reads "any lane
active" once per iteration, one device sync for all B lanes, so no
iteration runs after every lane's rule says stop. Each lane re-evaluates
its own rule (:func:`lane_active`, :func:`keep_going`) and every state
update goes through the freeze mask (:func:`freeze`), so a lane that has
stopped keeps its
iterates and counters exactly while the others run on: lane l's trajectory
is a single solve's. Configuration splits as in the reference: the
hashable :class:`SolverConfig` fixes the program (solver, shapes, flags),
and :class:`SolverNumerics` holds the values it merely reads (tolerance,
epoch budget, learning rate, momentum, divergence threshold), scalar or
one per lane.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.obs.trace import stage

NORM_EPS = 1e-10

# Iteration cap for epoch budgets (the reference's int32-safe cap).
MAX_SOLVER_ITERS = 2**30

# "No epoch budget: run to tolerance" for ``max_epochs``; the iteration cap
# clamps it to MAX_SOLVER_ITERS.
NO_EPOCH_BUDGET = float("inf")


@dataclass(frozen=True)
class SolverConfig:
    """Solver configuration (the reference's fields and defaults)."""

    name: str = "cg"  # cg | ap | sgd
    tolerance: float = 0.01
    kind: Optional[str] = None
    max_epochs: float = 1e9
    # CG: pivoted-Cholesky rank; 0 disables, AUTO_RANK (-1) picks per kernel.
    precond_rank: int = 100
    # AP
    block_size: int = 1000
    # SGD
    batch_size: int = 500
    learning_rate: float = 30.0
    momentum: float = 0.9
    # SGD stops once res_y + res_z exceeds this or goes non-finite.
    divergence_threshold: float = float("inf")
    exact_final_residual: bool = False  # SGD: one more full MVM to report
    # Keep the last ``record_history`` per-iteration (res_y, res_z) pairs in
    # a ring (SolveResult.res_history); 0 records nothing.
    record_history: int = 0


# The numeric fields of SolverConfig: what a solver reads, never specialises
# on. They become the SolverNumerics leaves.
NUMERIC_FIELDS = (
    "tolerance", "max_epochs", "learning_rate", "momentum",
    "divergence_threshold",
)


class SolverNumerics(NamedTuple):
    """Numeric solver settings as fp32 tensors: scalar leaves (shared by
    every lane) or (B,) leaves (one value per lane), so a tolerance x
    budget x learning-rate grid runs as lanes of one solve."""

    tolerance: torch.Tensor
    max_epochs: torch.Tensor
    learning_rate: torch.Tensor
    momentum: torch.Tensor
    divergence_threshold: torch.Tensor


def numerics_of(cfg: SolverConfig, dtype=torch.float32) -> SolverNumerics:
    """The config's numeric fields as scalar-leaf numerics (on the host)."""
    return SolverNumerics(*(torch.tensor(getattr(cfg, f), dtype=dtype)
                            for f in NUMERIC_FIELDS))


def strip_numerics(cfg: SolverConfig) -> SolverConfig:
    """The config with its numeric fields reset to the class defaults: the
    static signature that configs differing only in numerics share (the
    group key of ``launch.batch``)."""
    defaults = {f.name: f.default for f in dataclasses.fields(SolverConfig)
                if f.name in NUMERIC_FIELDS}
    return dataclasses.replace(cfg, **defaults)


def stack_numerics(nums: list) -> SolverNumerics:
    """Stack per-cell numerics into (B,) leaves (lane axis 0)."""
    return SolverNumerics(*(torch.stack([torch.as_tensor(v) for v in leaves])
                            for leaves in zip(*nums)))


def broadcast_numerics(num: SolverNumerics, lanes: int) -> SolverNumerics:
    """Scalar leaves broadcast to (lanes,); stacked leaves checked."""
    def one(v):
        v = torch.as_tensor(v)
        if v.ndim == 0:
            return v.expand(lanes)
        if v.shape != (lanes,):
            raise ValueError(
                f"numerics leaf shape {tuple(v.shape)} does not match "
                f"lanes={lanes}")
        return v

    return SolverNumerics(*map(one, num))


def lane_numerics(num: SolverNumerics, lanes: int, device) -> SolverNumerics:
    """(lanes,) fp32 leaves on ``device``: what a lane-stacked solve reads.
    Host leaves are copied without waiting for the device (the copy is
    staged at once), so a solve's set-up does not drain the stream."""
    return SolverNumerics(*(v.to(device=device, dtype=torch.float32,
                                 non_blocking=True)
                            for v in broadcast_numerics(num, lanes)))


def max_iters_lanes(max_epochs: torch.Tensor,
                    iters_per_epoch: float) -> torch.Tensor:
    """Per-lane iteration caps ``iters_per_epoch * max_epochs`` as the
    reference forms them: an fp32 product capped at
    :data:`MAX_SOLVER_ITERS`, then int32."""
    cap = torch.clamp_max(iters_per_epoch * max_epochs.to(torch.float32),
                          float(MAX_SOLVER_ITERS))
    return cap.to(torch.int32)


def max_iters_from_epochs(max_epochs: float, iters_per_epoch: float) -> int:
    """One system's iteration cap, on the host (:func:`max_iters_lanes`)."""
    return int(max_iters_lanes(torch.tensor(max_epochs), iters_per_epoch))


class SolveResult(NamedTuple):
    """What every solver returns: solutions + residuals + budget spent.

    One system: ``v`` (n, t), 0-d residuals, ``iters`` an int, ``epochs`` a
    float. Lanes: a leading B axis on ``v``, the residuals and the ring,
    and ``iters`` (int32) and ``epochs`` (fp32) as (B,) tensors; ``mvms``
    and ``host_syncs`` count the lane-stacked solve's products and reads.
    """

    v: torch.Tensor  # (n, t) solutions [v_y | v_1 .. v_s]
    res_y: torch.Tensor  # final relative residual of the mean system
    res_z: torch.Tensor  # mean relative residual over probe systems
    iters: object  # inner iterations executed (int; (B,) tensor for lanes)
    epochs: object  # solver epochs consumed (float; (B,) tensor for lanes)
    mvms: int = 0  # full H @ V products (CG: iters + 1; AP: 1; SGD: 0 or 1)
    host_syncs: int = 0  # device -> host reads of the stopping rule
    # (H, 2) ring of [res_y, res_z] after each iteration when
    # SolverConfig.record_history = H > 0, else None. Slot ``j % H`` holds
    # the residuals after iteration ``j + 1``; unfilled slots are NaN
    # (:func:`unroll_history` restores time order).
    res_history: Optional[torch.Tensor] = None


def history_init(cfg: SolverConfig, lanes: int, dtype=torch.float32,
                 device=None) -> Optional[torch.Tensor]:
    """Fresh NaN-filled ``(lanes, record_history, 2)`` ring, or None when
    off."""
    if cfg.record_history <= 0:
        return None
    return torch.full((lanes, cfg.record_history, 2), float("nan"),
                      dtype=dtype, device=device)


def history_record(hist: Optional[torch.Tensor], t: int, res_y: torch.Tensor,
                   res_z: torch.Tensor, keep) -> None:
    """Write each lane's ``[res_y, res_z]`` into ring slot ``t % H`` in
    place, through the iteration's freeze ``keep`` (see :func:`masked`).
    ``t`` is the loop's iteration counter before the increment, which every
    active lane shares (a lane never resumes once frozen)."""
    if hist is not None:
        slot = t % hist.shape[1]
        entry = torch.stack([res_y, res_z], dim=-1).to(hist.dtype)
        hist[:, slot] = keep(entry, hist[:, slot])


def unroll_history(hist, iters) -> Optional[np.ndarray]:
    """Host-side: ring -> time-ordered ``(H, 2)`` residual history.

    Row k holds the residuals after iteration ``iters - H + 1 + k`` (NaN
    where the solve finished in fewer than H iterations). A lane-stacked
    ring (B, H, 2) unrolls each lane with its own count.
    """
    if hist is None:
        return None
    hist = hist.cpu().numpy() if isinstance(hist, torch.Tensor) else np.asarray(hist)
    if hist.ndim > 2:
        iters = np.broadcast_to(np.asarray(iters), hist.shape[:-2])
        # torch-lint: disable=trace-host-sync -- recursion over numpy rows: the ring tensor was read once above
        return np.stack([unroll_history(h, i) for h, i in zip(hist, iters)])
    n = int(iters)
    if n <= hist.shape[0]:
        return hist
    return np.roll(hist, -(n % hist.shape[0]), axis=0)


class NormalisedSystem(NamedTuple):
    """Per-column normalised system (Appendix B): b~ = b / (||b|| + eps)."""

    b: torch.Tensor
    v0: torch.Tensor
    scale: torch.Tensor  # (t,) ||b|| + eps per column


def normalise_system(b: torch.Tensor,
                     v0: Optional[torch.Tensor]) -> NormalisedSystem:
    """Normalise each column of ``b`` (and ``v0``) by ``||b|| + eps``;
    (..., n, t) with a (..., t) scale."""
    scale = torch.linalg.vector_norm(b, dim=-2) + NORM_EPS
    col = scale.unsqueeze(-2)
    v0n = torch.zeros_like(b) if v0 is None else v0 / col
    return NormalisedSystem(b=b / col, v0=v0n, scale=scale)


def denormalise(v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Undo :func:`normalise_system`."""
    return v * scale.unsqueeze(-2)


def residual_norms(r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(||r_y||, mean_j ||r_j||) for the normalised batched system (..., n,
    t): one value per lane."""
    norms = torch.linalg.vector_norm(r, dim=-2)
    res_z = torch.mean(norms[..., 1:], dim=-1) if r.shape[-1] > 1 \
        else norms[..., 0]
    return norms[..., 0], res_z


def not_converged(res_y: torch.Tensor, res_z: torch.Tensor,
                  tol: float) -> torch.Tensor:
    """Continue while EITHER system family is above tolerance."""
    return torch.logical_or(res_y > tol, res_z > tol)


def lane_diverged(res_y: torch.Tensor, res_z: torch.Tensor,
                  threshold: float) -> torch.Tensor:
    """The summed residual went past ``threshold`` or is non-finite. With
    the default ``threshold=inf`` only the non-finite arm can fire, and a
    non-finite iterate never recovers."""
    total = res_y + res_z
    return torch.logical_or(~torch.isfinite(total), total > threshold)


def lane_active(t: torch.Tensor, max_iters: torch.Tensor, res_y: torch.Tensor,
                res_z: torch.Tensor, tol: torch.Tensor) -> torch.Tensor:
    """Each lane's own continue predicate: below its iteration cap and
    above its tolerance."""
    return torch.logical_and(t < max_iters, not_converged(res_y, res_z, tol))


def freeze(active: torch.Tensor, new: torch.Tensor,
           old: torch.Tensor) -> torch.Tensor:
    """Per-lane freeze mask: ``new`` where the lane is active, else ``old``
    (``active`` (B,) broadcast over the trailing axes)."""
    return torch.where(active.reshape(active.shape + (1,) * (new.ndim - 1)),
                       new, old)


def masked(active: torch.Tensor, lanes: int):
    """This iteration's freeze as ``keep(new, old)``. With one lane it is
    the identity: a single lane is active whenever its loop body runs."""
    if lanes == 1:
        return lambda new, old: new
    return lambda new, old: freeze(active, new, old)


class LaneSystem(NamedTuple):
    """A solve's inputs as lanes: operator, (B, n, t) right-hand sides and
    warm start, (B,) numerics on the device, and whether the caller passed
    one system (B = 1, squeezed on return)."""

    op: object
    b: torch.Tensor
    v0: Optional[torch.Tensor]
    num: SolverNumerics
    single: bool
    max_epochs: float  # the largest lane's epoch budget, on the host

    @property
    def lanes(self) -> int:
        """B, the number of lanes solved at once."""
        return self.b.shape[0]

    def caps(self, iters_per_epoch: float) -> tuple[torch.Tensor, int]:
        """Per-lane iteration caps on the device, and their largest on the
        host (the loop's bound)."""
        top = max_iters_lanes(torch.tensor(self.max_epochs), iters_per_epoch)
        return (max_iters_lanes(self.num.max_epochs, iters_per_epoch),
                int(top))


def as_lanes(op, b: torch.Tensor, v0: Optional[torch.Tensor],
             cfg: SolverConfig,
             numerics: Optional[SolverNumerics]) -> LaneSystem:
    """Lift one system (2-D ``b``) to B = 1 lanes, or check lane-stacked
    inputs against the operator's lanes; numerics default to the config's."""
    single = b.ndim == 2
    if single:
        op, b = op.lifted(), b[None]
        v0 = None if v0 is None else v0[None]
    elif op.lanes != b.shape[0]:
        raise ValueError(f"{b.shape[0]} lanes of right-hand sides for an "
                         f"operator of {op.lanes} lanes")
    num = numerics if numerics is not None else numerics_of(cfg)
    top = float(torch.as_tensor(num.max_epochs).max())
    return LaneSystem(op, b, v0, lane_numerics(num, b.shape[0], b.device),
                      single, top)


# Lane groups that share one host (``core.driver.fit_batch(mesh=)``, a
# thread each) take turns to issue work: a thread holds the round's turn
# while it issues and gives it up for each blocking read, so that another
# group issues meanwhile and the threads do not hand the interpreter lock
# back and forth op by op.
_turns = threading.local()


@contextlib.contextmanager
def taking_turns(turn: Optional[threading.Lock]):
    """Hold ``turn`` (shared by the lane groups of a round) for the block,
    giving it up at each :func:`host_read`; nothing when ``turn`` is None."""
    if turn is None:
        yield
        return
    with turn:
        _turns.lock = turn
        try:
            yield
        finally:
            _turns.lock = None


@contextlib.contextmanager
def host_read():
    """Give up this thread's turn, if it holds one (:func:`taking_turns`),
    for the block: a read that waits on the device."""
    turn = getattr(_turns, "lock", None)
    if turn is None:
        yield
        return
    _turns.lock = None
    turn.release()
    try:
        yield
    finally:
        turn.acquire()
        _turns.lock = turn


def keep_going(go: torch.Tensor, t: torch.Tensor,
               max_iters: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """This iteration's mask and whether any lane runs it: the lanes whose
    own rule ``go`` holds and whose count is below their cap, as
    :func:`lane_active`. One lane's count is the loop's, whose bound is
    that lane's cap, so its mask is ``go`` alone. One device read for all
    lanes, during which the thread gives up its turn (:func:`host_read`)."""
    if go.shape[0] > 1:
        go = torch.logical_and(go, t < max_iters)
        flag = go.any()
    else:
        flag = go
    with host_read(), stage("solve.read"):
        return go, bool(flag)


def finish(sysl: LaneSystem, v: torch.Tensor, res_y: torch.Tensor,
           res_z: torch.Tensor, t: torch.Tensor, epochs_per_iter: float,
           steps: int, mvms: int, syncs: int, hist: Optional[torch.Tensor],
           extra_epochs: float = 0.0) -> SolveResult:
    """The solve's result, squeezed to one system's when the caller passed
    one (its count is then the loop's, with no device read). With one lane
    ``t`` is not kept: its count is the loop's."""
    if sysl.lanes == 1:
        t = torch.full((1,), steps, dtype=torch.int32, device=v.device)
    if sysl.single:
        return SolveResult(
            v=v[0], res_y=res_y[0], res_z=res_z[0], iters=steps,
            epochs=steps * epochs_per_iter + extra_epochs, mvms=mvms,
            host_syncs=syncs, res_history=None if hist is None else hist[0])
    return SolveResult(
        v=v, res_y=res_y, res_z=res_z, iters=t,
        epochs=t.to(torch.float32) * epochs_per_iter + extra_epochs,
        mvms=mvms, host_syncs=syncs, res_history=hist)
