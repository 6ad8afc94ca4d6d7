"""``fit_batch(mesh=)`` runs its lane groups at once: one host thread per
mesh position (on the card, each on a CUDA stream of its own), as the
reference's one sharded program runs every position's lanes together.

On virtual CPU lane meshes (``make_lane_mesh(devices=["cpu"] * k)``):
every group must enter its round before any group leaves it (a barrier
that the in-turn loop would break), each lane must be bitwise equal to
``fit_batch`` over its group's lanes alone with no mesh (the same
generators, states, numerics and schedules on the same device), and an
error in one group must leave ``fit_batch`` after every thread is joined.
The sharded run against the reference's unsharded ``fit_batch`` is
``tests/test_torch_distributed.py``'s."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import lanes as lanes_mod  # noqa: E402
from repro_torch.core import driver  # noqa: E402
from repro_torch.core.driver import fit_batch  # noqa: E402
from repro_torch.core.outer import OuterConfig  # noqa: E402
from repro_torch.launch.mesh import make_lane_mesh  # noqa: E402
from repro_torch.solvers import SolverConfig, stack_numerics  # noqa: E402
from repro_torch.solvers.base import (  # noqa: E402
    host_read,
    numerics_of,
    taking_turns,
)

LANES = 4
N, D = 64, 2
HISTORY = ("iters", "res_y", "res_z", "hypers", "epochs", "mvms")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops per solver iteration; one torch thread beside
    the other workers of a parallel run, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(solver: str):
    """64 rows, d = 2, from a numpy seed; a 3-step pathwise warm config
    and one numerics per lane (CG: tolerances; SGD: learning rates, with a
    block schedule per step and lane)."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-2.0, 2.0, size=(N, D)).astype(np.float32)
    y = (np.sin(2.0 * x[:, 0]) * np.cos(x[:, 1])
         + 0.2 * rng.normal(size=N)).astype(np.float32)
    if solver == "cg":
        base = dict(name="cg", max_epochs=30, precond_rank=0)
        grid = [dict(tolerance=t) for t in (0.01, 0.05, 0.02, 0.1)]
        sched = None
    else:
        base = dict(name="sgd", tolerance=0.01, max_epochs=4, batch_size=16)
        grid = [dict(learning_rate=lr) for lr in (0.2, 0.5, 0.3, 0.4)]
        sched = [rng.integers(0, N // 16, size=(LANES, 16)) for _ in range(3)]
    cfg = OuterConfig(estimator="pathwise", warm_start=True, num_steps=3,
                      num_probes=3, num_rff_pairs=32, bm=32, bn=32,
                      solver=SolverConfig(**base), backend="cuda")
    nums = stack_numerics([numerics_of(SolverConfig(**base, **g))
                           for g in grid])
    return torch.tensor(x), torch.tensor(y), cfg, nums, sched


def _leaves(tree) -> list:
    out = []
    lanes_mod.tree_map(out.append, tree)
    return out


def _assert_lane_equal(got, want, tag):
    for a, b in zip(_leaves(got.state), _leaves(want.state), strict=True):
        assert torch.equal(a, b), f"{tag}: state"
    for key in HISTORY:
        np.testing.assert_array_equal(got.history[key], want.history[key],
                                      err_msg=f"{tag}: {key}")


@pytest.mark.parametrize("solver", ["cg", "sgd"])
@pytest.mark.parametrize("k", [2, 4])
def test_each_lane_is_its_group_run_alone(k, solver):
    """Every lane of the k-position run is bitwise its group's lanes run
    alone, with no mesh: state, hypers and residual histories."""
    x, y, cfg, nums, sched = _problem(solver)
    seeds = list(range(10, 10 + LANES))
    got = fit_batch(x, y, cfg, seeds, numerics=nums, batch_idx=sched,
                    mesh=make_lane_mesh(devices=["cpu"] * k))
    per = LANES // k
    for g in range(k):
        sl = slice(g * per, (g + 1) * per)
        alone = fit_batch(
            x, y, cfg, seeds[sl],
            numerics=lanes_mod.tree_map(lambda t: t[sl], nums),
            batch_idx=None if sched is None else [b[sl] for b in sched])
        for i, want in enumerate(alone):
            _assert_lane_equal(got[g * per + i], want,
                               f"k={k} group {g} lane {i}")


def test_groups_run_their_rounds_at_once(monkeypatch):
    """Each group waits at a barrier of 2 before its round: the in-turn
    loop would break it (the first group waits alone, 10 s); at once, both
    rounds of both steps pass it."""
    x, y, cfg, nums, _ = _problem("cg")
    barrier = threading.Barrier(2, timeout=10)
    run = driver._LaneGroup.run

    def waiting_run(self, *args):
        barrier.wait()
        return run(self, *args)

    monkeypatch.setattr(driver._LaneGroup, "run", waiting_run)
    got = fit_batch(x, y, cfg, list(range(LANES)), numerics=nums,
                    steps_per_round=2,
                    mesh=make_lane_mesh(devices=["cpu"] * 2))
    assert len(got) == LANES and not barrier.broken
    assert all(len(r.history["iters"]) == cfg.num_steps for r in got)


def test_a_failing_group_raises_after_every_thread_is_joined(monkeypatch):
    """The second group raises; ``fit_batch`` raises that error, and only
    after the first group's slower round has ended."""
    x, y, cfg, nums, _ = _problem("cg")
    run = driver._LaneGroup.run
    ended = []

    class GroupFailed(RuntimeError):
        pass

    def failing_run(self, *args):
        if self.lo > 0:
            raise GroupFailed(f"group at lane {self.lo}")
        time.sleep(0.3)
        out = run(self, *args)
        ended.append(self.lo)
        return out

    monkeypatch.setattr(driver._LaneGroup, "run", failing_run)
    before = {t.ident for t in threading.enumerate()}
    with pytest.raises(GroupFailed, match="group at lane 2"):
        fit_batch(x, y, cfg, list(range(LANES)), numerics=nums,
                  mesh=make_lane_mesh(devices=["cpu"] * 2))
    assert ended == [0]
    assert {t.ident for t in threading.enumerate()} <= before


def test_a_host_read_hands_the_turn_to_another_group():
    """A thread that holds the round's turn keeps another from issuing
    until it reads the host; after the read it waits for the turn again.
    Outside a turn, and nested in a read, ``host_read`` does nothing."""
    turn, order, issued = threading.Lock(), [], threading.Event()

    def other():
        with taking_turns(turn):
            order.append("other issues")
            issued.set()

    with host_read():
        pass
    with taking_turns(turn):
        thread = threading.Thread(target=other)
        thread.start()
        order.append("first issues")
        assert not issued.wait(0.2)
        with host_read():
            with host_read():
                assert issued.wait(10)
        order.append("first issues again")
    thread.join()
    assert order == ["first issues", "other issues", "first issues again"]
    assert not turn.locked()
