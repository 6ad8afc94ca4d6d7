"""The twin of ``examples/solver_comparison.py`` against the JAX reference,
and ``fit``'s per-step draws.

Each of the example's 12 variants (CG, AP and SGD x standard or pathwise
estimator x cold or warm start, every solve to tolerance 0.01) runs through
the twin's ``run_variant`` at 300 training rows of the elevators stand-in
(a multiple of the 100-row blocks and batches, so nothing is padded), from
the reference's initial state and with the reference's per-step draws
handed over through ``fit``: each cold step's ``kprobe`` probes, each SGD
step's ``ksolve`` schedule, and the standard estimator's eval probes and
eval schedule (``fold_in(key, 7)``). It is held to the reference's ``fit``
built with the config that ``benchmarks/common.py::run_variant`` builds.
Then ``fit`` without draws against a loop of ``outer_step`` from one
generator (bitwise), a resumed fit with draws against an uninterrupted
one, and the example's printed table. One torch thread; the port's
``cuda`` backend runs the kernels' plain versions on these CPU tensors."""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import OuterConfig as JOuterConfig  # noqa: E402
from repro.core import fit as j_fit  # noqa: E402
from repro.core import init_outer_state as j_init  # noqa: E402
from repro.core.estimators import init_probes as j_init_probes  # noqa: E402
from repro.core.outer import _resample_probes as j_resample  # noqa: E402
from repro.data.synthetic import load_dataset as j_load  # noqa: E402
from repro.solvers import NO_EPOCH_BUDGET as J_NO_EPOCH_BUDGET  # noqa: E402
from repro.solvers import SolverConfig as JSolverConfig  # noqa: E402
from repro_torch.core.driver import evaluate, fit  # noqa: E402
from repro_torch.core.outer import (  # noqa: E402
    OuterConfig,
    init_outer_state,
    outer_step,
)
from repro_torch.data.synthetic import Dataset  # noqa: E402
from repro_torch.interop import outer_state_from_numpy  # noqa: E402
from repro_torch.solvers import SolverConfig  # noqa: E402
from test_torch_ap_sgd import _np_state, _port_probes, _schedule  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
MAX_N = 334  # 300 training rows: a multiple of the blocks and batches
STEPS = 3
BLOCK = 100
SCHEDULE = 4096  # SGD indices handed over per solve (>= the iterations run)
# The reference example's rows, in its order.
VARIANTS = [(solver, pathwise, warm) for solver in ("cg", "ap", "sgd")
            for pathwise in (False, True) for warm in (False, True)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensor ops: one intra-op thread beside the other workers of a
    parallel run (restored after)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def twin():
    spec = importlib.util.spec_from_file_location(
        "torch_solver_comparison",
        REPO / "examples" / "torch_solver_comparison.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data():
    """The reference's elevators stand-in and the same arrays as the
    port's `Dataset`."""
    ds = j_load("elevators", max_n=MAX_N)
    tds = Dataset(*(torch.tensor(np.asarray(a)) for a in
                    (ds.x_train, ds.y_train, ds.x_test, ds.y_test)),
                  name="elevators")
    return ds, tds


def _reference_config(solver, pathwise, warm, steps):
    """The config ``benchmarks/common.py::run_variant`` builds at the
    example's settings (to tolerance, no budget)."""
    scfg = JSolverConfig(
        name=solver, tolerance=0.01, max_epochs=J_NO_EPOCH_BUDGET,
        precond_rank=20, block_size=BLOCK, batch_size=BLOCK,
        learning_rate=2.0, record_history=0)
    return JOuterConfig(
        estimator="pathwise" if pathwise else "standard", warm_start=warm,
        num_probes=32, num_rff_pairs=500, solver=scfg, num_steps=steps,
        bm=256, bn=256)


def _reference_draws(jst, x, steps, num_probes, num_pairs):
    """The reference fit's draws from its initial state's key: per step
    ``key, ksolve, kprobe = split(key, 3)`` (fresh probes from ``kprobe``,
    SGD's schedule from ``ksolve``), then the eval's ``fold_in(key, 7)``
    (the standard estimator's eval probes and its SGD schedule)."""
    n, d = x.shape
    key, probes, sched = jst.key, [], []
    for _ in range(steps):
        key, ksolve, kprobe = jax.random.split(key, 3)
        probes.append(_port_probes(j_resample(kprobe, jst.probes, x)))
        sched.append(_schedule(ksolve, n, BLOCK, SCHEDULE))
    ekey = jax.random.fold_in(key, 7)
    eval_probes = _port_probes(j_init_probes(
        ekey, "pathwise", n, d, num_probes, num_pairs,
        kind=jst.params.kernel))
    return {"probes": probes, "batch_idx": sched,
            "eval_probes": [eval_probes],
            "eval_batch_idx": [_schedule(ekey, n, BLOCK, SCHEDULE)]}


@pytest.mark.parametrize("solver,pathwise,warm", VARIANTS)
def test_run_variant_matches_reference_fit(twin, data, solver, pathwise,
                                           warm):
    """One row of the example, 3 steps to tolerance with an evaluation at
    the last, from the reference's initial state and draws: iterations per
    step and cumulative epochs equal, hyperparameters per step within
    1e-4 relative, test LLH and RMSE within 1e-3 relative."""
    ds, tds = data
    x = ds.x_train
    assert x.shape[0] % BLOCK == 0
    jcfg = _reference_config(solver, pathwise, warm, STEPS)
    key = jax.random.PRNGKey(0)
    jres = j_fit(x, ds.y_train, jcfg, key=key, x_test=ds.x_test,
                 y_test=ds.y_test, eval_every=STEPS)
    jst = j_init(key, jcfg, x)
    jh = jres.history
    assert int(jh["iters"].max()) < SCHEDULE
    r = twin.run_variant(
        tds, solver, pathwise, warm, steps=STEPS, sgd_lr=2.0,
        state=outer_state_from_numpy(_np_state(jst)),
        draws=_reference_draws(jst, x, STEPS, 32, 500))
    np.testing.assert_array_equal(r["iters_per_step"], jh["iters"])
    assert r["total_iters"] == int(jh["iters"].sum())
    np.testing.assert_array_equal(r["cum_epochs"], np.cumsum(jh["epochs"]))
    np.testing.assert_allclose(r["hypers"], jh["hypers"], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose([r["test_llh"], r["test_rmse"]],
                               [jh["eval_llh"][-1], jh["eval_rmse"][-1]],
                               rtol=1e-3)
    assert r["final_res_y"] <= 0.01 and r["final_res_z"] <= 0.01


def _small_config(solver, estimator, steps=3):
    scfg = SolverConfig(name=solver, tolerance=0.01, max_epochs=40,
                        precond_rank=10, batch_size=BLOCK,
                        learning_rate=2.0)
    return OuterConfig(estimator=estimator, warm_start=False, num_probes=8,
                       num_rff_pairs=64, solver=scfg, num_steps=steps,
                       backend="cuda")


@pytest.mark.parametrize("solver,estimator", [("sgd", "pathwise"),
                                              ("sgd", "standard"),
                                              ("cg", "standard")])
def test_fit_without_draws_is_a_loop_of_outer_step(data, solver, estimator):
    """Cold start, evaluation at the last step: ``fit`` with no draws
    handed over is bitwise a loop of ``outer_step`` and an ``evaluate``
    drawing from one generator (fresh probes, SGD's schedules, the
    standard estimator's eval probes and eval schedule)."""
    _, tds = data
    x, y = tds.x_train, tds.y_train
    cfg = _small_config(solver, estimator)
    res = fit(x, y, cfg, generator=torch.Generator().manual_seed(5),
              x_test=tds.x_test, y_test=tds.y_test, eval_every=3)
    gen = torch.Generator().manual_seed(5)
    state = init_outer_state(cfg, x, generator=gen)
    hypers, iters = [], []
    for _ in range(3):
        state, m = outer_step(state, x, y, cfg, generator=gen)
        hypers.append(m["hypers"])
        iters.append(m["iters"])
    m = evaluate(x, state, cfg, tds.x_test, tds.y_test, generator=gen)
    assert list(res.history["iters"]) == iters
    assert np.array_equal(res.history["hypers"], np.stack(hypers))
    assert torch.equal(res.state.carry_v, state.carry_v)
    assert res.history["eval_llh"][-1] == m["llh"]
    assert res.history["eval_rmse"][-1] == m["rmse"]
    assert res.history["eval_iters"][-1] == m["iters"]
    assert (m["iters"] > 0) == (estimator == "standard")


def test_resumed_fit_with_draws_equals_uninterrupted(data, tmp_path):
    """SGD, standard estimator, cold start, every draw handed over (from a
    numpy generator), eval and checkpoint every 2 of 4 steps: a fit
    stopped at step 2 and resumed from its checkpoint with the same
    sequences ends bitwise equal to the uninterrupted fit, history
    included; the draws are steps' and evaluations' from the fit's first
    step, and the generator is never drawn from."""
    _, tds = data
    x, y = tds.x_train, tds.y_train
    n, d = x.shape
    cfg4 = _small_config("sgd", "standard", steps=4)
    cfg2 = _small_config("sgd", "standard", steps=2)
    rng = np.random.default_rng(9)

    def probes():
        base = init_outer_state(cfg4, x, generator=torch.Generator()
                                .manual_seed(int(rng.integers(1 << 30))))
        return base.probes

    state = init_outer_state(cfg4, x, generator=torch.Generator().manual_seed(1))
    draws = {"probes": [probes() for _ in range(4)],
             "batch_idx": [rng.integers(0, n // BLOCK, 2000).tolist()
                           for _ in range(4)],
             "eval_probes": [
                 init_outer_state(
                     OuterConfig(estimator="pathwise", num_probes=8,
                                 num_rff_pairs=64), x,
                     generator=torch.Generator().manual_seed(40 + j)).probes
                 for j in range(2)],
             "eval_batch_idx": [rng.integers(0, n // BLOCK, 2000).tolist()
                                for _ in range(2)]}
    kw = dict(x_test=tds.x_test, y_test=tds.y_test, eval_every=2, **draws)
    gen = torch.Generator().manual_seed(7)
    before = gen.get_state()
    full = fit(x, y, cfg4, generator=gen, state=state, **kw)
    assert torch.equal(gen.get_state(), before)
    fit(x, y, cfg2, generator=torch.Generator().manual_seed(7), state=state,
        ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    resumed = fit(x, y, cfg4, generator=torch.Generator().manual_seed(7),
                  state=state, ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    assert torch.equal(resumed.state.carry_v, full.state.carry_v)
    assert np.array_equal(resumed.history["hypers"], full.history["hypers"][2:])
    assert resumed.history["eval_llh"][-1] == full.history["eval_llh"][-1]
    assert list(full.history["eval_step"]) == [2, 4]


def test_main_prints_the_reference_table(twin, capsys):
    """``main()`` at ``--device cpu`` and a tiny size prints the
    reference example's header and its 12 rows in its order and format;
    without ``--device cpu`` it needs a card."""
    rows = twin.main(["--device", "cpu", "--max-n", "120", "--steps", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == (f"{'solver':6s} {'estimator':10s} {'warm':5s} "
                        f"{'epochs':>8s} {'time(s)':>8s} {'LLH':>8s}")
    assert len(lines) == 13 and len(rows) == 12
    for line, (solver, pathwise, warm), r in zip(lines[1:], VARIANTS, rows):
        fields = line.split()
        assert fields[:3] == [solver, "pathwise" if pathwise else "standard",
                              str(warm)]
        assert float(fields[3]) == round(r["total_epochs"], 1)
        assert math.isfinite(float(fields[5]))
        assert len(line) == 6 + 1 + 10 + 1 + 5 + 3 * 9
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            twin.main(["--max-n", "120", "--steps", "1"])
