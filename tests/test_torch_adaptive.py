"""The port's adaptive budgets (``repro_torch.solvers.adaptive``) against the
JAX reference: every function on seeded residual rings (wrapped, short and
empty rings, NaN slots, the flat-slope fallback, the stall rule), one lane
at a time and lane-stacked against ``vmap`` of the reference;
``fit(budget_policy=)`` against the reference's from its initial state;
budget lanes of ``fit_batch`` against single budgeted fits; and the error
below ``MIN_RECORD_HISTORY``. Both sides compute in fp32: values within
rtol 1e-5 / atol 1e-6 (NaN where the reference has NaN), integer counters
exact; fits: iterations equal, the allocations within rtol 1e-2 (they
are functions of the residual rings, which the reference's own lane tests
hold to rtol 1e-2), hyperparameters within rtol 1e-4 / atol 1e-6."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import OuterConfig as JOuterConfig  # noqa: E402
from repro.core import fit as j_fit  # noqa: E402
from repro.core.outer import init_outer_state as j_init  # noqa: E402
from repro.data.synthetic import make_gp_regression  # noqa: E402
from repro.solvers import SolverConfig as JSolverConfig  # noqa: E402
from repro.solvers import adaptive as ja  # noqa: E402
from repro.solvers.base import SolverNumerics as JNumerics  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.driver import fit, fit_batch  # noqa: E402
from repro_torch.core.outer import OuterConfig, outer_step_budget  # noqa: E402
from repro_torch.solvers import SolverConfig  # noqa: E402
from repro_torch.solvers import adaptive as ta  # noqa: E402
from repro_torch.solvers.base import SolverNumerics  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
HYP_RTOL, HYP_ATOL = 1e-4, 1e-6
H = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensor ops: one intra-op thread beside the other workers of a
    parallel run (restored after)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, ref, err=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref, dtype=got.dtype),
                               rtol=RTOL, atol=ATOL, equal_nan=True,
                               err_msg=err)


def _ring(rng, iters, h=H, decay=0.7, noise=0.05, nan_slot=None):
    """The ring a solve of ``iters`` iterations writes: slot (j - 1) % H
    holds iteration j's [res_y, res_z], a noisy geometric decay; unwritten
    slots NaN."""
    ring = np.full((h, 2), np.nan, np.float32)
    for j in range(1, iters + 1):
        base = decay ** j * np.exp(noise * rng.normal(size=2))
        ring[(j - 1) % h] = base * np.array([1.0, 1.3])
    if nan_slot is not None:
        ring[nan_slot] = np.nan
    return ring


# (iters, decay, noise, nan slot): wrapped, short, empty, one iteration, a
# NaN slot in a wrapped ring, a flat slope, a growing residual.
RINGS = [(23, 0.7, 0.05, None), (5, 0.8, 0.02, None), (0, 0.7, 0.0, None),
         (1, 0.7, 0.0, None), (17, 0.75, 0.05, 3), (12, 1.0, 0.0, None),
         (9, 1.2, 0.0, None)]


def _tree(fields, values):
    return {f: np.asarray(v) for f, v in zip(fields, values)}


@pytest.mark.parametrize("case", range(len(RINGS)))
def test_fit_decay_predict_and_noise_match_reference(case):
    iters, decay, noise, nan_slot = RINGS[case]
    ring = _ring(np.random.default_rng(case), iters, decay=decay, noise=noise,
                 nan_slot=nan_slot)
    jf = ja.fit_decay(jnp.asarray(ring), jnp.int32(iters))
    tf = ta.fit_decay(torch.tensor(ring), torch.tensor(iters, dtype=torch.int32))
    for name, a, b in zip(ta.DecayFit._fields, tf, jf):
        _close(a, b, name)
    for epi, lf, lt in ((1.0, 0.0, np.log(0.01)), (0.05, -1.0, -6.0)):
        _close(ta.predict_epochs(tf, epi, lf, lt),
               ja.predict_epochs(jf, epi, lf, lt))
    for res_z, tol in ((0.3, 0.01), (0.001, 0.01)):
        for a, b in zip(ta.noise_probe(tf, res_z, tol),
                        ja.noise_probe(jf, res_z, tol)):
            _close(a, b)


def test_flat_slope_predicts_infinity_and_falls_back():
    """A flat ring: slope 0, predict_epochs inf, and budget_allocate's
    fixed-budget fallback min(ceiling, max_epochs), as the reference."""
    ring = _ring(np.random.default_rng(0), 12, decay=1.0, noise=0.0)
    tf = ta.fit_decay(torch.tensor(ring), torch.tensor(12))
    assert float(tf.slope) == 0.0
    assert float(ta.predict_epochs(tf, 1.0, 0.0, -4.0)) == float("inf")
    pol = ta.make_budget_policy(ceiling=7.0)._replace(
        fits_seen=torch.tensor(1, dtype=torch.int32))
    num = SolverNumerics(*map(torch.tensor, (0.01, 20.0, 30.0, 0.9, np.inf)))
    alloc, pred = ta.budget_allocate(pol, num)
    assert float(alloc) == 7.0 and np.isnan(float(pred))


def _policies():
    """Fresh, mid-run and stalled policy states (the reference's leaves)."""
    fresh = dict(pool=np.inf, slope=0.0, noise=0.0, perturbation=0.0,
                 last_res=np.inf, steps_seen=0, fits_seen=0, floor=1.0,
                 ceiling=np.inf, margin=1.0, safety=1.5, ema=0.7,
                 horizon=10.0)
    mid = dict(fresh, pool=40.0, slope=-0.9, noise=0.1, perturbation=0.02,
               last_res=0.008, steps_seen=3, fits_seen=2, ceiling=12.0)
    stalled = dict(mid, slope=-0.05, last_res=0.001, perturbation=0.0005,
                   steps_seen=6, fits_seen=1, horizon=0.0)
    late = dict(mid, steps_seen=9, horizon=10.0, margin=3.0)
    return [fresh, mid, stalled, late]


def _pair(leaves):
    ints = ("steps_seen", "fits_seen")
    jp = ja.BudgetPolicy(**{k: jnp.asarray(v, jnp.int32 if k in ints
                                           else jnp.float32)
                            for k, v in leaves.items()})
    tp = ta.BudgetPolicy(**{k: torch.tensor(v, dtype=torch.int32 if k in ints
                                            else torch.float32)
                            for k, v in leaves.items()})
    return jp, tp


@pytest.mark.parametrize("which", range(4))
def test_policy_functions_match_reference(which):
    """step_target, budget_allocate and budget_observe (a decaying, a
    growing and an empty ring) on fresh, mid-run, stalled and late
    policies, and resolve_horizon."""
    jp, tp = _pair(_policies()[which])
    num = (0.01, 15.0, 30.0, 0.9, np.inf)
    jn = JNumerics(*(jnp.float32(v) for v in num))
    tn = SolverNumerics(*(torch.tensor(v, dtype=torch.float32) for v in num))
    _close(ta.step_target(tp, 0.01), ja.step_target(jp, 0.01))
    for a, b in zip(ta.budget_allocate(tp, tn), ja.budget_allocate(jp, jn)):
        _close(a, b)
    for k, (iters, decay) in enumerate(((14, 0.7), (6, 1.3), (0, 0.7))):
        ring = _ring(np.random.default_rng(10 + k), iters, decay=decay)
        res = (float(0.7 ** iters), float(0.7 ** iters * 1.3)) if iters else (
            0.5, 0.6)
        epochs = iters * 0.25
        jnew, jd = ja.budget_observe(jp, jnp.asarray(ring), jnp.int32(iters),
                                     jnp.float32(epochs), *map(jnp.float32, res),
                                     jnp.float32(0.01))
        tnew, td = ta.budget_observe(tp, torch.tensor(ring),
                                     torch.tensor(iters, dtype=torch.int32),
                                     torch.tensor(epochs), *map(torch.tensor, res),
                                     torch.tensor(0.01))
        for name, a, b in zip(ta.BudgetPolicy._fields, tnew, jnew):
            _close(a, b, name)
        assert set(td) == set(jd)
        for name in jd:
            _close(td[name], jd[name], name)
    _close(ta.resolve_horizon(tp, 25).horizon,
           ja.resolve_horizon(jp, 25).horizon)


def test_make_and_broadcast_policy_match_reference():
    jp = ja.make_budget_policy(pool=50.0, floor=2.0, ceiling=9.0, margin=2.0)
    tp = ta.make_budget_policy(pool=50.0, floor=2.0, ceiling=9.0, margin=2.0)
    for name, a, b in zip(ta.BudgetPolicy._fields, tp, jp):
        _close(a, b, name)
        assert a.dtype == (torch.int32 if name in ("steps_seen", "fits_seen")
                           else torch.float32)
    stacked = tp._replace(floor=torch.tensor([1.0, 2.0, 3.0]))
    jb = ja.broadcast_policy(jp._replace(floor=jnp.asarray([1.0, 2.0, 3.0])), 3)
    for a, b in zip(ta.broadcast_policy(stacked, 3), jb):
        _close(a, b)
    with pytest.raises(ValueError):
        ta.broadcast_policy(stacked, 4)


def test_lane_stacked_policy_matches_vmapped_reference():
    """Four lanes of rings and policies at once against vmap of the
    reference: fit_decay, budget_allocate and budget_observe."""
    rng = np.random.default_rng(3)
    iters = np.array([23, 5, 0, 9], np.int32)
    rings = np.stack([_ring(rng, int(i), decay=d)
                      for i, d in zip(iters, (0.7, 0.8, 0.7, 1.2))])
    leaves = _policies()
    stacked = {k: np.stack([np.asarray(p[k]) for p in leaves])
               for k in leaves[0]}
    jp, tp = _pair(stacked)
    num = (0.01, 15.0, 30.0, 0.9, np.inf)
    jn = JNumerics(*(jnp.full(4, v, jnp.float32) for v in num))
    tn = SolverNumerics(*(torch.full((4,), v) for v in num))
    jf = jax.vmap(ja.fit_decay)(jnp.asarray(rings), jnp.asarray(iters))
    tf = ta.fit_decay(torch.tensor(rings), torch.tensor(iters))
    for name, a, b in zip(ta.DecayFit._fields, tf, jf):
        _close(a, b, name)
    for a, b in zip(ta.budget_allocate(tp, tn),
                    jax.vmap(ja.budget_allocate)(jp, jn)):
        _close(a, b)
    res = np.abs(rng.normal(size=(2, 4))).astype(np.float32) * 0.01
    epochs = iters.astype(np.float32) * 0.5
    jnew, _ = jax.vmap(ja.budget_observe)(
        jp, jnp.asarray(rings), jnp.asarray(iters), jnp.asarray(epochs),
        jnp.asarray(res[0]), jnp.asarray(res[1]), jnp.full(4, 0.01))
    tnew, _ = ta.budget_observe(tp, torch.tensor(rings), torch.tensor(iters),
                                torch.tensor(epochs), torch.tensor(res[0]),
                                torch.tensor(res[1]), torch.full((4,), 0.01))
    for name, a, b in zip(ta.BudgetPolicy._fields, tnew, jnew):
        _close(a, b, name)


# -- budgeted fits ---------------------------------------------------------------


def _np_params(p):
    return {"raw_lengthscales": np.asarray(p.raw_lengthscales),
            "raw_signal": np.asarray(p.raw_signal),
            "raw_noise": np.asarray(p.raw_noise), "kernel": p.kernel}


def _np_state(st):
    pr = st.probes
    return {"params": _np_params(st.params),
            "adam": {"step": np.asarray(st.adam.step),
                     "mu": _np_params(st.adam.mu),
                     "nu": _np_params(st.adam.nu)},
            "probes": {"estimator": pr.estimator, "z": None,
                       "rff": {"z": np.asarray(pr.rff.z),
                               "u": np.asarray(pr.rff.u),
                               "w": np.asarray(pr.rff.w), "kind": pr.rff.kind},
                       "w_eps": np.asarray(pr.w_eps)},
            "carry_v": np.asarray(st.carry_v), "step": np.asarray(st.step)}


SOLVER = dict(name="cg", tolerance=0.01, max_epochs=30, precond_rank=0,
              record_history=16)
COMMON = dict(estimator="pathwise", warm_start=True, num_probes=4,
              num_rff_pairs=64, num_steps=5, bm=64, bn=64)


@pytest.fixture(scope="module")
def budget_problem():
    x, y = make_gp_regression(jax.random.PRNGKey(2), 64, 2, noise=0.3)
    return np.asarray(x), np.asarray(y)


def test_budgeted_fit_matches_reference(budget_problem):
    """fit(budget_policy=) from the reference's initial state, 5 CG steps
    with a 16-slot ring, against the reference's: iterations, the
    allocations per step within rtol 1e-2 (fitted to residual rings that
    agree to the residuals' rtol 1e-2), hyperparameters rtol 1e-4 / atol
    1e-6; the first step falls back to the fixed budget and later steps
    run on the fitted decay model."""
    x, y = budget_problem
    jcfg = JOuterConfig(solver=JSolverConfig(**SOLVER), backend="streamed",
                        **COMMON)
    tcfg = OuterConfig(solver=SolverConfig(**SOLVER), backend="cuda", **COMMON)
    key = jax.random.PRNGKey(5)
    kw = dict(floor=2.0, ceiling=12.0, margin=2.0)
    ref = j_fit(jnp.asarray(x), jnp.asarray(y), jcfg, key=key,
                budget_policy=ja.make_budget_policy(**kw))
    state = interop.outer_state_from_numpy(_np_state(j_init(key, jcfg,
                                                            jnp.asarray(x))))
    got = fit(torch.tensor(x), torch.tensor(y), tcfg, state=state,
              budget_policy=ta.make_budget_policy(**kw), steps_per_round=2)
    jh, th = ref.history, got.history
    np.testing.assert_array_equal(th["iters"], jh["iters"])
    np.testing.assert_allclose(th["budget_alloc"], jh["budget_alloc"],
                               rtol=1e-2)
    np.testing.assert_allclose(th["hypers"], jh["hypers"], rtol=HYP_RTOL,
                               atol=HYP_ATOL)
    assert jh["budget_alloc"][0] == 12.0 and th["res_history"].shape == (5, 16, 2)
    for name in jh:
        if name.startswith("budget_"):
            assert name in th, name


def test_budget_lanes_match_single_budgeted_fits(budget_problem):
    """Port only: fit_batch(budget_policy=) with a per-lane ceiling (a
    (B,) leaf) against each lane's single fit(budget_policy=): iterations
    and allocations equal per step, hyperparameters within rtol 1e-5; and
    outer_step_budget for one system gives the first step's allocation."""
    x, y = map(torch.tensor, budget_problem)
    cfg = OuterConfig(solver=SolverConfig(**SOLVER), backend="cuda", **COMMON)
    ceilings = (6.0, 12.0)
    pol = ta.make_budget_policy(floor=2.0, margin=2.0)
    lanes = fit_batch(x, y, cfg, [7, 8], budget_policy=pol._replace(
        ceiling=torch.tensor(ceilings)))
    for i, c in enumerate(ceilings):
        one = fit(x, y, cfg, generator=torch.Generator().manual_seed(7 + i),
                  budget_policy=pol._replace(ceiling=torch.tensor(c)))
        np.testing.assert_array_equal(lanes[i].history["iters"],
                                      one.history["iters"])
        np.testing.assert_array_equal(lanes[i].history["budget_alloc"],
                                      one.history["budget_alloc"])
        np.testing.assert_allclose(lanes[i].history["hypers"],
                                   one.history["hypers"], rtol=1e-5,
                                   atol=HYP_ATOL)
        assert lanes[i].history["budget_alloc"][0] == c
    state = one.state._replace(step=0)
    _, policy, m = outer_step_budget(state, pol, x, y, cfg)
    assert m["budget_alloc"] == 30.0 and int(policy.steps_seen) == 1


def test_budget_needs_the_residual_ring(budget_problem):
    """record_history below MIN_RECORD_HISTORY raises in fit and fit_batch,
    before any step runs."""
    x, y = map(torch.tensor, budget_problem)
    for h in (0, ta.MIN_RECORD_HISTORY - 1):
        cfg = OuterConfig(solver=SolverConfig(**{**SOLVER, "record_history": h}),
                          backend="cuda", **COMMON)
        with pytest.raises(ValueError, match="record_history"):
            fit(x, y, cfg, budget_policy=ta.make_budget_policy())
        with pytest.raises(ValueError, match="record_history"):
            fit_batch(x, y, cfg, [0, 1], budget_policy=ta.make_budget_policy())
