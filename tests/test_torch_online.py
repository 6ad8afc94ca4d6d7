"""The port's online BO (``repro_torch.online``) against the JAX package's
``repro.online``: UCB / expected-improvement scores and the argmax on the
same posterior numbers, the Gaussian-bumps objective with the reference's
centres and amplitudes handed over, ``run_bo`` for 10 rounds with the
reference's fitted state, candidates and reserve base noise handed over
(the same chosen point, refresh mode, flags and epochs every round, the same
best-y), and ``examples/torch_online_bo.py`` at its own small size against
the reference example's loop. Tolerances: chosen points and flags equal;
scores rtol 1e-5 (acquisition alone) or 1e-2 (through a posterior solved
to tolerance 0.01); objective values rtol 1e-6; epochs rtol 1e-3 (sums of
equal iteration counts over the capacity)."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import OuterConfig as JOuterConfig  # noqa: E402
from repro.core import fit as j_fit  # noqa: E402
from repro.core import grow_capacity  # noqa: E402
from repro.core import init_outer_state as j_init  # noqa: E402
from repro.gp.hyperparams import HyperParams as JHyperParams  # noqa: E402
from repro.online import BOConfig as JBOConfig  # noqa: E402
from repro.online import acquisition as ja  # noqa: E402
from repro.online import make_gaussian_bumps as j_bumps  # noqa: E402
from repro.online import run_bo as j_run_bo  # noqa: E402
from repro.solvers import SolverConfig as JSolverConfig  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.driver import fit  # noqa: E402
from repro_torch.core.outer import OuterConfig  # noqa: E402
from repro_torch.online import (  # noqa: E402
    ACQUISITIONS,
    BOConfig,
    acquisition_argmax,
    expected_improvement,
    make_gaussian_bumps,
    run_bo,
    ucb,
)
from repro_torch.solvers import SolverConfig  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensor ops: one intra-op thread beside the other workers of a
    parallel run (restored after)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _posterior(seed=0, m=257):
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=m).astype(np.float32)
    var = np.abs(rng.normal(size=m)).astype(np.float32) * 0.3
    var[:3] = [0.0, -1e-9, 1e-14]  # clamped below MIN_VARIANCE
    return mean, var


@pytest.mark.parametrize("params", [
    {"beta": 2.0}, {"beta": 0.0}, {"beta": 5.5}])
def test_ucb_matches_reference(params):
    mean, var = _posterior()
    got = ucb(torch.tensor(mean), torch.tensor(var), **params).numpy()
    want = np.asarray(ja.ucb(jnp.asarray(mean), jnp.asarray(var), **params))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("params", [
    {"best": 0.0, "xi": 0.01}, {"best": 1.2, "xi": 0.0},
    {"best": -0.5, "xi": 0.3}])
def test_expected_improvement_matches_reference(params):
    mean, var = _posterior(1)
    got = expected_improvement(torch.tensor(mean), torch.tensor(var),
                               **params).numpy()
    want = np.asarray(ja.expected_improvement(jnp.asarray(mean),
                                              jnp.asarray(var), **params))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["ucb", "ei"])
def test_acquisition_argmax_matches_reference(name):
    mean, var = _posterior(2)
    idx, score = acquisition_argmax(torch.tensor(mean), torch.tensor(var),
                                    name=name, best=0.4, beta=1.5, xi=0.02)
    jidx, jscore = ja.acquisition_argmax(jnp.asarray(mean), jnp.asarray(var),
                                         name=name, best=0.4, beta=1.5,
                                         xi=0.02)
    assert int(idx) == int(jidx)
    np.testing.assert_allclose(float(score), float(jscore), rtol=1e-5)
    assert set(ACQUISITIONS) == set(ja.ACQUISITIONS)
    with pytest.raises(ValueError, match="unknown acquisition"):
        acquisition_argmax(torch.tensor(mean), torch.tensor(var), name="pi")
    tie = torch.tensor([1.0, 3.0, 3.0, 2.0])
    assert int(acquisition_argmax(tie, torch.zeros(4))[0]) == 1


def _ref_bumps(key, d):
    """The reference's bumps and the draws behind them."""
    objective, f_opt = j_bumps(key, d)
    ck, ak = jax.random.split(key)
    centers = jax.random.uniform(ck, (4, d), minval=-1.0, maxval=1.0,
                                 dtype=jnp.float32)
    amps = 0.5 + jax.random.uniform(ak, (4,), dtype=jnp.float32)
    return objective, f_opt, np.asarray(centers), np.asarray(amps)


def test_gaussian_bumps_match_reference():
    jobj, f_opt, centers, amps = _ref_bumps(jax.random.PRNGKey(5), 3)
    tobj, tf_opt = make_gaussian_bumps(3, centers=torch.tensor(centers),
                                       amps=torch.tensor(amps))
    assert tf_opt == pytest.approx(f_opt, rel=1e-6)
    x = np.random.default_rng(0).uniform(-1, 1, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(tobj(torch.tensor(x)).numpy(),
                               np.asarray(jobj(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-7)
    assert tobj(torch.tensor(x[0])).shape == (1,)
    gen = torch.Generator().manual_seed(0)
    obj2, opt2 = make_gaussian_bumps(3, generator=gen)
    assert np.isfinite(opt2) and obj2(torch.tensor(x)).shape == (50,)


def test_gaussian_bumps_device():
    """The bumps live on the handed-over centres' device, else the
    generator's, else the card (which raises where there is none); an input
    on another device raises instead of being moved."""
    centers = torch.zeros((4, 2))
    amps = torch.ones(4)
    obj, _ = make_gaussian_bumps(2, centers=centers, amps=amps)
    assert obj(torch.zeros((3, 2))).device.type == "cpu"
    with pytest.raises(ValueError, match="device"):
        obj(torch.zeros((3, 2), device="meta"))
    obj, _ = make_gaussian_bumps(2, generator=torch.Generator())
    assert obj(torch.zeros((3, 2))).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_gaussian_bumps(2)


CFG = dict(estimator="pathwise", warm_start=True, num_probes=8,
           num_rff_pairs=64, num_steps=3, bm=64, bn=64)
SOLVER = dict(name="cg", tolerance=1e-2, precond_rank=0)


@pytest.fixture(scope="module")
def bo_setup():
    """test_online.py's BO smoke setup: 48 points in 2-D, bumps from
    PRNGKey(5), 3 fit steps at serving tolerance; the port's fit from the
    reference's initial state."""
    d = 2
    jobj, f_opt, centers, amps = _ref_bumps(jax.random.PRNGKey(5), d)
    x0 = jax.random.uniform(jax.random.PRNGKey(0), (48, d), minval=-1.0,
                            maxval=1.0)
    y0 = jobj(x0)
    jcfg = JOuterConfig(solver=JSolverConfig(**SOLVER), **CFG)
    tcfg = OuterConfig(solver=SolverConfig(**SOLVER), backend="cuda", **CFG)
    key = jax.random.PRNGKey(1)
    jres = j_fit(x0, y0, jcfg, key=key)
    tobj, tf_opt = make_gaussian_bumps(d, centers=torch.tensor(centers),
                                       amps=torch.tensor(amps))
    tres = fit(torch.tensor(np.asarray(x0)), torch.tensor(np.asarray(y0)),
               tcfg, state=interop.outer_state_from_numpy(
                   _np_state(j_init(key, jcfg, x0))))
    np.testing.assert_array_equal(tres.history["iters"], jres.history["iters"])
    return {"jobj": jobj, "tobj": tobj, "f_opt": f_opt, "tf_opt": tf_opt,
            "x0": x0, "y0": y0, "jcfg": jcfg, "tcfg": tcfg, "jres": jres,
            "tres": tres}


def _reference_draws(key, state, n0, d, rounds, num_candidates, s):
    """The reference's per-round candidates (``uniform(fold_in(key, r))``)
    and its reserve's base noise (``extend_state``'s split of the key)."""
    def cands(r):
        return np.array(jax.random.uniform(
            jax.random.fold_in(key, r), (num_candidates, d), minval=-1.0,
            maxval=1.0, dtype=jnp.float32))

    pad = grow_capacity(n0, n0 + rounds) - n0
    _, knew = jax.random.split(state.key)
    return cands, torch.tensor(np.asarray(jax.random.normal(knew, (pad, s))))


def _same_loop(jout, tout, rounds):
    assert len(tout.history) == len(jout.history) == rounds
    for a, b in zip(jout.history, tout.history):
        assert b["y"] == pytest.approx(a["y"], rel=1e-6), (a, b)
        for f in ("mode", "escalated", "corrected", "acquisition"):
            assert b[f] == a[f], (f, a, b)
        np.testing.assert_allclose(b["epochs"], a["epochs"], rtol=1e-3)
        np.testing.assert_allclose(b["score"], a["score"], rtol=1e-2)
    assert tout.best_y == pytest.approx(jout.best_y, rel=1e-6)
    assert tout.escalations == jout.escalations
    assert tout.corrections == jout.corrections
    np.testing.assert_allclose(tout.cum_epochs, jout.cum_epochs, rtol=1e-3)


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
def test_run_bo_matches_reference(bo_setup, warm):
    """10 rounds of 64 candidates, warm (auto + damped) and cold, with the
    reference's candidates and reserve base noise handed over: the same
    point each round, the same flags and epochs, the same best-y."""
    rounds, cands_n = 10, 64
    kw = dict(rounds=rounds, num_candidates=cands_n, refresh_mode="auto",
              correction="damped", warm=warm)
    s = bo_setup
    jout = j_run_bo(s["jobj"], s["x0"], s["y0"], s["jres"].state, s["jcfg"],
                    bo=JBOConfig(**kw), bounds=(-1.0, 1.0), f_opt=s["f_opt"])
    cands, rows = _reference_draws(jax.random.PRNGKey(0), s["jres"].state,
                                   48, 2, rounds, cands_n, 8)
    tout = run_bo(s["tobj"], torch.tensor(np.asarray(s["x0"])),
                  torch.tensor(np.asarray(s["y0"])), s["tres"].state,
                  s["tcfg"], bo=BOConfig(**kw), bounds=(-1.0, 1.0),
                  f_opt=s["tf_opt"], candidates=cands, reserve_rows=rows)
    _same_loop(jout, tout, rounds)
    st = tout.refresh_stats
    assert st["appended_rows"] == rounds and st["growth_events"] == 1
    assert tout.engine_retraces is None and tout.solve_compiles is None
    assert tout.regret == pytest.approx(s["tf_opt"] - tout.best_y)
    if warm:
        assert all(e["corrected"] for e in tout.history)
    else:
        assert all(e["mode"] == "solve" for e in tout.history)


def test_run_bo_checks_its_arguments(bo_setup):
    s = bo_setup
    x0, y0 = torch.tensor(np.asarray(s["x0"])), torch.tensor(np.asarray(s["y0"]))
    with pytest.raises(ValueError, match="pathwise"):
        run_bo(s["tobj"], x0, y0, s["tres"].state,
               OuterConfig(estimator="standard"), bo=BOConfig(rounds=1))
    with pytest.raises(ValueError, match="acquisition"):
        run_bo(s["tobj"], x0, y0, s["tres"].state, s["tcfg"],
               bo=BOConfig(rounds=1, acquisition="pi"))
    with pytest.raises(ValueError, match="refresh_every"):
        run_bo(s["tobj"], x0, y0, s["tres"].state, s["tcfg"],
               bo=BOConfig(rounds=1, refresh_every=0))
    out = run_bo(s["tobj"], x0, y0, s["tres"].state, s["tcfg"],
                 bo=BOConfig(rounds=4, num_candidates=32, refresh_every=2,
                             acquisition="ei"),
                 generator=torch.Generator().manual_seed(3))
    assert [("mode" in e) for e in out.history] == [False, True, False, True]
    assert out.refresh_stats["refines"] == 2 and out.regret is None


def test_online_bo_twin_matches_reference_example():
    """``examples/torch_online_bo.py --device cpu --rounds 10`` against the
    reference example's fit and loop at the same size (its 64 points, 256
    candidates, lengthscale 0.3 start), with the reference's objective,
    initial points, initial state, candidates and reserve base noise handed
    over: the fit's iterations equal and hyperparameters rtol 1e-4 / atol
    1e-6, then the same loop. The test hands ``run`` the example's config
    with four fit steps, not five: the fifth step of this fit ends within
    one iteration of its tolerance (28 iterations in the port, 29 in the
    reference), and the loop from states one iteration apart is not the
    same loop. An epoch budget does not fix that here: of 15 budgets tried
    from 6 to 32 epochs at five steps, 13 still part, because a fit step or
    one of the loop's own escalated solves ends one iteration apart, or the
    capped fits' scores drift past rtol 1e-2."""
    spec = importlib.util.spec_from_file_location(
        "torch_online_bo", REPO / "examples" / "torch_online_bo.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    args = twin.build_parser().parse_args(
        ["--device", "cpu", "--rounds", "10"])
    key = jax.random.PRNGKey(0)
    jobj, f_opt, centers, amps = _ref_bumps(jax.random.fold_in(key, 1), 2)
    jcfg = JOuterConfig(
        estimator="pathwise", num_probes=8, num_rff_pairs=128,
        solver=JSolverConfig(name="cg", tolerance=1e-2, precond_rank=0),
        num_steps=4, bm=256, bn=256)
    x0 = jax.random.uniform(jax.random.fold_in(key, 2), (64, 2), minval=-1.0,
                            maxval=1.0)
    y0 = jobj(x0)
    init = JHyperParams.create(2, lengthscale=0.3, signal=1.0, noise=0.1)
    fkey = jax.random.fold_in(key, 3)
    jres = j_fit(x0, y0, jcfg, key=fkey, init_params=init)
    bo = JBOConfig(rounds=10, num_candidates=256, refresh_mode="auto",
                   correction="damped")
    jout = j_run_bo(jobj, x0, y0, jres.state, jcfg, bo=bo, bounds=(-1.0, 1.0),
                    f_opt=f_opt)
    cands, rows = _reference_draws(jax.random.PRNGKey(0), jres.state, 64, 2,
                                   10, 256, 8)
    tobj, tf_opt = make_gaussian_bumps(2, centers=torch.tensor(centers),
                                       amps=torch.tensor(amps))
    out = twin.run(args, cfg=dataclasses.replace(twin.config(), num_steps=4),
                   objective=tobj, f_opt=tf_opt,
                   x0=torch.tensor(np.asarray(x0)),
                   state=interop.outer_state_from_numpy(
                       _np_state(j_init(fkey, jcfg, x0, init_params=init))),
                   candidates=cands, reserve_rows=rows)
    th, jh = out["fit"].history, jres.history
    np.testing.assert_array_equal(th["iters"], jh["iters"])
    np.testing.assert_allclose(th["hypers"], jh["hypers"], rtol=1e-4,
                               atol=1e-6)
    _same_loop(jout, out["bo"], 10)
