"""Parity of the port's GP pieces and solver with the JAX reference:
softplus, RFF prior samples and system targets from injected draws, Adam,
the H operator's backends, CG (fixed iteration count and to tolerance) and
the marginal-likelihood gradient. Inputs are numpy draws from fixed seeds."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.estimators import ProbeState as JProbeState  # noqa: E402
from repro.core.estimators import build_system_targets as j_targets  # noqa: E402
from repro.core.gradients import mll_grad_estimate as j_grad  # noqa: E402
from repro.gp import hyperparams as jhp  # noqa: E402
from repro.gp.rff import RFFState as JRFFState  # noqa: E402
from repro.gp.rff import prior_sample_at as j_prior  # noqa: E402
from repro.solvers import HOperator as JHOperator  # noqa: E402
from repro.solvers import SolverConfig as JSolverConfig  # noqa: E402
from repro.solvers.cg import solve_cg as j_cg  # noqa: E402
from repro.train import adam as jadam  # noqa: E402
from repro_torch.core.estimators import ProbeState, build_system_targets  # noqa: E402
from repro_torch.core.gradients import mll_grad_estimate  # noqa: E402
from repro_torch.gp import hyperparams as thp  # noqa: E402
from repro_torch.gp.rff import RFFState, prior_sample_at  # noqa: E402
from repro_torch.solvers import HOperator, SolverConfig, solve  # noqa: E402
from repro_torch.solvers.cg import solve_cg  # noqa: E402
from repro_torch.train import adam as tadam  # noqa: E402


def _params(d, seed=0, kernel="matern32"):
    rng = np.random.default_rng(seed)
    leaves = (rng.uniform(-0.2, 0.9, size=d).astype(np.float32),
              np.float32(0.4), np.float32(-0.6))
    return (jhp.HyperParams(*map(jnp.asarray, leaves), kernel=kernel),
            thp.HyperParams(*map(torch.tensor, leaves), kernel=kernel))


def _problem(n=80, d=3, t=5, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    b = rng.normal(size=(n, t)).astype(np.float32)
    v0 = (0.1 * rng.normal(size=(n, t))).astype(np.float32)
    return x, b, v0


def test_softplus_roundtrip_and_reference():
    """softplus / softplus_inverse vs the reference on both branches of the
    inverse (theta < 20 and >= 20); round trip at fp32 rtol 1e-5."""
    theta = np.array([1e-3, 0.1, 1.0, 5.0, 19.5, 20.0, 35.0], np.float32)
    nu = thp.softplus_inverse(torch.tensor(theta))
    np.testing.assert_allclose(
        nu.numpy(), np.asarray(jhp.softplus_inverse(jnp.asarray(theta))),
        rtol=1e-6)
    np.testing.assert_allclose(thp.softplus(nu).numpy(), theta, rtol=1e-5)
    raw = np.array([-30.0, -1.0, 0.0, 2.0, 40.0], np.float32)
    np.testing.assert_allclose(thp.softplus(torch.tensor(raw)).numpy(),
                               np.asarray(jhp.softplus(jnp.asarray(raw))),
                               rtol=1e-6)


@pytest.mark.parametrize("kind", ["rbf", "matern32"])
def test_prior_samples_and_targets_from_injected_draws(kind):
    """RFF prior samples and [y | f(x) + sigma w_eps] vs the reference from
    the same (z, u, w, w_eps) draws. rtol 1e-5 * max: fp32 cos/sin of the
    projections and a 2m-term contraction."""
    rng = np.random.default_rng(3)
    n, d, m, s = 60, 3, 48, 6
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(n,)).astype(np.float32)
    z = rng.normal(size=(m, d)).astype(np.float32)
    u = rng.chisquare(3.0, size=m).astype(np.float32)
    w = rng.normal(size=(2 * m, s)).astype(np.float32)
    w_eps = rng.normal(size=(n, s)).astype(np.float32)
    jp, tp = _params(d, kernel=kind)
    jrff = JRFFState(jnp.asarray(z), jnp.asarray(u), jnp.asarray(w), kind=kind)
    trff = RFFState(torch.tensor(z), torch.tensor(u), torch.tensor(w), kind=kind)
    ref = np.asarray(j_prior(jnp.asarray(x), jrff, jp))
    got = prior_sample_at(torch.tensor(x), trff, tp).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    jt = j_targets(JProbeState("pathwise", None, jrff, jnp.asarray(w_eps)),
                   jnp.asarray(x), jnp.asarray(y), jp)
    tt = build_system_targets(ProbeState("pathwise", None, trff,
                                         torch.tensor(w_eps)),
                              torch.tensor(x), torch.tensor(y), tp)
    jt = np.asarray(jt)
    assert tt.shape == (n, 1 + s)
    assert np.abs(tt.numpy() - jt).max() <= 1e-5 * np.abs(jt).max()


def test_adam_update_matches_reference():
    """Four Adam ascent steps from the same gradients; fp32, rtol 1e-6."""
    jp, tp = _params(4, seed=5)
    rng = np.random.default_rng(6)
    cfg_j = jadam.AdamConfig(learning_rate=0.1)
    cfg_t = tadam.AdamConfig(learning_rate=0.1)
    js, ts = jadam.adam_init(jp), tadam.adam_init(tp)
    for _ in range(4):
        g = (rng.normal(size=4).astype(np.float32), np.float32(rng.normal()),
             np.float32(rng.normal()))
        jg = jhp.HyperParams(*map(jnp.asarray, g), kernel=jp.kernel)
        tg = thp.HyperParams(*map(torch.tensor, g), kernel=tp.kernel)
        jp, js = jadam.adam_update(jg, js, jp, cfg_j, maximize=True)
        tp, ts = tadam.adam_update(tg, ts, tp, cfg_t, maximize=True)
    for a, b in zip((jp.raw_lengthscales, jp.raw_signal, jp.raw_noise),
                    tp.leaves):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    assert ts.step == int(js.step) == 4


@pytest.mark.parametrize("backend,ref_backend",
                         [("dense", "dense"), ("streamed", "streamed"),
                          ("cuda", "pallas")])
def test_hoperator_backends_match_reference(backend, ref_backend):
    """H @ V per backend vs the reference's (``cuda`` runs the kernel's plain
    version on CPU; the reference's ``pallas`` runs in interpret mode).
    Tolerance 1e-5 * max|out| (fp32 summation order / distance form)."""
    x, b, _ = _problem()
    jp, tp = _params(3)
    ref = np.asarray(JHOperator(jnp.asarray(x), jp, backend=ref_backend,
                                bm=32, bn=32).mvm(jnp.asarray(b)))
    got = HOperator(torch.tensor(x), tp, backend=backend, bm=32,
                    bn=32).mvm(torch.tensor(b)).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_cg_fixed_iterations_matches_reference():
    """tolerance=0 and max_epochs=k: both run exactly k iterations from the
    same warm start; v, res_y, res_z agree to 1e-4 relative (fp32 CG
    recurrences drift by a few ulps per iteration)."""
    x, b, v0 = _problem()
    jp, tp = _params(3)
    k = 7
    jres = j_cg(JHOperator(jnp.asarray(x), jp, backend="streamed", bm=32, bn=32),
                jnp.asarray(b), jnp.asarray(v0),
                JSolverConfig(tolerance=0.0, max_epochs=k, precond_rank=0))
    tres = solve_cg(HOperator(torch.tensor(x), tp, backend="streamed", bm=32,
                              bn=32),
                    torch.tensor(b), torch.tensor(v0),
                    SolverConfig(tolerance=0.0, max_epochs=k, precond_rank=0))
    assert tres.iters == int(jres.iters) == k
    assert tres.mvms == k + 1 and tres.host_syncs == k
    jv = np.asarray(jres.v)
    assert np.abs(tres.v.numpy() - jv).max() <= 1e-4 * np.abs(jv).max()
    np.testing.assert_allclose(float(tres.res_y), float(jres.res_y), rtol=1e-4)
    np.testing.assert_allclose(float(tres.res_z), float(jres.res_z), rtol=1e-4)


def test_cg_to_tolerance_matches_reference():
    """To tolerance 0.01 from a cold start: iteration counts within +-1 and
    solutions within 1e-3 relative (a one-iteration difference moves the
    iterate by at most ~the tolerance)."""
    x, b, _ = _problem(n=120, seed=4)
    jp, tp = _params(3, seed=2)
    jres = j_cg(JHOperator(jnp.asarray(x), jp, backend="streamed", bm=64, bn=64),
                jnp.asarray(b), None,
                JSolverConfig(tolerance=0.01, max_epochs=500, precond_rank=0))
    tres = solve(HOperator(torch.tensor(x), tp, backend="cuda"),
                 torch.tensor(b), None,
                 SolverConfig(tolerance=0.01, max_epochs=500, precond_rank=0))
    assert abs(tres.iters - int(jres.iters)) <= 1
    assert max(float(tres.res_y), float(tres.res_z)) <= 0.01
    jv = np.asarray(jres.v)
    assert np.abs(tres.v.numpy() - jv).max() <= 1e-2 * np.abs(jv).max()


def test_unported_solver_paths_raise():
    """The solver dispatch runs every ported solver (CG, AP, SGD; AP and
    SGD are held to the reference in tests/test_torch_ap_sgd.py) and
    raises ``ValueError`` for a solver it does not know."""
    x, b, _ = _problem(n=16)
    _, tp = _params(3)
    op = HOperator(torch.tensor(x), tp)
    for name in ("cg", "ap", "sgd"):
        cfg = SolverConfig(name=name, max_epochs=2, block_size=8,
                           batch_size=8, learning_rate=1.0, precond_rank=0)
        res = solve(op, torch.tensor(b), None, cfg,
                    generator=torch.Generator().manual_seed(0))
        assert res.iters > 0 and torch.isfinite(res.v).all(), name
    with pytest.raises(ValueError, match="unknown solver"):
        solve(op, torch.tensor(b), None, SolverConfig(name="lbfgs"))


@pytest.mark.parametrize("estimator", ["pathwise", "standard"])
def test_mll_grad_matches_reference(estimator):
    """Per-hyperparameter gradient vs ``jax.value_and_grad`` through the
    reference's tiled MVM. Each leaf within 1e-4 of the largest gradient
    entry (fp32 sums of n^2 * s products with cancellation)."""
    rng = np.random.default_rng(9)
    x, _, _ = _problem(n=90, seed=8)
    y = rng.normal(size=(90,)).astype(np.float32)
    v = rng.normal(size=(90, 5)).astype(np.float32)
    tg = rng.normal(size=(90, 5)).astype(np.float32)
    jp, tp = _params(3, seed=3)
    jgrads, jaux = j_grad(jnp.asarray(x), jnp.asarray(y), jp, jnp.asarray(v),
                          jnp.asarray(tg), estimator, bm=32, bn=32)
    tgrads, taux = mll_grad_estimate(torch.tensor(x), torch.tensor(y), tp,
                                     torch.tensor(v), torch.tensor(tg),
                                     estimator, bm=32, bn=32)
    ref = [np.asarray(a) for a in (jgrads.raw_lengthscales, jgrads.raw_signal,
                                   jgrads.raw_noise)]
    scale = max(np.abs(r).max() for r in ref)
    for r, g in zip(ref, tgrads.leaves):
        assert np.abs(g.numpy() - r).max() <= 1e-4 * scale
    np.testing.assert_allclose(float(taux.data_fit), float(jaux.data_fit),
                               rtol=1e-5)
    np.testing.assert_allclose(float(taux.quad_value), float(jaux.quad_value),
                               rtol=1e-4)
