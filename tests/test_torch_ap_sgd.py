"""The port's AP and SGD solvers against the JAX reference: the operator's
block methods, AP (fixed iterations, to tolerance, the residual ring), SGD
with the reference's batch schedule replayed (fixed iterations, the exact
final residual, divergence), the SGD learning-rate grid, three-step fit
trajectories, padded inputs, an SGD fit resumed from a checkpoint and the
train CLI. Inputs are numpy draws from fixed seeds; the port's ``cuda``
backend runs the forward kernel's plain version on these CPU tensors."""
import ast
import json
from functools import partial
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import OuterConfig as JOuterConfig  # noqa: E402
from repro.core import fit as j_fit  # noqa: E402
from repro.core import init_outer_state as j_init  # noqa: E402
from repro.core.driver import pick_sgd_learning_rate as j_pick  # noqa: E402
from repro.core.estimators import init_probes as j_init_probes  # noqa: E402
from repro.core.outer import _resample_probes as j_resample  # noqa: E402
from repro.data.synthetic import pad_to_block_multiple as j_pad  # noqa: E402
from repro.gp.hyperparams import HyperParams as JHyperParams  # noqa: E402
from repro.solvers import HOperator as JHOperator  # noqa: E402
from repro.solvers import SolverConfig as JSolverConfig  # noqa: E402
from repro.solvers import solve as j_solve  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.core.driver import fit, pick_sgd_learning_rate  # noqa: E402
from repro_torch.core.estimators import ProbeState  # noqa: E402
from repro_torch.core.outer import OuterConfig, outer_step  # noqa: E402
from repro_torch.data.synthetic import pad_to_block_multiple  # noqa: E402
from repro_torch.gp.hyperparams import HyperParams  # noqa: E402
from repro_torch.gp.rff import RFFState  # noqa: E402
from repro_torch.interop import outer_state_from_numpy  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.solvers import (  # noqa: E402
    NO_EPOCH_BUDGET,
    HOperator,
    SolverConfig,
    solve,
)
from repro_torch.solvers.base import unroll_history  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
KINDS = ("rbf", "matern12", "matern32", "matern52")
N, D, T, BLOCK = 256, 3, 7, 64


def _params(d, seed, kernel="matern32"):
    rng = np.random.default_rng(seed)
    leaves = (rng.uniform(-0.2, 0.9, size=d).astype(np.float32),
              np.float32(0.4), np.float32(-0.6))
    return (JHyperParams(*map(jnp.asarray, leaves), kernel=kernel),
            HyperParams(*map(torch.tensor, leaves), kernel=kernel))


def _data(n=N, d=D, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, size=(n, d)).astype(np.float32)
    y = (np.sin(1.5 * x[:, 0]) + 0.5 * np.cos(x[:, 1] * x[:, -1])
         + 0.1 * rng.normal(size=n)).astype(np.float32)
    return x, y


def _rhs(n=N, t=T, seed=1):
    return np.random.default_rng(seed).normal(size=(n, t)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _ops(x, jp, tp, backend="cuda"):
    return (JHOperator(jnp.asarray(x), jp, backend="streamed", bm=64, bn=64),
            HOperator(torch.tensor(x), tp, backend=backend, bm=64, bn=64))


@partial(jax.jit, static_argnums=(1, 2))
def _ref_schedule(key, num_blocks, count):
    """The reference SGD's block indices: its loop body's
    ``key, sub = split(key); randint(sub, (), 0, nb)``, ``count`` times."""
    def body(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.randint(sub, (), 0, num_blocks)

    return jax.lax.scan(body, key, None, length=count)[1]


def _schedule(key, n, batch, iters):
    return np.asarray(_ref_schedule(key, n // batch, iters)).tolist()


def _h64(x, tp, kind):
    """H = s^2 kappa(r2) + sigma^2 I in float64 numpy (direct differences)."""
    ell = tp.lengthscales.double().numpy()
    u = x.astype(np.float64) / ell
    r2 = ((u[:, None, :] - u[None, :, :]) ** 2).sum(-1)
    r = np.sqrt(r2)
    kappa = {"rbf": np.exp(-0.5 * r2), "matern12": np.exp(-r),
             "matern32": (1 + np.sqrt(3) * r) * np.exp(-np.sqrt(3) * r),
             "matern52": (1 + np.sqrt(5) * r + 5 / 3 * r2)
             * np.exp(-np.sqrt(5) * r)}[kind]
    s2, n2 = float(tp.signal.double()) ** 2, float(tp.noise.double()) ** 2
    return s2 * kappa + n2 * np.eye(x.shape[0])


# -- operator block methods --------------------------------------------------


@pytest.mark.parametrize("backend", ["streamed", "cuda"])
@pytest.mark.parametrize("kind", KINDS)
def test_block_methods_match_reference(kind, backend):
    """``row_block_mvm``, ``col_block_mvm`` (an int start and a 0-d tensor
    start), ``block`` and ``all_block_cholesky`` at fp32 rtol 1e-5 of the
    largest output. Where the port takes r2 by direct differences, Matérn-1/2
    is held against float64 at 1e-4 instead (its square root turns the
    reference's expanded-form r2 of ~1e-6 on the diagonal into ~1e-3); the
    reference's deviation is printed beside it. The streamed backend's
    Matérn-1/2 slabs take the reference's expanded form and are left out,
    as in tests/test_torch_kernels.py."""
    x, _ = _data(192, seed=2)
    jp, tp = _params(D, 3, kind)
    jop, top = _ops(x, jp, tp, backend)
    v, u = _rhs(192, T, 4), _rhs(BLOCK, T, 5)
    start = 64
    got = {
        "row": top.row_block_mvm(start, BLOCK, torch.tensor(v)),
        "col": top.col_block_mvm(start, BLOCK, torch.tensor(u)),
        "block": top.block(start, BLOCK),
        "chol": top.all_block_cholesky(BLOCK)[1],
    }
    assert torch.equal(top.row_block_mvm(torch.tensor(start), BLOCK,
                                         torch.tensor(v)), got["row"])
    assert torch.equal(top.col_block_mvm(torch.tensor(start), BLOCK,
                                         torch.tensor(u)), got["col"])
    assert torch.equal(top.block(torch.tensor(start), BLOCK), got["block"])
    ref = {
        "row": jop.row_block_mvm(start, BLOCK, jnp.asarray(v)),
        "col": jop.col_block_mvm(start, BLOCK, jnp.asarray(u)),
        "block": jop.block(start, BLOCK),
        "chol": jop.all_block_cholesky(BLOCK)[1],
    }
    # Direct differences: block() under every backend, the slabs under cuda
    # (streamed slabs take the reference's expanded form).
    direct = {"block", "chol"} | ({"row", "col"} if backend == "cuda" else set())
    h = _h64(x, tp, kind)
    blk = slice(start, start + BLOCK)
    f64 = {"row": h[blk] @ v, "col": h[:, blk] @ u, "block": h[blk, blk],
           "chol": np.linalg.cholesky(h[blk, blk])}
    for k in got:
        if kind == "matern12" and k not in direct:
            # Matérn-1/2 from the expanded form is left out on purpose: two
            # fp32 evaluations of it differ by ~1e-3 (ROADMAP Queue 3).
            continue
        if kind == "matern12":
            port_err = _rel(got[k].numpy(), f64[k])
            print(f"matern12 {backend} {k} vs float64: port {port_err:.2e}, "
                  f"reference {_rel(ref[k], f64[k]):.2e}")
            assert port_err <= 1e-4, k
        else:
            assert _rel(got[k].numpy(), ref[k]) <= 1e-5, k


def test_padded_block_diagonal_is_exact_at_phantom_points():
    """On a padded input the port's ``block`` has ``s^2 + sigma^2`` exactly
    on the diagonal at every phantom point, the same diagonal its slabs
    multiply by; the reference's expanded form gives ``sigma^2`` at some
    of them (the trap its AP meets)."""
    x, y = _data(100, d=5, seed=6)
    jp, tp = _params(5, 7)
    jx, _, n_real = j_pad(jnp.asarray(x), jnp.asarray(y), BLOCK)
    tx, ty, n_port = pad_to_block_multiple(torch.tensor(x), torch.tensor(y),
                                           BLOCK)
    assert n_real == n_port == 100 and tx.shape == (128, 5)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert torch.all(ty[100:] == 0)
    top = HOperator(tx, tp, backend="cuda")
    jop = JHOperator(jx, jp)
    phantom = slice(100 - BLOCK, BLOCK)  # the phantom rows of block 1
    diag = torch.diagonal(top.block(BLOCK, BLOCK))
    exact = tp.signal**2 + tp.noise**2
    assert torch.all(diag[phantom] == exact)
    eye = torch.eye(BLOCK)
    slab = top.col_block_mvm(BLOCK, BLOCK, eye)[BLOCK:]
    assert torch.all(torch.diagonal(slab)[phantom] == exact)
    ref_diag = np.diag(np.asarray(jop.block(BLOCK, BLOCK)))[phantom]
    assert np.any(np.abs(ref_diag - float(exact)) > 0.5 * float(tp.signal**2))


# -- AP --------------------------------------------------------------------


@pytest.mark.parametrize("warm", [False, True])
def test_ap_fixed_iterations_match_reference(warm):
    """Three epochs (12 iterations of 64-row blocks), cold and warm start:
    solutions and both residuals within 1e-4 relative, iterations and
    epochs equal, and the 8-slot residual ring within 1e-4."""
    x, _ = _data()
    jp, tp = _params(D, 8)
    jop, top = _ops(x, jp, tp)
    b = _rhs()
    v0 = 0.5 * _rhs(seed=9) if warm else None
    cfg = dict(name="ap", block_size=BLOCK, tolerance=0.0, max_epochs=3,
               record_history=8)
    jres = j_solve(jop, jnp.asarray(b), None if v0 is None else jnp.asarray(v0),
                   JSolverConfig(**cfg))
    tres = solve(top, torch.tensor(b), None if v0 is None else torch.tensor(v0),
                 SolverConfig(**cfg))
    assert tres.iters == int(jres.iters) == 12
    assert tres.epochs == pytest.approx(float(jres.epochs), rel=1e-6)
    assert tres.mvms == 1 and tres.host_syncs == 12
    assert _rel(tres.v.numpy(), jres.v) <= 1e-4
    for a, b_ in ((tres.res_y, jres.res_y), (tres.res_z, jres.res_z)):
        np.testing.assert_allclose(float(a), float(b_), rtol=1e-4)
    np.testing.assert_allclose(tres.res_history.numpy(),
                               np.asarray(jres.res_history), rtol=1e-4)
    np.testing.assert_allclose(unroll_history(tres.res_history, tres.iters),
                               np.asarray(jres.res_history)[[4, 5, 6, 7, 0, 1, 2, 3]],
                               rtol=1e-4)


def test_ap_to_tolerance_matches_reference():
    """To tolerance 0.01 with no epoch budget: iterations within +-2 of the
    reference's, both residuals under the tolerance."""
    x, _ = _data()
    jp, tp = _params(D, 10)
    jop, top = _ops(x, jp, tp)
    b = _rhs(seed=11)
    cfg = dict(name="ap", block_size=BLOCK, tolerance=0.01,
               max_epochs=NO_EPOCH_BUDGET)
    jres = j_solve(jop, jnp.asarray(b), None, JSolverConfig(**cfg))
    tres = solve(top, torch.tensor(b), None, SolverConfig(**cfg))
    assert abs(tres.iters - int(jres.iters)) <= 2
    assert max(float(tres.res_y), float(tres.res_z)) <= 0.01
    assert tres.host_syncs == tres.iters + 1


def test_cg_ring_matches_reference():
    """CG records the residual ring too: 10 iterations into 4 slots (the
    ring wraps) within 1e-4 of the reference's ring."""
    x, _ = _data()
    jp, tp = _params(D, 31)
    jop, top = _ops(x, jp, tp)
    b = _rhs(seed=32)
    cfg = dict(name="cg", tolerance=0.0, max_epochs=10, precond_rank=0,
               record_history=4)
    jres = j_solve(jop, jnp.asarray(b), None, JSolverConfig(**cfg))
    tres = solve(top, torch.tensor(b), None, SolverConfig(**cfg))
    assert tres.iters == int(jres.iters) == 10
    np.testing.assert_allclose(tres.res_history.numpy(),
                               np.asarray(jres.res_history), rtol=1e-4)


# -- SGD -------------------------------------------------------------------


SGD_CFG = dict(name="sgd", batch_size=32, learning_rate=8.0, tolerance=0.0,
               max_epochs=2)


@pytest.mark.parametrize("case", ["cold", "warm", "exact_final_residual"])
def test_sgd_with_reference_schedule_matches_reference(case):
    """Two epochs (16 iterations of 32-row batches) with the reference's
    ``split``/``randint`` schedule handed over: solutions, both residuals,
    iterations and epochs within 1e-4 (epochs +1 and one full MVM with
    ``exact_final_residual``)."""
    x, _ = _data()
    jp, tp = _params(D, 12)
    jop, top = _ops(x, jp, tp)
    b = _rhs(seed=13)
    v0 = 0.3 * _rhs(seed=14) if case == "warm" else None
    cfg = dict(SGD_CFG, exact_final_residual=case == "exact_final_residual")
    key = jax.random.PRNGKey(15)
    jres = j_solve(jop, jnp.asarray(b), None if v0 is None else jnp.asarray(v0),
                   JSolverConfig(**cfg), key=key)
    tres = solve(top, torch.tensor(b), None if v0 is None else torch.tensor(v0),
                 SolverConfig(**cfg), batch_idx=_schedule(key, N, 32, 16))
    assert tres.iters == int(jres.iters) == 16
    assert tres.epochs == pytest.approx(float(jres.epochs), rel=1e-6)
    assert tres.mvms == (1 if case == "exact_final_residual" else 0)
    assert _rel(tres.v.numpy(), jres.v) <= 1e-4
    for a, b_ in ((tres.res_y, jres.res_y), (tres.res_z, jres.res_z)):
        np.testing.assert_allclose(float(a), float(b_), rtol=1e-4)


def test_sgd_divergence_stops_where_the_reference_stops():
    """The reference's residual-ring toy (96 rows, the default lr 30,
    8 epochs of 32-row batches): SGD diverges, the residual reaches inf
    at iteration 21 and the solve stops there in both, with inf in the
    same ring slot and the ring within 1e-4 elsewhere."""
    key = jax.random.PRNGKey(0)
    x = np.asarray(jax.random.normal(key, (96, 2)))
    b = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (96, 3)))
    jp = JHyperParams.create(2, lengthscale=1.2, signal=1.0, noise=0.3)
    tp = HyperParams(*(torch.tensor(np.asarray(a)) for a in
                       (jp.raw_lengthscales, jp.raw_signal, jp.raw_noise)))
    jop, top = _ops(x, jp, tp)
    cfg = dict(name="sgd", max_epochs=8, precond_rank=0, block_size=32,
               batch_size=32, tolerance=1e-8, record_history=16)
    skey = jax.random.PRNGKey(2)
    jres = j_solve(jop, jnp.asarray(b), None, JSolverConfig(**cfg), key=skey)
    tres = solve(top, torch.tensor(b), None, SolverConfig(**cfg),
                 batch_idx=_schedule(skey, 96, 32, 24))
    assert tres.iters == int(jres.iters) == 21
    ring, jring = tres.res_history.numpy(), np.asarray(jres.res_history)
    last = (21 - 1) % 16
    assert np.isinf(ring[last]).any() and np.isinf(jring[last]).any()
    np.testing.assert_array_equal(np.isfinite(ring), np.isfinite(jring))
    np.testing.assert_allclose(ring, jring, rtol=1e-4)
    assert not np.isfinite(float(tres.res_y) + float(tres.res_z))


def test_sgd_finite_divergence_threshold_matches_reference():
    """A finite ``divergence_threshold`` (3.0) at lr 30: both stop at the
    first iteration whose summed residual passes it, with the same
    iterate."""
    x, _ = _data()
    jp, tp = _params(D, 16)
    jop, top = _ops(x, jp, tp)
    b = _rhs(seed=17)
    cfg = dict(SGD_CFG, learning_rate=30.0, max_epochs=4,
               divergence_threshold=3.0)
    key = jax.random.PRNGKey(18)
    jres = j_solve(jop, jnp.asarray(b), None, JSolverConfig(**cfg), key=key)
    tres = solve(top, torch.tensor(b), None, SolverConfig(**cfg),
                 batch_idx=_schedule(key, N, 32, 32))
    assert tres.iters == int(jres.iters) < 32
    assert float(tres.res_y) + float(tres.res_z) > 3.0
    assert _rel(tres.v.numpy(), jres.v) <= 1e-4


def test_sgd_generator_schedule_and_bad_inputs():
    """From a generator the schedule is drawn in chunks and is
    reproducible; a short ``batch_idx``, a batch that does not divide n and
    an unknown solver name raise."""
    x, _ = _data()
    _, tp = _params(D, 19)
    op = HOperator(torch.tensor(x), tp, backend="cuda")
    b = torch.tensor(_rhs(seed=20))
    cfg = SolverConfig(**SGD_CFG)
    a = solve(op, b, None, cfg, generator=torch.Generator().manual_seed(3))
    c = solve(op, b, None, cfg, generator=torch.Generator().manual_seed(3))
    assert a.iters == c.iters == 16 and torch.equal(a.v, c.v)
    with pytest.raises(ValueError, match="shorter"):
        solve(op, b, None, cfg, batch_idx=[0] * 5)
    with pytest.raises(ValueError, match="multiple of batch_size"):
        solve(HOperator(torch.tensor(x[:250]), tp), b[:250], None, cfg)
    with pytest.raises(ValueError, match="multiple of block_size"):
        solve(op, b, None, SolverConfig(name="ap", block_size=100))


@pytest.mark.parametrize("halve", [False, True])
def test_pick_sgd_learning_rate_matches_reference(halve):
    """The paper's grid (largest lr whose 3-epoch cold solve ends finite
    with res_y + res_z < 4), with the reference's probes and schedule
    handed over: the same lr, halved or not."""
    x, y = _data(128)
    jp, tp = _params(D, 21)
    common = dict(estimator="pathwise", num_probes=4, num_rff_pairs=32,
                  bm=64, bn=64)
    solver = dict(name="sgd", batch_size=32)
    jcfg = JOuterConfig(solver=JSolverConfig(**solver), backend="streamed",
                        **common)
    tcfg = OuterConfig(solver=SolverConfig(**solver), backend="cuda", **common)
    key = jax.random.PRNGKey(22)
    jlr = j_pick(jnp.asarray(x), jnp.asarray(y), jp, jcfg, key, halve=halve)
    probes = _port_probes(j_init_probes(key, "pathwise", 128, D, 4, 32,
                                        kind="matern32"))
    trials = []
    tlr = pick_sgd_learning_rate(
        torch.tensor(x), torch.tensor(y), tp, tcfg, probes=probes,
        batch_idx=_schedule(key, 128, 32, 12), halve=halve, trials=trials)
    assert tlr == jlr
    assert 2 <= len(trials) and [lr for lr, _ in trials][-1] > tlr


# -- fit trajectories --------------------------------------------------------


def _port_probes(jp):
    """The reference's ProbeState as the port's (same draws)."""
    def t(a):
        return None if a is None else torch.tensor(np.asarray(a))

    rff = None if jp.rff is None else RFFState(t(jp.rff.z), t(jp.rff.u),
                                               t(jp.rff.w), kind=jp.rff.kind)
    return ProbeState(jp.estimator, t(jp.z), rff, t(jp.w_eps))


def _np_params(p):
    return {"raw_lengthscales": np.asarray(p.raw_lengthscales),
            "raw_signal": np.asarray(p.raw_signal),
            "raw_noise": np.asarray(p.raw_noise), "kernel": p.kernel}


def _np_state(st):
    pr = st.probes
    rff = None if pr.rff is None else {
        "z": np.asarray(pr.rff.z), "u": np.asarray(pr.rff.u),
        "w": np.asarray(pr.rff.w), "kind": pr.rff.kind}
    return {"params": _np_params(st.params),
            "adam": {"step": np.asarray(st.adam.step),
                     "mu": _np_params(st.adam.mu),
                     "nu": _np_params(st.adam.nu)},
            "probes": {"estimator": pr.estimator,
                       "z": None if pr.z is None else np.asarray(pr.z),
                       "rff": rff,
                       "w_eps": None if pr.w_eps is None else np.asarray(pr.w_eps)},
            "carry_v": np.asarray(st.carry_v), "step": np.asarray(st.step)}


FIT_N, FIT_BLOCK, FIT_ITERS = 128, 32, 8  # 2 epochs of 4 blocks


def _fit_configs(solver, estimator, warm_start, num_steps=3):
    scfg = dict(name=solver, tolerance=0.0, max_epochs=2, block_size=FIT_BLOCK,
                batch_size=FIT_BLOCK, learning_rate=5.0)
    common = dict(estimator=estimator, warm_start=warm_start, num_probes=4,
                  num_rff_pairs=32, num_steps=num_steps, bm=64, bn=64)
    return (JOuterConfig(solver=JSolverConfig(**scfg), backend="streamed",
                         **common),
            OuterConfig(solver=SolverConfig(**scfg), backend="cuda", **common))


@pytest.mark.parametrize("solver", ["ap", "sgd"])
@pytest.mark.parametrize("estimator,warm", [("pathwise", True),
                                            ("standard", False)])
def test_fit_trajectory_matches_reference(solver, estimator, warm):
    """Three outer steps from the reference's initial state, with its
    per-step ``ksolve`` schedule (SGD) and ``kprobe`` probes (cold start)
    handed over: constrained hyperparameters per step within 1e-4
    relative, 8 solver iterations each."""
    x, y = _data(FIT_N, seed=23)
    jcfg, tcfg = _fit_configs(solver, estimator, warm)
    key = jax.random.PRNGKey(24)
    jst = j_init(key, jcfg, jnp.asarray(x))
    jres = j_fit(jnp.asarray(x), jnp.asarray(y), jcfg, key=key)
    state = outer_state_from_numpy(_np_state(jst))
    jkey, hypers = jst.key, []
    for _ in range(3):
        jkey, ksolve, kprobe = jax.random.split(jkey, 3)
        probes = None if warm else _port_probes(
            j_resample(kprobe, jst.probes, jnp.asarray(x)))
        sched = _schedule(ksolve, FIT_N, FIT_BLOCK, FIT_ITERS)
        state, metrics = outer_step(state, torch.tensor(x), torch.tensor(y),
                                    tcfg, probes=probes, batch_idx=sched)
        assert metrics["iters"] == FIT_ITERS
        hypers.append(metrics["hypers"])
    assert list(jres.history["iters"]) == [FIT_ITERS] * 3
    for step in range(3):
        assert _rel(hypers[step], jres.history["hypers"][step]) <= 1e-4, step


# -- padded inputs -----------------------------------------------------------


@pytest.mark.parametrize("solver", ["ap", "sgd"])
def test_padded_solve_matches_reference_on_real_rows(solver):
    """100 real rows padded to 128 (block 64), the same right-hand sides on
    every row for both, cold start: the real rows' solutions within 1e-4
    and equal iteration counts. Real and phantom rows do not interact, so
    the real rows see the same arithmetic; the phantom rows' diagonal
    differs (the reference's expanded form), so their residuals are not
    compared. AP to tolerance 0.01 still takes the same block sequence:
    from a cold start both start from the same residual, and the
    reference's slabs carry the same diagonal as its blocks, so each
    projection of the mixed block zeroes its phantom residual in both.
    SGD runs 2 epochs on the reference's schedule."""
    x, y = _data(100, d=5, seed=25)
    jp, tp = _params(5, 26)
    jx, _, _ = j_pad(jnp.asarray(x), jnp.asarray(y), BLOCK)
    tx, _, _ = pad_to_block_multiple(torch.tensor(x), torch.tensor(y), BLOCK)
    jop = JHOperator(jx, jp, bm=64, bn=64)
    top = HOperator(tx, tp, backend="cuda")
    b = _rhs(128, T, 27)
    key = jax.random.PRNGKey(28)
    if solver == "ap":
        cfg = dict(name="ap", block_size=BLOCK, tolerance=0.01)
        sched = None
    else:
        cfg = dict(SGD_CFG, batch_size=BLOCK)
        sched = _schedule(key, 128, BLOCK, 4)
    jres = j_solve(jop, jnp.asarray(b), None, JSolverConfig(**cfg), key=key)
    tres = solve(top, torch.tensor(b), None, SolverConfig(**cfg),
                 batch_idx=sched)
    assert tres.iters == int(jres.iters) > 1
    assert _rel(tres.v.numpy()[:100], np.asarray(jres.v)[:100]) <= 1e-4


# -- port-only properties ----------------------------------------------------


def test_sgd_fit_resumed_from_checkpoint_equals_uninterrupted(tmp_path):
    """SGD, standard estimator, cold start, eval every 2 steps (its SGD eval
    solves draw from the generator too): a fit stopped after step 2 and
    resumed from its checkpoint ends bit-identical to an uninterrupted
    4-step fit, history included."""
    x, y = _data(FIT_N, seed=29)
    xt, yt = _data(30, seed=30)
    cfg4 = _fit_configs("sgd", "standard", False, num_steps=4)[1]
    cfg2 = _fit_configs("sgd", "standard", False, num_steps=2)[1]
    kw = dict(x_test=torch.tensor(xt), y_test=torch.tensor(yt), eval_every=2)
    args = (torch.tensor(x), torch.tensor(y))
    full = fit(*args, cfg4, generator=torch.Generator().manual_seed(7), **kw)
    fit(*args, cfg2, generator=torch.Generator().manual_seed(7),
        ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    resumed = fit(*args, cfg4, generator=torch.Generator().manual_seed(7),
                  ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    assert resumed.state.step == full.state.step == 4
    for a, b in zip(tckpt.state_leaves(resumed.state),
                    tckpt.state_leaves(full.state)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    np.testing.assert_array_equal(resumed.history["hypers"],
                                  full.history["hypers"][2:])
    assert resumed.history["eval_rmse"][-1] == full.history["eval_rmse"][-1]


def _reference_summary_keys():
    tree = ast.parse((REPO / "src/repro/launch/train.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "run_gp")
    out = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "out")
    return [k.value for k in out.value.keys]


@pytest.mark.parametrize("solver", ["ap", "sgd"])
def test_train_cli_ap_sgd_on_cpu(solver, capsys):
    """``--solver ap|sgd --max-n 400`` on the CPU (pathwise, warm start,
    budget 2): the rows are padded to the block (360 -> 400), the
    reference's JSON keys are printed, and ``--sgd-lr 0`` runs the grid
    and prints its line."""
    block = ["--block-size", "100"] if solver == "ap" else ["--batch-size", "50"]
    ttrain.main(["--device", "cpu", "--solver", solver, "--max-n", "400",
                 "--steps", "2", "--probes", "4", "--eval-every", "2",
                 "--pathwise", "--warm-start", "--budget", "2", *block])
    text = capsys.readouterr().out
    out = json.loads(text[text.index("{\n"):])
    assert list(out) == _reference_summary_keys()
    assert out["solver"] == solver and 0 < out["total_epochs"] <= 4.0
    assert np.isfinite(out["eval_rmse"]).all()
    assert ("[train] sgd lr grid -> " in text) == (solver == "sgd")
