"""The port's in-process serving half against the JAX package: the online
refresh (``OnlineGP`` in modes solve / block / auto / step, the damped
correction, escalation budgets, the merge with appends that raced a refine,
background ``refresh_into``, geometric growth), ``MultiModelServer``, the
engine's queue worker, artifact save/load across the two packages, and the
serve CLI's ``--compat`` / ``--refresh-every``.

Inputs are the reference tests' own fixtures (``tests/test_serve.py``,
``tests/test_online.py``: 128 fitted rows in 2-D, 8 probes, 64 RFF pairs,
``bm = bn = 64``); each fitted state is the reference's, carried across by
``repro_torch.interop``, and every appended row's base noise is the row the
reference drew, read out of its state after its append (or growth) and
handed over. The port runs its ``cuda`` backend, i.e. the forward kernel's
plain version on these CPU tensors (``r2`` by direct differences); the
reference runs ``streamed``. Tolerances (as ``test_torch_serve_path.py``):
iterations, modes and flags equal; carries within 1e-4 of their largest
entry; residuals and epochs rtol 1e-3; predictions rtol 1e-4 / atol 1e-6.
Full solves that would end within one iteration of their tolerance run
under an epoch budget, so the count is fixed (the packages' fp32 sums run
in different orders); residuals of a 1e-5 solve, at its fp32 noise floor,
agree within a fifth of that tolerance. Geometric growth is held on the
real rows (see its test).
"""
import re
import threading
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import OuterConfig as JOuterConfig  # noqa: E402
from repro.core import init_outer_state as j_init  # noqa: E402
from repro.core import outer_step as j_step  # noqa: E402
from repro.data.synthetic import make_gp_regression  # noqa: E402
from repro.serve import MultiModelServer as JServer  # noqa: E402
from repro.serve import OnlineGP as JOnline  # noqa: E402
from repro.serve import export_servable as j_export  # noqa: E402
from repro.serve import load_servable as j_load  # noqa: E402
from repro.serve import merge_refined_state as j_merge  # noqa: E402
from repro.serve import save_servable as j_save  # noqa: E402
from repro.serve import servable_predict as j_predict  # noqa: E402
from repro.obs import trace as jt  # noqa: E402
from repro.solvers import SolverConfig as JSolverConfig  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.outer import OuterConfig, extend_state  # noqa: E402
from repro_torch.core.predict import Predictions  # noqa: E402
from repro_torch.gp.kernels_math import profile_from_r2  # noqa: E402
from repro_torch.kernels.tiled import kernel_mvm_plain  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.obs import metrics as tm  # noqa: E402
from repro_torch.obs import trace as tt  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AUTO_COUPLING_FACTOR,
    GROWTH_GEOMETRIC,
    BucketedEngine,
    MultiModelServer,
    OnlineGP,
    export_servable,
    load_servable,
    merge_refined_state,
    save_servable,
    servable_predict,
)
from repro_torch.solvers import SolverConfig  # noqa: E402

KINDS = ("rbf", "matern12", "matern32", "matern52")
CARRY_REL, RES_RTOL = 1e-4, 1e-3
PRED_RTOL, PRED_ATOL = 1e-4, 1e-6


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


def _np_servable(m):
    return {"x": np.asarray(m.x), "correction": np.asarray(m.correction),
            "rff": {"z": np.asarray(m.rff.z), "u": np.asarray(m.rff.u),
                    "w": np.asarray(m.rff.w), "kind": m.rff.kind},
            "params": _np_params(m.params), "kind": m.kind}


def _t(a):
    return torch.tensor(np.asarray(a))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _fixture(n_all, tolerance, max_epochs, sync, **extra):
    """A reference fit (3 outer steps) on ``make_gp_regression(PRNGKey(0))``
    and the port's config; ``sync`` re-solves the carry at the final
    hyperparameters, as the reference's block fixtures do."""
    xall, yall = make_gp_regression(jax.random.PRNGKey(0), n_all, 2, noise=0.2)
    x, y = xall[:128], yall[:128]
    solver = dict(name="cg", max_epochs=max_epochs, precond_rank=0,
                  tolerance=tolerance)
    common = dict(estimator="pathwise", warm_start=True, num_probes=8,
                  num_rff_pairs=64, num_steps=3, bm=64, bn=64)
    jcfg = JOuterConfig(solver=JSolverConfig(**solver), **common)
    tcfg = OuterConfig(solver=SolverConfig(**solver), backend="cuda", **common)
    state = j_init(jax.random.PRNGKey(1), jcfg, x)
    for _ in range(jcfg.num_steps):
        state, _ = j_step(state, x, y, jcfg)
    if sync:
        o = JOnline(x, y, state, jcfg)
        o.refine(mode="solve")
        state = o.state
    return {"x": x, "y": y, "xall": xall, "yall": yall, "jcfg": jcfg,
            "tcfg": tcfg, "state": state,
            "tstate": interop.outer_state_from_numpy(_np_state(state)),
            **extra}


@pytest.fixture(scope="module")
def fitted():
    """test_serve.py's ``fitted``: converged CG at tolerance 0.01."""
    return _fixture(160, 0.01, 200, sync=False)


@pytest.fixture(scope="module")
def block_fit():
    """test_serve.py's ``block_fit``: tolerance 1e-5, carry synced."""
    return _fixture(208, 1e-5, 400, sync=True)


@pytest.fixture(scope="module")
def online_fit():
    """test_online.py's ``online_fit``: tolerance 1e-4, carry synced."""
    return _fixture(208, 1e-4, 400, sync=True)


@pytest.fixture(scope="module")
def loose_fit():
    """test_online.py's ``loose_fit``: tolerance 1e-2, carry synced."""
    return _fixture(208, 1e-2, 400, sync=True)


def _pair(fx, growth="exact", reserve=0):
    """The reference's and the port's OnlineGP on the same fitted state;
    the reserve's base noise handed over from the reference's growth."""
    jo = JOnline(fx["x"], fx["y"], fx["state"], fx["jcfg"], growth=growth,
                 reserve=reserve)
    rows = None
    if growth == GROWTH_GEOMETRIC and reserve:
        rows = _t(jo.state.probes.w_eps[fx["x"].shape[0]:])
    to = OnlineGP(_t(fx["x"]), _t(fx["y"]), fx["tstate"], fx["tcfg"],
                  growth=growth, reserve=reserve, reserve_rows=rows,
                  last_residuals=(float(fx["state"].last_res_y),
                                  float(fx["state"].last_res_z)))
    return jo, to


def _append(jo, to, x_new, y_new, **kw):
    """Append to both; the port gets the base-noise rows the reference drew
    for this append (exact growth) or its growth event (geometric)."""
    n0, cap0 = jo.n, jo.capacity
    jo.append(x_new, y_new, **kw)
    if jo.growth == "exact":
        rows = _t(jo.state.probes.w_eps[n0:])
    else:
        rows = _t(jo.state.probes.w_eps[cap0:]) if jo.capacity > cap0 else None
    to.append(_t(x_new), _t(y_new), rows=rows, **kw)


def _check(jr, tr, jo, to, real_rows=None, res_atol=0.0):
    """Report and carry parity (carry rows ``[:real_rows]`` when given);
    ``res_atol`` for residuals at the fp32 noise floor of a 1e-5 solve."""
    for f in ("n", "appended", "iters", "warm", "mode", "block_rows",
              "escalated", "corrected", "capacity", "trace_ids"):
        assert getattr(tr, f) == getattr(jr, f), (f, getattr(tr, f),
                                                  getattr(jr, f))
    for f in ("epochs", "block_epochs", "correction_epochs"):
        np.testing.assert_allclose(getattr(tr, f), getattr(jr, f),
                                   rtol=RES_RTOL, err_msg=f)
    np.testing.assert_allclose([tr.res_y, tr.res_z], [jr.res_y, jr.res_z],
                               rtol=RES_RTOL, atol=res_atol)
    rows = slice(None) if real_rows is None else slice(0, real_rows)
    assert _rel(to.state.carry_v.numpy()[rows],
                np.asarray(jo.state.carry_v)[rows]) <= CARRY_REL
    assert to.n == jo.n and to.capacity == jo.capacity


# -- mode="solve" ----------------------------------------------------------------
@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
def test_solve_matches_reference(fitted, warm):
    """32 appended rows, then a full re-solve, warm and cold, under a
    6-epoch budget: both solves stop at the budget, short of the tolerance
    (a solve that ends within one iteration of its tolerance can take one
    iteration more or fewer in the other package, whose fp32 sums run in
    another order; the warm-vs-cold test below runs to tolerance)."""
    x_new, y_new = make_gp_regression(jax.random.PRNGKey(11), 32, 2, noise=0.2)
    jo, to = _pair(fitted)
    _append(jo, to, x_new, y_new)
    jr = jo.refine(warm=warm, mode="solve", budget_epochs=6.0)
    tr = to.refine(warm=warm, mode="solve", budget_epochs=6.0)
    _check(jr, tr, jo, to)
    assert tr.iters == 6
    assert tr.mvms == tr.iters + 1  # CG: the initial residual + 1 per iter


def test_warm_refresh_cheaper_than_cold(fitted):
    """The reference's contract: the warm re-solve costs fewer epochs."""
    x_new, y_new = make_gp_regression(jax.random.PRNGKey(11), 32, 2, noise=0.2)
    epochs = {}
    for warm in (True, False):
        _, to = _pair(fitted)
        to.append(_t(x_new), _t(y_new))
        epochs[warm] = to.refine(warm=warm, mode="solve").epochs
    assert epochs[True] < epochs[False], epochs


# -- mode="block" / "auto" -------------------------------------------------------
def test_block_matches_reference_and_full_resolve(block_fit):
    """Weak coupling (a cluster ~10 lengthscales away): the block refine
    against the reference's, and against the port's own full re-solve
    (the reference's acceptance: predictions within 1% of the spread)."""
    k = 16
    x_new = block_fit["x"][:k] + 8.0
    y_new = jax.random.normal(jax.random.PRNGKey(3), (k,)) * 0.5
    jo, to = _pair(block_fit)
    _append(jo, to, x_new, y_new)
    jr, tr = jo.refine(mode="block"), to.refine(mode="block")
    _check(jr, tr, jo, to)
    assert tr.block_rows == k and tr.block_epochs > 0 and tr.res_y < 1e-3
    assert tr.mvms == tr.iters + 1 + 2  # the k x k solve + 2 cross-MVMs
    _, full = _pair(block_fit)
    full.append(_t(x_new), _t(y_new), rows=to.state.probes.w_eps[128:])
    rf = full.refine(mode="solve")
    assert tr.epochs < 0.1 * rf.epochs
    for xq in (block_fit["xall"][144:], x_new + 0.1):
        pb = servable_predict(to.export(), _t(xq))
        pf = servable_predict(full.export(), _t(xq))
        scale = float(torch.std(pf.mean)) + 1e-6
        assert float(torch.max(torch.abs(pb.mean - pf.mean))) / scale < 0.01
        assert float(torch.max(torch.abs(pb.var - pf.var))) < 0.01


def test_block_coupling_residual_flags_overlap(block_fit):
    """Strongly coupled appends: the block refine's reported coupling
    residual is large, as the reference's."""
    jo, to = _pair(block_fit)
    _append(jo, to, block_fit["xall"][128:144], block_fit["yall"][128:144])
    jr, tr = jo.refine(mode="block"), to.refine(mode="block")
    _check(jr, tr, jo, to)
    assert tr.res_y > 0.01


@pytest.mark.parametrize("case", ["weak", "strong", "lax_threshold"])
def test_auto_matches_reference(block_fit, case):
    """Auto stays on the block path under weak coupling, escalates to a
    warm full re-solve under strong coupling, and keeps the block path
    under a lax explicit threshold."""
    if case == "weak":
        x_new = block_fit["x"][:16] + 8.0
        y_new = jax.random.normal(jax.random.PRNGKey(3), (16,)) * 0.5
    else:
        x_new, y_new = block_fit["xall"][128:144], block_fit["yall"][128:144]
    kw = {"coupling_threshold": 10.0} if case == "lax_threshold" else {}
    jo, to = _pair(block_fit)
    _append(jo, to, x_new, y_new)
    jr, tr = jo.refine(mode="auto", **kw), to.refine(mode="auto", **kw)
    tol = block_fit["tcfg"].solver.tolerance
    # The escalated solve ends at ~half the 1e-5 tolerance, the fp32 noise
    # floor of these residuals: there they agree within a fifth of it.
    _check(jr, tr, jo, to, res_atol=0.2 * tol if case == "strong" else 0.0)
    assert tr.escalated == (case == "strong")
    if case == "strong":
        assert max(tr.res_y, tr.res_z) <= tol * 1.01
        assert tr.mvms == tr.iters + 2 + 2  # block + full solve, 2 cross
    elif case == "weak":
        assert max(tr.res_y, tr.res_z) <= AUTO_COUPLING_FACTOR * tol
        assert tr.epochs < 1.0


def test_damped_correction_matches_reference(loose_fit):
    """A 2-row strongly coupled append at serving tolerance: plain auto
    escalates; with the damped correction the polish brings the honest
    residual under the threshold at a fraction of the cost."""
    x_new, y_new = loose_fit["xall"][128:130], loose_fit["yall"][128:130]
    jo, to = _pair(loose_fit)
    _append(jo, to, x_new, y_new)
    jr = jo.refine(mode="auto", correction="damped")
    tr = to.refine(mode="auto", correction="damped")
    _check(jr, tr, jo, to)
    assert tr.corrected and not tr.escalated and tr.correction_epochs > 0
    tol = loose_fit["tcfg"].solver.tolerance
    assert max(tr.res_y, tr.res_z) <= AUTO_COUPLING_FACTOR * tol
    _, plain = _pair(loose_fit)
    plain.append(_t(x_new), _t(y_new), rows=to.state.probes.w_eps[128:])
    pr = plain.refine(mode="auto")
    assert pr.escalated and tr.epochs < 0.5 * pr.epochs
    stats = to.stats_dict()
    assert stats["corrections"] == 1 and stats["escalations"] == 0
    with pytest.raises(ValueError, match="correction"):
        to.refine(mode="auto", correction="other")


def test_escalation_budget_matches_reference(online_fit):
    """An escalation under a budget gets only the remaining epochs."""
    jo, to = _pair(online_fit)
    _append(jo, to, online_fit["xall"][128:144], online_fit["yall"][128:144])
    jr = jo.refine(mode="auto", budget_epochs=6.0)
    tr = to.refine(mode="auto", budget_epochs=6.0)
    _check(jr, tr, jo, to)
    assert tr.escalated and tr.epochs <= 6.0 + 1.0


def test_block_requires_warm_and_noop_without_appends(block_fit):
    jo, to = _pair(block_fit)
    with pytest.raises(ValueError, match="warm"):
        to.refine(mode="block", warm=False)
    jr, tr = jo.refine(mode="block"), to.refine(mode="block")
    assert tr.appended == 0 and tr.epochs == 0.0 and tr.mvms == 0
    np.testing.assert_allclose([tr.res_y, tr.res_z], [jr.res_y, jr.res_z])
    assert torch.equal(to.state.carry_v, block_fit["tstate"].carry_v)
    with pytest.raises(ValueError, match="unknown refine mode"):
        to.refine(mode="nope")


# -- merge and racing appends ------------------------------------------------------
def test_merge_refined_state_matches_reference(fitted):
    """The solved snapshot rows overwrite only the prefix; the rows
    appended meanwhile keep their zero carry and base noise."""
    st, tst = fitted["state"], fitted["tstate"]
    jcur = jax.tree.map(lambda a: a, st)
    from repro.core import extend_state as j_extend

    jcur = j_extend(st, 8)
    tcur = extend_state(tst, 8, rows=_t(jcur.probes.w_eps[128:]))
    jm = j_merge(jcur, st._replace(carry_v=st.carry_v + 1.0))
    tm_ = merge_refined_state(tcur, tst._replace(carry_v=tst.carry_v + 1.0))
    assert tm_.carry_v.shape == (136, 9)
    assert _rel(tm_.carry_v.numpy(), jm.carry_v) <= CARRY_REL
    assert torch.all(tm_.carry_v[128:] == 0)
    assert torch.equal(tm_.probes.w_eps, _t(jm.probes.w_eps))


@pytest.mark.parametrize("growth", ["exact", "geometric"])
def test_append_racing_refine_matches_reference(fitted, growth):
    """An append that lands while a refine solves (injected inside the
    solve, in both packages) survives the commit: its carry rows stay zero
    and it stays pending for the next refine. A 6-epoch budget fixes the
    iteration count (see ``test_solve_matches_reference``)."""
    x_new, y_new = make_gp_regression(jax.random.PRNGKey(11), 8, 2, noise=0.2)
    late_x, late_y = x_new[6:], y_new[6:]
    jo, to = _pair(fitted, growth=growth, reserve=16 if growth != "exact"
                   else 0)
    _append(jo, to, x_new[:6], y_new[:6])
    n0 = jo.n
    j_orig, t_orig = jo._jit_full, to._solve_full

    def j_racing(*a, **k):
        jo.append(late_x, late_y)
        return j_orig(*a, **k)

    jo._jit_full = j_racing
    jr = jo.refine(mode="solve", budget_epochs=6.0)
    rows = None if growth != "exact" else _t(jo.state.probes.w_eps[n0:])

    def t_racing(*a, **k):
        to.append(_t(late_x), _t(late_y), rows=rows)
        return t_orig(*a, **k)

    to._solve_full = t_racing
    tr = to.refine(mode="solve", budget_epochs=6.0)
    _check(jr, tr, jo, to, real_rows=n0)
    assert to.n == n0 + 2 and to.stats_dict()["pending_appends"] == 2
    assert torch.all(to.state.carry_v[n0:n0 + 2] == 0)
    assert torch.equal(to.state.probes.w_eps[:n0 + 2],
                       _t(jo.state.probes.w_eps[:n0 + 2]))


# -- refresh_into, engine, multimodel ----------------------------------------------
def test_refresh_into_background_matches_sync(fitted):
    """A background refresh resolves its Future with the report of the
    synchronous one and swaps the model in; a failing one carries the
    exception."""
    x_new, y_new = make_gp_regression(jax.random.PRNGKey(21), 8, 2, noise=0.2)
    _, sync = _pair(fitted)
    _, bg = _pair(fitted)
    rows = torch.randn(8, 8, generator=torch.Generator().manual_seed(0))
    for o in (sync, bg):
        o.append(_t(x_new), _t(y_new), rows=rows)
    engines = [BucketedEngine(export_servable(fitted["tstate"],
                                              _t(fitted["x"])), buckets=(32,))
               for _ in range(2)]
    rs = sync.refresh_into(engines[0], budget_epochs=50.0)
    fut = bg.refresh_into(engines[1], budget_epochs=50.0, background=True)
    rb = fut.result(timeout=120)
    assert rb._replace(trace_ids=()) == rs._replace(trace_ids=())
    assert engines[1].model.n == 136
    assert torch.equal(engines[0].model.correction, engines[1].model.correction)
    bad = bg.refresh_into(engines[1], mode="nope", background=True)
    with pytest.raises(ValueError, match="unknown refine mode"):
        bad.result(timeout=120)


def test_engine_queue_microbatches(fitted):
    """The reference's ``test_engine_queue_microbatches`` contract on the
    port: six queued 4-row requests resolve to the synchronous predictions
    and are coalesced into fewer dispatches; the instruments count them."""
    model = export_servable(fitted["tstate"], _t(fitted["x"]))
    reg = tm.MetricsRegistry()
    engine = BucketedEngine(model, buckets=(8, 32), registry=reg)
    engine.warmup()
    xq = _t(fitted["xall"][128:])
    gate = threading.Event()
    orig = engine._run_coalesced

    def held(first):  # queue all six before the worker starts draining
        gate.wait(10)
        return orig(first)

    engine._run_coalesced = held
    try:
        futs = [engine.enqueue(xq[i:i + 4]) for i in range(6)]
        gate.set()
        for i, f in enumerate(futs):
            pred = f.result(timeout=30)
            want = servable_predict(model, xq[i:i + 4])
            np.testing.assert_allclose(pred.mean.numpy(), want.mean.numpy(),
                                       rtol=1e-5, atol=1e-6)
    finally:
        engine.stop()
    stats = engine.stats_dict()
    assert stats["requests"] == 6 and stats["batches"] < 6
    assert stats["coalesced"] >= 2 and stats["num_compiles"] is None
    text = reg.render()
    assert "gp_engine_requests_total 6" in text
    assert f"gp_engine_batches_total{{bucket=\"32\"}} {stats['batches']}" in text
    assert 'gp_engine_rows_total{kind="real"} 24' in text


def test_engine_errors_fail_their_futures(fitted):
    """A worker exception fails every request it carried; the worker lives
    on and serves the next request."""
    model = export_servable(fitted["tstate"], _t(fitted["x"]))
    engine = BucketedEngine(model, buckets=(8,), registry=tm.NULL_REGISTRY)
    try:
        bad = engine.enqueue(torch.zeros(3, 5))  # wrong width
        with pytest.raises(Exception):
            bad.result(timeout=30)
        good = engine.enqueue(_t(fitted["xall"][128:131]))
        assert good.result(timeout=30).mean.shape == (3,)
    finally:
        engine.stop()
    assert engine._worker is None


def test_multimodel_routes_and_swaps(fitted):
    """Named models route to their own kernels, as the reference's server
    (predictions against the reference's on the same artifacts)."""
    st, x = fitted["tstate"], _t(fitted["x"])
    m32 = export_servable(st, x)
    mrbf = export_servable(st._replace(params=st.params._replace(
        kernel="rbf")), x, kind="rbf")
    server = MultiModelServer(buckets=(8, 32))
    server.register("m32", m32)
    server.register("rbf", mrbf, warmup=True)
    assert server.names() == ("m32", "rbf") and server.warmup() is None
    jst = fitted["state"]
    jserver = JServer(buckets=(8, 32), bm=64, bn=64)
    jserver.register("m32", j_export(jst, fitted["x"]))
    jserver.register("rbf", j_export(jst._replace(params=jst.params._replace(
        kernel="rbf")), fitted["x"], kind="rbf"))
    xq = fitted["xall"][128:136]
    for name in ("m32", "rbf"):
        np.testing.assert_allclose(server.submit(name, _t(xq)).mean.numpy(),
                                   np.asarray(jserver.submit(name, xq).mean),
                                   rtol=PRED_RTOL, atol=PRED_ATOL)
    p32, prbf = server.submit("m32", _t(xq)), server.submit("rbf", _t(xq))
    assert float(torch.max(torch.abs(p32.mean - prbf.mean))) > 1e-6
    server.swap("m32", mrbf)
    assert torch.equal(server.enqueue("m32", _t(xq)).result(30).mean,
                       prbf.mean)
    server.engine.stop()
    with pytest.raises(ValueError, match="already registered"):
        server.register("m32", m32)
    with pytest.raises(KeyError):
        server.submit("nope", _t(xq))
    with pytest.raises(KeyError):
        server.swap("nope", m32)
    assert server.unregister("rbf") is mrbf and server.names() == ("m32",)
    # refresh_into a named model
    online = OnlineGP(x, _t(fitted["y"]), st, fitted["tcfg"])
    online.append(_t(xq[:2]), _t(fitted["yall"][128:130]))
    online.refresh_into(server, name="m32", budget_epochs=20.0)
    assert server.get("m32").n == 130


# -- geometric growth ------------------------------------------------------------
def test_geometric_growth_real_rows_match_reference(online_fit):
    """Geometric growth against the reference on the REAL rows only.

    The reference's ghost rows sit at ~1e3 per coordinate, where its
    expanded ``|a|^2 + |b|^2 - 2 a.b`` cancels in fp32, so some of its ghost
    diagonals are not ``s^2`` (a reference fault). The port takes ``r2`` by
    direct differences, so every ghost diagonal is ``s^2``: ghost-row
    solutions (and residual norms, which include them) may differ from the
    reference's, while every cross term between ghost and real rows
    underflows to 0 in both, so the real rows agree at solver tolerance.
    Ghost inputs, capacity and the real-row carry are compared; the
    predictions (ghosts contribute 0) and the growth events too."""
    x_new = online_fit["x"][:16] + 8.0
    y_new = jax.random.normal(jax.random.PRNGKey(3), (16,)) * 0.5
    jo, to = _pair(online_fit, growth=GROWTH_GEOMETRIC)
    _append(jo, to, x_new, y_new)
    assert to.capacity == jo.capacity == 256 and to.n == 144
    assert torch.equal(to.x, _t(jo.x))
    jr, tr = jo.refine(mode="solve"), to.refine(mode="solve")
    n = to.n
    tol = online_fit["tcfg"].solver.tolerance
    assert max(tr.res_y, tr.res_z, jr.res_y, jr.res_z) <= tol
    assert _rel(to.state.carry_v.numpy()[:n],
                np.asarray(jo.state.carry_v)[:n]) <= 10 * tol
    xq = online_fit["xall"][144:176]
    pt = servable_predict(to.export(), _t(xq))
    pj = j_predict(jo.export(), xq, bm=64, bn=64)
    scale = float(np.std(np.asarray(pj.mean))) + 1e-6
    assert float(np.max(np.abs(pt.mean.numpy() - np.asarray(pj.mean)))) \
        / scale < 10 * tol
    assert to.export().x.shape[0] == to.capacity
    assert to.stats_dict()["growth_events"] == 1
    with pytest.raises(ValueError, match="step"):
        to.refine(mode="step")


def test_geometric_reserve_keeps_capacity_over_appends(online_fit):
    """With ``reserve=`` covering the stream, one-row appends plus block
    refines never grow capacity again (the shape contract that the
    reference holds by compile counts); the real-row carry tracks the
    reference's within 10x the solver tolerance."""
    jo, to = _pair(online_fit, growth=GROWTH_GEOMETRIC, reserve=32)
    cap = to.capacity
    assert cap == jo.capacity and to.stats_dict()["growth_events"] == 1
    key = jax.random.PRNGKey(7)
    for r in range(8):
        xr = online_fit["x"][:1] + 8.0 + 0.05 * r
        yr = jax.random.normal(jax.random.fold_in(key, r), (1,)) * 0.5
        _append(jo, to, xr, yr)
        jr, tr = jo.refine(mode="block"), to.refine(mode="block")
        assert tr.block_rows == jr.block_rows == 1
    stats = to.stats_dict()
    assert to.capacity == cap and stats["growth_events"] == 1
    assert stats["num_solve_compiles"] is None and stats["refines"] == 8
    n = to.n
    tol = online_fit["tcfg"].solver.tolerance
    assert _rel(to.state.carry_v.numpy()[:n],
                np.asarray(jo.state.carry_v)[:n]) <= 10 * tol


@pytest.mark.parametrize("kind", KINDS)
def test_ghost_diagonal_is_the_profile_at_zero(online_fit, kind):
    """Every ghost's kernel diagonal through the forward kernel's plain
    version (what the ``cuda`` backend multiplies by) is ``s^2 kappa(0)``
    — ``s^2`` for every kernel but Matérn-1/2, whose profile floors ``r2``
    — and every ghost-to-real and ghost-to-ghost cross term is exactly 0."""
    _, to = _pair(online_fit, growth=GROWTH_GEOMETRIC, reserve=64)
    p, n = to.state.params, to.n
    u = to.x / p.lengthscales
    ghosts = u[n:]
    assert float(ghosts.abs().max()) > 1e3  # far out, as the fault needs
    diag = torch.stack([kernel_mvm_plain(g[None], g[None], torch.ones(1, 1),
                                         kind)[0, 0] for g in ghosts])
    want = profile_from_r2(kind)(torch.zeros(()), torch.ones(()))
    assert torch.equal(diag, want.expand_as(diag))
    if kind != "matern12":
        assert float(want) == 1.0
    ones = torch.ones(u.shape[0], 1)
    cross = kernel_mvm_plain(ghosts, u, ones, kind)[:, 0] - diag
    assert torch.all(cross == 0)


def test_reference_ghost_diagonals_are_why_ghost_rows_are_excluded(online_fit):
    """The reference fault the geometric-growth parity accounts for, at
    this fixture (capacity 256, 128 ghosts): the reference's expanded
    ``r2`` gives some ghost diagonals other than ``s^2`` (120 of the 128
    keep ``s^2``), the port's direct differences give every one ``s^2``.
    If the reference is repaired this test fails, and ghost rows can then
    be held to it too."""
    from repro.gp.kernels_math import kernel_matrix as j_kernel_matrix

    jo, to = _pair(online_fit, growth=GROWTH_GEOMETRIC, reserve=64)
    n, p = jo.n, jo.state.params
    g = jo.x[n:]
    jdiag = np.asarray(jnp.stack([j_kernel_matrix(g[i:i + 1], g[i:i + 1], p)[0, 0]
                                  for i in range(g.shape[0])]))
    s2 = np.float32(np.asarray(p.signal) ** 2)
    u = to.x[n:] / to.state.params.lengthscales
    tdiag = torch.stack([kernel_mvm_plain(r[None], r[None], torch.ones(1, 1),
                                          "matern32")[0, 0] for r in u])
    assert torch.all(tdiag == 1.0) and g.shape[0] == 128
    assert int(np.sum(jdiag == s2)) == 120, int(np.sum(jdiag == s2))


# -- step mode -------------------------------------------------------------------
def test_step_mode_matches_reference(fitted):
    """``refine(mode="step")`` under exact growth: one outer step on the
    enlarged system (hyperparameters move) against the reference's, its
    solve under a 5-epoch budget (see ``test_solve_matches_reference``)."""
    x_new, y_new = make_gp_regression(jax.random.PRNGKey(11), 16, 2, noise=0.2)
    jo, to = _pair(fitted)
    _append(jo, to, x_new, y_new)
    jr = jo.refine(mode="step", budget_epochs=5.0)
    tr = to.refine(mode="step", budget_epochs=5.0)
    _check(jr, tr, jo, to)
    np.testing.assert_allclose(to.state.params.flat().numpy(),
                               np.asarray(jo.state.params.flat()),
                               rtol=1e-4, atol=1e-6)
    assert to.state.step == int(jo.state.step) and tr.mvms == tr.iters + 2


# -- observability ---------------------------------------------------------------
def test_stats_metrics_and_refresh_events(loose_fit, tmp_path):
    """``stats_dict`` has the reference's keys and values after the same
    refines; the ``gp_refresh_*`` families count them; each refine emits
    one ``refresh`` event carrying the trace IDs of its appends."""
    jo, to = _pair(loose_fit)
    path = tmp_path / "events.jsonl"
    tt.configure(path=str(path))
    try:
        reg = tm.default_registry()
        before = reg.get("gp_refresh_refines_total")
        before = 0.0 if before is None else before.value(mode="auto")
        with tt.trace_context("append-1"), jt.trace_context("append-1"):
            _append(jo, to, loose_fit["xall"][128:130],
                    loose_fit["yall"][128:130])
        jr = jo.refine(mode="auto", correction="damped")
        tr = to.refine(mode="auto", correction="damped")
        _check(jr, tr, jo, to)
        to.refine(mode="block")
        jo.refine(mode="block")
    finally:
        tt.configure()
    js, ts = jo.stats_dict(), to.stats_dict()
    assert set(ts) == set(js) and ts["num_solve_compiles"] is None
    for k in ("refines", "appends", "appended_rows", "escalations",
              "corrections", "growth_events", "cum_iters", "n", "capacity",
              "growth", "pending_appends"):
        assert ts[k] == js[k], k
    np.testing.assert_allclose(ts["cum_epochs"], js["cum_epochs"],
                               rtol=RES_RTOL)
    assert set(ts["last"]) == set(js["last"])
    import json

    json.dumps(ts)
    events = [json.loads(line) for line in open(path)]
    refresh = [e for e in events if e["kind"] == "refresh"]
    assert len(refresh) == 2 == ts["refines"]
    assert refresh[0]["trace_ids"] == ["append-1"] and refresh[1]["trace_ids"] == []
    assert tr.trace_ids == ("append-1",)
    text = tm.render_prometheus()
    assert reg.get("gp_refresh_refines_total").value(mode="auto") == before + 1
    for fam in ("gp_refresh_refines_total", "gp_refresh_appended_rows_total",
                "gp_refresh_escalations_total", "gp_refresh_epochs_total",
                "gp_refresh_pending_appends"):
        assert f"# TYPE {fam} " in text, fam


# -- artifacts -------------------------------------------------------------------
def test_reference_artifact_loads_bitwise(fitted, tmp_path):
    """A ServableGP saved by the reference loads in the port with
    bitwise-equal leaves (the reference's pytree order), and predicts as
    the reference's."""
    jm = j_export(fitted["state"], fitted["x"])
    j_save(str(tmp_path), jm, step=4)
    tmod = load_servable(str(tmp_path), device="cpu")
    want = interop.servable_from_numpy(_np_servable(jm))
    for a, b in zip(
            [tmod.x, tmod.correction, tmod.rff.z, tmod.rff.u, tmod.rff.w,
             *tmod.params.leaves],
            [want.x, want.correction, want.rff.z, want.rff.u, want.rff.w,
             *want.params.leaves]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (tmod.kind, tmod.rff.kind, tmod.params.kernel) == \
        (jm.kind, jm.rff.kind, jm.params.kernel)
    xq = fitted["xall"][128:]
    np.testing.assert_allclose(servable_predict(tmod, _t(xq)).mean.numpy(),
                               np.asarray(j_predict(jm, xq, bm=64, bn=64).mean),
                               rtol=PRED_RTOL, atol=PRED_ATOL)


def test_port_artifact_loads_in_reference_bitwise(fitted, tmp_path):
    """The reverse: the port's ``save_servable`` (with ``keep``) loads in the
    reference with bitwise-equal leaves; the sidecar is the reference's."""
    tmod = export_servable(fitted["tstate"], _t(fitted["x"]))
    for step in (1, 2, 3):
        path = save_servable(str(tmp_path), tmod, step=step, keep=2)
    assert path.endswith("step_3.npz")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_2.json", "step_2.npz", "step_3.json", "step_3.npz"]
    jm = j_load(str(tmp_path))
    mine = [tmod.x, tmod.correction, tmod.rff.z, tmod.rff.u, tmod.rff.w,
            *tmod.params.leaves]
    for a, b in zip(jax.tree.leaves(jm), mine):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert jm.kind == tmod.kind and jm.params.kernel == tmod.params.kernel
    again = load_servable(str(tmp_path), step=2, device="cpu")
    assert torch.equal(again.correction, tmod.correction)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            load_servable(str(tmp_path))
    with pytest.raises(ValueError, match="ServableGP"):
        from repro_torch.checkpoint import save_checkpoint

        save_checkpoint(str(tmp_path / "other"), 0, fitted["tstate"])
        load_servable(str(tmp_path / "other"), device="cpu")


# -- the serve CLI ---------------------------------------------------------------
_PRINTED = re.compile(r"rmse=([-\d.]+) llh=([-\d.]+)")


@pytest.fixture(scope="module")
def cli_fit():
    """The reference CLI's ``_fit_gp`` on pol cut to 300 rows, 2 steps."""
    from repro.launch import serve as jserve

    args = SimpleNamespace(dataset="pol", max_n=300, train_steps=2, seed=0,
                           requests=3, buckets="16,64", http=None,
                           compat=False, refresh_every=0)
    ds, cfg, state = jserve._fit_gp(args)
    return args, ds, cfg, state


@pytest.mark.parametrize("flag", ["compat", "refresh_every"])
def test_serve_cli_modes_match_reference(cli_fit, capsys, flag):
    """``--compat`` and ``--refresh-every 1`` from the reference CLI's fitted
    state (and, for the refresh, its appended rows' base noise): the
    printed RMSE/LLH within rtol 1e-3 of the reference CLI's (beyond the
    4-decimal print)."""
    from repro.launch import serve as jserve
    from repro_torch.data.synthetic import Dataset

    args, ds, cfg, state = cli_fit
    jargs = SimpleNamespace(**{**vars(args), "compat": flag == "compat",
                               "refresh_every": int(flag == "refresh_every")})
    capsys.readouterr()
    jserve.serve_gp(jargs, ds, cfg, state)
    want = [float(v) for v in _PRINTED.findall(capsys.readouterr().out)[-1]]
    targs = tserve.build_parser().parse_args(
        ["--device", "cpu", "--max-n", "300", "--train-steps", "2",
         "--requests", "3", "--buckets", "16,64", "--num-probes", "32"]
        + (["--compat"] if flag == "compat" else ["--refresh-every", "1"]))
    tds = Dataset(*(_t(a) for a in (ds.x_train, ds.y_train, ds.x_test,
                                    ds.y_test)), name="pol")
    rows = None
    blk = min(64, ds.x_test.shape[0])
    if flag == "refresh_every":
        _, knew = jax.random.split(state.key)
        rows = _t(jax.random.normal(knew, (blk, 32)))
    tstate = interop.outer_state_from_numpy(_np_state(state))
    if flag == "compat":
        report = tserve.serve_gp_compat(targs, tds, tstate)
    else:
        out = tserve.serve_gp(targs, ds=tds, cfg=tserve.gp_config(targs),
                              state=tstate, refresh_rows=rows)
        report = out.report
    printed = capsys.readouterr().out
    got = [float(v) for v in _PRINTED.findall(printed)[-1]]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose([report["rmse"], report["llh"]], want,
                               rtol=1e-3, atol=1e-4)
    if flag == "refresh_every":
        n = ds.x_train.shape[0] + blk
        assert f"online refresh: +{blk} rows -> n={n}" in printed
        assert out.engine.model.n == n and out.refresh.n == n


def test_serve_cli_refuses_http():
    """``--http`` serves since the HTTP/cluster slice; what it still refuses
    is a configuration it cannot run: several replicas without the store
    that hands them the model."""
    with pytest.raises(SystemExit, match="needs --artifact-store"):
        tserve.main(["--device", "cpu", "--max-n", "200", "--train-steps",
                     "1", "--num-probes", "4", "--http", "127.0.0.1:0",
                     "--replicas", "2"])


def test_serve_cli_compat_dispatch(capsys):
    """``--compat`` through the CLI entry fits, then runs the legacy loop."""
    tserve.main(["--device", "cpu", "--max-n", "200", "--train-steps", "1",
                 "--requests", "2", "--num-probes", "4", "--compat"])
    assert "[serve-gp compat] 2 requests x 64" in capsys.readouterr().out


def test_predictions_type_is_shared():
    """The engine and the refresher hand out the core Predictions type."""
    assert BucketedEngine.submit.__annotations__["return"] in (
        Predictions, "Predictions")
