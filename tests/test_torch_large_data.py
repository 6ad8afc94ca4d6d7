"""The port's large-dataset path against the JAX reference: the
initialisation heuristic with the reference's centroids replayed, the
row-chunked RFF prior sample, and the twin of
``examples/budget_large_scale.py`` (heuristic, then AP fits cold and warm
under a 3-epoch budget) with the reference's draws handed over. Inputs are
numpy draws from fixed seeds or the reference's own data; the port's
``cuda`` backend runs the kernels' plain versions on these CPU tensors."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import OuterConfig as JOuterConfig  # noqa: E402
from repro.core import fit as j_fit  # noqa: E402
from repro.core import init_hypers_heuristic as j_heuristic  # noqa: E402
from repro.core import init_outer_state as j_init  # noqa: E402
from repro.core.outer import _resample_probes as j_resample  # noqa: E402
from repro.data.synthetic import load_dataset as j_load  # noqa: E402
from repro.data.synthetic import pad_to_block_multiple as j_pad  # noqa: E402
from repro.gp.hyperparams import HyperParams as JHyperParams  # noqa: E402
from repro.gp.rff import init_rff as j_init_rff  # noqa: E402
from repro.gp.rff import prior_sample_at as j_prior  # noqa: E402
from repro.solvers import SolverConfig as JSolverConfig  # noqa: E402
from repro.train.adam import AdamConfig as JAdamConfig  # noqa: E402
from repro_torch.core import init_hypers_heuristic  # noqa: E402
from repro_torch.core import outer as touter  # noqa: E402
from repro_torch.core.driver import nearest_rows  # noqa: E402
from repro_torch.core.estimators import ProbeState  # noqa: E402
from repro_torch.data.synthetic import Dataset  # noqa: E402
from repro_torch.gp import rff as trff  # noqa: E402
from repro_torch.gp.hyperparams import HyperParams  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
KINDS = ("rbf", "matern12", "matern32", "matern52")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _centroids(key, n, count):
    """The reference heuristic's centroid rows: ``randint(k, (), 0, n)`` for
    each ``k`` of ``split(key, count)``."""
    return [int(jax.random.randint(k, (), 0, n))
            for k in jax.random.split(key, count)]


def _leaves(p):
    return [np.asarray(a) for a in (p.raw_lengthscales, p.raw_signal,
                                    p.raw_noise)]


def _port_probes(jp):
    """The reference's ProbeState as the port's (same draws)."""
    def t(a):
        return None if a is None else torch.tensor(np.asarray(a))

    rff = None if jp.rff is None else trff.RFFState(
        t(jp.rff.z), t(jp.rff.u), t(jp.rff.w), kind=jp.rff.kind)
    return ProbeState(jp.estimator, t(jp.z), rff, t(jp.w_eps))


# -- the initialisation heuristic -------------------------------------------


def _heuristic_data(n=600, d=3, seed=31):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, size=(n, d)).astype(np.float32)
    y = (np.sin(1.5 * x[:, 0]) + 0.5 * np.cos(x[:, 1] * x[:, -1])
         + 0.1 * rng.normal(size=n)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("kind", ["matern32", "rbf"])
def test_init_hypers_heuristic_matches_reference(kind):
    """n 600, d 3, subsets of 200 around 3 centroids, 10 Adam steps: with
    the reference's centroids handed over, each centroid's nearest-neighbour
    set equals the reference's, and the averaged raw leaves agree within
    1e-4 relative (fp32 Cholesky and Adam in two frameworks)."""
    x, y = _heuristic_data()
    key = jax.random.PRNGKey(32)
    centroids = _centroids(key, x.shape[0], 3)
    for i in centroids:
        ref = np.asarray(jnp.argsort(jnp.sum((jnp.asarray(x) - x[i]) ** 2,
                                             axis=1))[:200])
        got = nearest_rows(torch.tensor(x), i, 200).numpy()
        assert np.array_equal(np.sort(got), np.sort(ref))
    jp = j_heuristic(key, jnp.asarray(x), jnp.asarray(y), subset_size=200,
                     num_centroids=3, num_steps=10, kind=kind)
    tp = init_hypers_heuristic(None, torch.tensor(x), torch.tensor(y),
                               subset_size=200, num_centroids=3, num_steps=10,
                               kind=kind, centroids=centroids)
    assert tp.kernel == kind
    for got, ref in zip(tp.leaves, _leaves(jp)):
        assert _rel(got.numpy(), ref) <= 1e-4


def test_init_hypers_heuristic_draws_centroids_from_the_generator():
    """Without ``centroids`` the rows come from the generator: the same
    seed gives the same result, the subset is capped at n, and a wrong
    number of centroids raises."""
    x, y = (torch.tensor(a) for a in _heuristic_data(n=150))
    kw = dict(subset_size=500, num_centroids=2, num_steps=3)
    a = init_hypers_heuristic(torch.Generator().manual_seed(5), x, y, **kw)
    b = init_hypers_heuristic(torch.Generator().manual_seed(5), x, y, **kw)
    for p, q in zip(a.leaves, b.leaves):
        assert torch.equal(p, q) and torch.isfinite(p).all()
    with pytest.raises(ValueError, match="centroids"):
        init_hypers_heuristic(None, x, y, centroids=[1, 2, 3], **kw)


# -- the row-chunked prior sample --------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_chunked_prior_sample_matches_reference(kind, monkeypatch):
    """50 rows in chunks of 7 (which does not divide 50): the reference's
    ``prior_sample_at`` on the same draws within 1e-5 of the largest value,
    and the unchunked feature product of the port to the bit per row
    chunk's arithmetic within 1e-6."""
    rng = np.random.default_rng(33)
    x = rng.normal(size=(50, 4)).astype(np.float32)
    leaves = (rng.uniform(-0.2, 0.9, size=4).astype(np.float32),
              np.float32(0.4), np.float32(-0.6))
    jparams = JHyperParams(*map(jnp.asarray, leaves), kernel=kind)
    tparams = HyperParams(*map(torch.tensor, leaves), kernel=kind)
    st = j_init_rff(jax.random.PRNGKey(34), 64, 4, 5, kind=kind)
    tst = trff.RFFState(*(torch.tensor(np.asarray(a))
                          for a in (st.z, st.u, st.w)), kind=kind)
    monkeypatch.setattr(trff, "PRIOR_ROW_CHUNK", 7)
    got = trff.prior_sample_at(torch.tensor(x), tst, tparams).numpy()
    ref = np.asarray(j_prior(jnp.asarray(x), st, jparams))
    assert got.shape == (50, 5)
    assert _rel(got, ref) <= 1e-5
    whole = (trff.rff_features(torch.tensor(x), tst, tparams) @ tst.w).numpy()
    assert _rel(got, whole) <= 1e-6


# -- the twin of examples/budget_large_scale.py -------------------------------


def _example():
    spec = importlib.util.spec_from_file_location(
        "torch_budget_large_scale",
        REPO / "examples" / "torch_budget_large_scale.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_budget_example_matches_reference(monkeypatch, capsys):
    """The twin's ``run`` on 3droad cut to 889 rows (800 train rows: four
    200-row blocks), 3 outer steps cold and warm, against the reference's
    heuristic + ``fit`` on the same data, with the reference's centroids,
    initial probes and (cold start) per-step probes handed over: the
    heuristic's raw leaves, the iterations, and both res_y and res_z
    histories within 1e-4 relative (the bound of the AP/SGD trajectory
    tests), and the lines the reference prints.

    Not the reference example's 800 rows: those give 720 train rows padded
    with 80 phantom rows at ~1e6, where the reference's expanded r2 loses
    the kernel's diagonal and the port's direct r2 keeps it (a deliberate
    difference, ``test_padded_block_diagonal_is_exact_at_phantom_points``);
    the residual norms and AP's block choice include those rows, so there
    the two differ by design (6.6e-3 in res_z at step 2, measured)."""
    ex = _example()
    jds = j_load("3droad", max_n=889)
    ds = Dataset(*(torch.tensor(np.asarray(a)) for a in jds[:4]),
                 name="3droad")
    args = ex.build_parser().parse_args(
        ["--device", "cpu", "--max-n", "889", "--steps", "3"])
    jx, jy = jds.x_train, jds.y_train
    assert jx.shape[0] % args.block_size == 0
    key = jax.random.PRNGKey(1)
    jinit = j_heuristic(key, jx, jy, subset_size=500, num_centroids=3,
                        num_steps=15)
    refs, probes, fresh = {}, {}, []
    for warm in (False, True):
        tcfg = ex.config(args, warm)
        jcfg = JOuterConfig(
            estimator="pathwise", warm_start=warm, num_probes=32,
            solver=JSolverConfig(name="ap", tolerance=0.01, max_epochs=3,
                                 block_size=args.block_size),
            adam=JAdamConfig(learning_rate=0.03), num_steps=3, bm=512, bn=512)
        assert (tcfg.num_probes, tcfg.solver.max_epochs) == (32, 3)
        fkey = jax.random.PRNGKey(0)
        jst = j_init(fkey, jcfg, jx, init_params=jinit)
        refs[warm] = j_fit(jx, jy, jcfg, key=fkey, init_params=jinit,
                           x_test=jds.x_test, y_test=jds.y_test,
                           eval_every=3)
        probes[warm] = _port_probes(jst.probes)
        if not warm:
            skey = jst.key
            for _ in range(3):
                skey, _, kprobe = jax.random.split(skey, 3)
                fresh.append(_port_probes(j_resample(kprobe, jst.probes, jx)))
    monkeypatch.setattr(touter, "resample_probes",
                        lambda gen, pr, x: fresh.pop(0))
    out = ex.run(ds, args, centroids=_centroids(key, jx.shape[0], 3),
                 probes=probes)
    assert not fresh
    for got, ref in zip(out["init"].leaves, _leaves(jinit)):
        assert _rel(got.numpy(), ref) <= 1e-4
    printed = capsys.readouterr().out
    assert "heuristic init:" in printed
    for warm in (False, True):
        h, jh = out[warm].history, refs[warm].history
        assert list(h["iters"]) == list(np.asarray(jh["iters"]))
        assert _rel(h["res_z"], jh["res_z"]) <= 1e-4
        assert _rel(h["res_y"], jh["res_y"]) <= 1e-4
        assert len(h["eval_llh"]) == 1 and np.isfinite(h["eval_llh"][0])
        assert f"warm_start={warm}: res_z first->last" in printed


def test_budget_example_main_on_cpu(capsys):
    """``main`` with ``--device cpu`` at a tiny size: the port's own draws,
    one line per start mode, finite residuals and test LLH."""
    out = _example().main(["--device", "cpu", "--max-n", "300",
                           "--block-size", "100", "--steps", "2",
                           "--subset-size", "100", "--num-centroids", "2",
                           "--heuristic-steps", "3"])
    printed = capsys.readouterr().out
    assert printed.count("res_z first->last") == 2
    for warm in (False, True):
        h = out[warm].history
        assert len(h["res_z"]) == 2 and np.isfinite(h["res_z"]).all()
        assert np.isfinite(h["eval_llh"]).all()
        assert all(e <= 3.0 for e in h["epochs"])

