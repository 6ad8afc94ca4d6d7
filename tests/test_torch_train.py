"""The port's training slice against the JAX reference: the exact GP oracle,
pivoted Cholesky and the preconditioner (every kernel, ``AUTO_RANK``
included), preconditioned CG, outer steps without warm starting (the
reference's per-step probe draws handed over), evaluation, checkpoints
(resume, and a reference checkpoint read through ``interop``), and the
train CLI on the CPU (the GP path; an LM architecture's SMOKE path and an
unknown architecture). Inputs are numpy draws from fixed seeds."""
import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import OuterConfig as JOuterConfig  # noqa: E402
from repro.core import fit as j_fit  # noqa: E402
from repro.core import init_outer_state as j_init  # noqa: E402
from repro.core.driver import evaluate as j_evaluate  # noqa: E402
from repro.core.estimators import init_probes as j_init_probes  # noqa: E402
from repro.core.outer import _resample_probes as j_resample  # noqa: E402
from repro.gp import exact as jexact  # noqa: E402
from repro.gp.hyperparams import HyperParams as JHyperParams  # noqa: E402
from repro.solvers import HOperator as JHOperator  # noqa: E402
from repro.solvers import SolverConfig as JSolverConfig  # noqa: E402
from repro.solvers import precond as jprecond  # noqa: E402
from repro.solvers.cg import solve_cg as j_cg  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.core.driver import evaluate, fit  # noqa: E402
from repro_torch.core.estimators import ProbeState  # noqa: E402
from repro_torch.core.outer import OuterConfig, init_outer_state, outer_step  # noqa: E402
from repro_torch.gp import exact as texact  # noqa: E402
from repro_torch.gp.hyperparams import HyperParams  # noqa: E402
from repro_torch.gp.rff import RFFState  # noqa: E402
from repro_torch.interop import outer_state_from_checkpoint, outer_state_from_numpy  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.solvers import HOperator, SolverConfig  # noqa: E402
from repro_torch.solvers import precond as tprecond  # noqa: E402
from repro_torch.solvers.cg import solve_cg  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
KINDS = ("rbf", "matern12", "matern32", "matern52")
N, D, S, PAIRS, CG_ITERS = 96, 3, 6, 32, 6


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


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _np_params(p):
    return {"raw_lengthscales": np.asarray(p.raw_lengthscales),
            "raw_signal": np.asarray(p.raw_signal),
            "raw_noise": np.asarray(p.raw_noise), "kernel": p.kernel}


def _np_probes(pr):
    rff = None if pr.rff is None else {
        "z": np.asarray(pr.rff.z), "u": np.asarray(pr.rff.u),
        "w": np.asarray(pr.rff.w), "kind": pr.rff.kind}
    return {"estimator": pr.estimator,
            "z": None if pr.z is None else np.asarray(pr.z), "rff": rff,
            "w_eps": None if pr.w_eps is None else np.asarray(pr.w_eps)}


def _np_state(st):
    return {"params": _np_params(st.params),
            "adam": {"step": np.asarray(st.adam.step),
                     "mu": _np_params(st.adam.mu),
                     "nu": _np_params(st.adam.nu)},
            "probes": _np_probes(st.probes), "carry_v": np.asarray(st.carry_v),
            "step": np.asarray(st.step)}


def _port_probes(jp):
    """The reference's ProbeState as the port's (same draws)."""
    def t(a):
        return None if a is None else torch.tensor(np.asarray(a))

    rff = None if jp.rff is None else RFFState(t(jp.rff.z), t(jp.rff.u),
                                               t(jp.rff.w), kind=jp.rff.kind)
    return ProbeState(jp.estimator, t(jp.z), rff, t(jp.w_eps))


def _configs(estimator, warm_start, num_steps=3, precond_rank=10, **over):
    solver = dict(name="cg", tolerance=0.0, max_epochs=CG_ITERS,
                  precond_rank=precond_rank)
    common = dict(estimator=estimator, warm_start=warm_start, num_probes=S,
                  num_rff_pairs=PAIRS, num_steps=num_steps, bm=64, bn=64,
                  **over)
    return (JOuterConfig(solver=JSolverConfig(**solver), backend="streamed",
                         **common),
            OuterConfig(solver=SolverConfig(**solver), backend="cuda", **common))


@pytest.mark.parametrize("kind", ["rbf", "matern32"])
def test_exact_gp_matches_reference(kind):
    """Exact MLL, its gradient (per leaf) and the exact posterior vs the
    reference's, at 1e-5 relative (fp32 Cholesky of a 60 x 60 matrix)."""
    x, y = _data(60, seed=1)
    xs, _ = _data(20, seed=2)
    jp, tp = _params(D, 3, kind)
    jm, jg = jexact.exact_mll_grad(jnp.asarray(x), jnp.asarray(y), jp)
    tm, tg = texact.exact_mll_grad(torch.tensor(x), torch.tensor(y), tp)
    np.testing.assert_allclose(float(tm), float(jm), rtol=1e-5)
    np.testing.assert_allclose(
        float(texact.exact_mll(torch.tensor(x), torch.tensor(y), tp)),
        float(jm), rtol=1e-5)
    for a, b in zip(tg.leaves, jax.tree.leaves(jg)):
        assert _rel(a.numpy(), b) <= 1e-4
    jpost = jexact.exact_posterior(jnp.asarray(x), jnp.asarray(y),
                                   jnp.asarray(xs), jp)
    tpost = texact.exact_posterior(torch.tensor(x), torch.tensor(y),
                                   torch.tensor(xs), tp)
    assert _rel(tpost.mean.numpy(), jpost.mean) <= 1e-4
    assert _rel(tpost.var.numpy(), jpost.var) <= 1e-4


@pytest.mark.parametrize("kind", KINDS)
def test_pivoted_cholesky_and_preconditioner_match_reference(kind):
    """Rank-12 pivoted Cholesky (factor within 1e-4 of its largest entry,
    fp32 Schur updates), then the AUTO_RANK preconditioner from the
    per-kernel table: P^{-1} r within 1e-4 relative of the reference's."""
    x, _ = _data(200, seed=4)
    r = np.random.default_rng(5).normal(size=(200, 3)).astype(np.float32)
    jp, tp = _params(D, 6, kind)
    jop, top = JHOperator(jnp.asarray(x), jp), HOperator(torch.tensor(x), tp)
    jl = np.asarray(jprecond.pivoted_cholesky(jop, 12))
    tl = tprecond.pivoted_cholesky(top, 12).numpy()
    assert _rel(tl, jl) <= 1e-4
    assert tprecond.PRECOND_DEFAULTS == {
        k: tuple(v) for k, v in jprecond.PRECOND_DEFAULTS.items()}
    jpc = jprecond.build_preconditioner(jop, jprecond.AUTO_RANK)
    tpc = tprecond.build_preconditioner(top, tprecond.AUTO_RANK)
    assert tpc.l.shape == jpc.l.shape == (200, tprecond.default_precond(kind).rank)
    assert _rel(tpc.apply(torch.tensor(r)).numpy(), jpc.apply(jnp.asarray(r))) <= 1e-4


def test_operator_row_diag_and_dense_match_reference():
    """kernel_row (0-d index tensor), kernel_diag and dense H vs the
    reference: the row at 1e-5 of its largest entry (the port's direct
    differences vs the reference's expanded form differ by ~1e-6 at the
    coincident entry), the diagonal at 1e-6 and dense H at 2e-6 (the same
    expanded fp32 formula, rounded in another order)."""
    x, _ = _data(50, seed=7)
    jp, tp = _params(D, 8)
    jop, top = JHOperator(jnp.asarray(x), jp), HOperator(torch.tensor(x), tp)
    assert _rel(top.kernel_row(torch.tensor(17)).numpy(),
                jop.kernel_row(jnp.asarray(17))) <= 1e-5
    assert _rel(top.kernel_diag().numpy(), jop.kernel_diag()) <= 1e-6
    assert _rel(top.dense().numpy(), jop.dense()) <= 2e-6


def test_preconditioned_cg_matches_reference():
    """Rank-20 preconditioned CG to tolerance 0.01 from a cold start:
    iteration counts within +-1 and solutions within 1e-2 relative (one
    iteration more or less moves the iterate by about the tolerance)."""
    x, _ = _data(150, seed=9)
    b = np.random.default_rng(10).normal(size=(150, 4)).astype(np.float32)
    jp, tp = _params(D, 11)
    cfg = dict(tolerance=0.01, max_epochs=500, precond_rank=20)
    jres = j_cg(JHOperator(jnp.asarray(x), jp, backend="streamed", bm=64, bn=64),
                jnp.asarray(b), None, JSolverConfig(**cfg))
    tres = solve_cg(HOperator(torch.tensor(x), tp, backend="cuda"),
                    torch.tensor(b), None, SolverConfig(**cfg))
    plain = solve_cg(HOperator(torch.tensor(x), tp, backend="cuda"),
                     torch.tensor(b), None,
                     SolverConfig(**{**cfg, "precond_rank": 0}))
    assert abs(tres.iters - int(jres.iters)) <= 1
    assert tres.iters < plain.iters
    assert max(float(tres.res_y), float(tres.res_z)) <= 0.01
    assert _rel(tres.v.numpy(), jres.v) <= 1e-2


@pytest.mark.parametrize("estimator", ["standard", "pathwise"])
def test_cold_start_outer_steps_match_reference_fit(estimator):
    """Three outer steps without warm starting (fresh probes, zero start,
    rank-10 preconditioner, 6 CG iterations each) from the reference's
    initial state, with the reference's per-step ``kprobe`` draws handed
    over: constrained hyperparameters per step within 1e-4 relative."""
    x, y = _data()
    jcfg, tcfg = _configs(estimator, warm_start=False)
    key = jax.random.PRNGKey(21)
    jst = j_init(key, jcfg, jnp.asarray(x))
    jres = j_fit(jnp.asarray(x), jnp.asarray(y), jcfg, key=key)
    state = outer_state_from_numpy(_np_state(jst))
    jkey, hypers = jst.key, []
    for _ in range(3):
        jkey, _, kprobe = jax.random.split(jkey, 3)
        probes = _port_probes(j_resample(kprobe, jst.probes, jnp.asarray(x)))
        state, metrics = outer_step(state, torch.tensor(x), torch.tensor(y),
                                    tcfg, probes=probes)
        assert metrics["iters"] == CG_ITERS
        hypers.append(metrics["hypers"])
    assert list(jres.history["iters"]) == [CG_ITERS] * 3
    for step in range(3):
        assert _rel(hypers[step], jres.history["hypers"][step]) <= 1e-4, step


@pytest.mark.parametrize("estimator", ["standard", "pathwise"])
def test_evaluate_matches_reference(estimator):
    """``evaluate`` after two warm-started steps from the reference's state:
    pathwise from the carry, standard with the reference's eval probes
    (``fold_in(key, 7)``) handed over and its eval solves run; RMSE and LLH
    within 1e-4 relative."""
    x, y = _data()
    xt, yt = _data(40, seed=3)
    jcfg, tcfg = _configs(estimator, warm_start=True, num_steps=2)
    key = jax.random.PRNGKey(5)
    jres = j_fit(jnp.asarray(x), jnp.asarray(y), jcfg, key=key)
    state = outer_state_from_numpy(_np_state(jres.state))
    jm = j_evaluate(jnp.asarray(x), jres.state, jcfg, jnp.asarray(xt),
                    jnp.asarray(yt))
    eval_probes = None
    if estimator == "standard":
        eval_probes = _port_probes(j_init_probes(
            jax.random.fold_in(jres.state.key, 7), "pathwise", N, D, S, PAIRS,
            kind="matern32"))
    tm = evaluate(torch.tensor(x), state, tcfg, torch.tensor(xt),
                  torch.tensor(yt), eval_probes=eval_probes)
    assert tm["mvms"] == (0 if estimator == "pathwise" else CG_ITERS + 1)
    for k in ("rmse", "llh"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4)


def test_checkpoint_resume_equals_uninterrupted(tmp_path):
    """Standard estimator, cold start (fresh draws every step), eval every
    2 steps: a fit stopped after step 2 and resumed from its checkpoint
    (generator state in the sidecar) ends bit-identical to an
    uninterrupted 4-step fit on the CPU, history included."""
    x, y = _data()
    xt, yt = _data(30, seed=4)
    cfg4 = _configs("standard", warm_start=False, num_steps=4)[1]
    cfg2 = _configs("standard", warm_start=False, num_steps=2)[1]
    kw = dict(x_test=torch.tensor(xt), y_test=torch.tensor(yt), eval_every=2)
    args = (torch.tensor(x), torch.tensor(y))
    full = fit(*args, cfg4, generator=torch.Generator().manual_seed(7), **kw)
    fit(*args, cfg2, generator=torch.Generator().manual_seed(7),
        ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    assert tckpt.latest_step(str(tmp_path)) == 2
    meta = tckpt.load_metadata(str(tmp_path))
    assert meta["step"] == 2 and len(meta["generator"]) > 0
    resumed = fit(*args, cfg4, generator=torch.Generator().manual_seed(7),
                  ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    assert resumed.state.step == full.state.step == 4
    for a, b in zip(tckpt.state_leaves(resumed.state),
                    tckpt.state_leaves(full.state)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    np.testing.assert_array_equal(resumed.history["hypers"],
                                  full.history["hypers"][2:])
    assert resumed.history["eval_rmse"][-1] == full.history["eval_rmse"][-1]
    assert sorted(p.name for p in tmp_path.glob("step_*.npz")) == [
        "step_2.npz", "step_4.npz"]


def test_checkpoint_retention_and_roundtrip(tmp_path):
    """save/latest/restore round trip of a pathwise state, the JSON sidecar,
    and retention of the last ``keep`` checkpoints."""
    x, _ = _data(20)
    cfg = _configs("pathwise", warm_start=True)[1]
    st = init_outer_state(cfg, torch.tensor(x),
                          generator=torch.Generator().manual_seed(1))
    for step in (1, 2, 3, 4):
        tckpt.save_checkpoint(str(tmp_path), step, st._replace(step=step),
                              metadata={"tag": step}, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_3.json", "step_3.npz", "step_4.json", "step_4.npz"]
    assert tckpt.load_metadata(str(tmp_path), 3) == {
        "step": 3, "num_leaves": 16, "tag": 3}
    back, step = tckpt.restore_checkpoint(str(tmp_path), st)
    assert step == 4 and back.step == 4 and back.probes.rff.kind == "matern32"
    for a, b in zip(tckpt.state_leaves(back)[:-1], tckpt.state_leaves(st)[:-1]):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "none"), st)


def test_reference_checkpoint_continues_to_reference_step_4(tmp_path):
    """A checkpoint the reference's ``fit`` wrote at step 2 (pathwise, warm
    start), read through ``interop.outer_state_from_checkpoint`` (leaves in
    ``jax.tree.leaves`` order), holds the reference's state exactly, and
    two more steps of the port reach the reference's step-4
    hyperparameters within 1e-4 relative."""
    x, y = _data()
    jcfg2, _ = _configs("pathwise", warm_start=True, num_steps=2)
    jcfg4, tcfg4 = _configs("pathwise", warm_start=True, num_steps=4)
    key = jax.random.PRNGKey(3)
    j2 = j_fit(jnp.asarray(x), jnp.asarray(y), jcfg2, key=key,
               ckpt_dir=str(tmp_path))
    j4 = j_fit(jnp.asarray(x), jnp.asarray(y), jcfg4, key=key)
    assert len(jax.tree.leaves(j2.state)) == 21
    state = outer_state_from_checkpoint(str(tmp_path / "step_2.npz"))
    ref = outer_state_from_numpy(_np_state(j2.state))
    for a, b in zip(tckpt.state_leaves(state), tckpt.state_leaves(ref)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    res = fit(torch.tensor(x), torch.tensor(y), tcfg4, state=state)
    assert res.state.step == 4 and len(res.history["hypers"]) == 2
    assert _rel(res.history["hypers"][-1], j4.history["hypers"][-1]) <= 1e-4


def _reference_summary_keys():
    """The keys of the JSON summary the reference's ``run_gp`` prints."""
    tree = ast.parse((REPO / "src/repro/launch/train.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "run_gp")
    out = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "out")
    return [k.value for k in out.value.keys]


def test_train_cli_on_cpu_prints_reference_keys(capsys, tmp_path):
    """The train CLI end to end on the CPU (standard estimator, cold start,
    rank-100 preconditioner, eval each step): the reference's JSON keys, in
    its order, also written to ``--out``."""
    out_file = tmp_path / "res" / "out.json"
    ttrain.main(["--device", "cpu", "--max-n", "200", "--steps", "2",
                 "--probes", "8", "--eval-every", "1", "--out", str(out_file)])
    text = capsys.readouterr().out
    out = json.loads(text[text.index("{\n"):])
    assert list(out) == _reference_summary_keys()
    assert out["solver"] == "cg" and out["warm_start"] is False
    assert len(out["eval_rmse"]) == 2 and np.isfinite(out["eval_llh"]).all()
    assert json.loads(out_file.read_text()) == out


def _reference_lm_line_parts():
    """The literal parts and the loss's format spec of the line the
    reference's ``run_lm`` prints."""
    tree = ast.parse((REPO / "src/repro/launch/train.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "run_lm")
    line = next(n for n in ast.walk(fn) if isinstance(n, ast.JoinedStr))
    literals = [v.value for v in line.values if isinstance(v, ast.Constant)]
    specs = [v.format_spec.values[0].value for v in line.values
             if isinstance(v, ast.FormattedValue) and v.format_spec]
    return literals, specs


def test_train_cli_lm_arch_prints_reference_lines(capsys):
    """``--arch llama3-8b --steps 2`` on the CPU trains the SMOKE config and
    prints two finite losses in the reference's ``[train-lm]`` format."""
    ttrain.main(["--device", "cpu", "--arch", "llama3-8b", "--steps", "2"])
    lines = capsys.readouterr().out.splitlines()
    literals, specs = _reference_lm_line_parts()
    assert literals == ["[train-lm] ", " step ", ": loss="] and specs == [".4f"]
    pattern = re.compile(r"\[train-lm\] llama3-8b step (\d+): loss=(\S+)$")
    found = [pattern.match(line) for line in lines]
    assert all(found) and [int(m.group(1)) for m in found] == [0, 1]
    losses = [float(m.group(2)) for m in found]
    assert np.all(np.isfinite(losses))
    assert all(m.group(2) == f"{v:.4f}" for m, v in zip(found, losses))


def test_train_cli_unknown_arch_raises_key_error():
    with pytest.raises(KeyError, match="unknown arch"):
        ttrain.main(["--device", "cpu", "--arch", "llama5"])
