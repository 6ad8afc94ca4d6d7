"""The port's serve slice as a whole against the JAX reference: the same
initial state (carried across by ``repro_torch.interop``) runs three outer
steps in both packages, is exported, and answers ragged requests through the
bucketed engine. Also: the CLI on the CPU, and that the port imports no JAX
and nothing of ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import OuterConfig as JOuterConfig  # noqa: E402
from repro.core import fit as j_fit  # noqa: E402
from repro.core import init_outer_state as j_init  # noqa: E402
from repro.core import pathwise_predict as j_predict  # noqa: E402
from repro.serve import BucketedEngine as JEngine  # noqa: E402
from repro.serve import export_servable as j_export  # noqa: E402
from repro.solvers import SolverConfig as JSolverConfig  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.core.driver import fit  # noqa: E402
from repro_torch.core.outer import OuterConfig  # noqa: E402
from repro_torch.core.predict import pathwise_predict  # noqa: E402
from repro_torch.interop import outer_state_from_numpy, servable_from_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serve.artifact import export_servable  # noqa: E402
from repro_torch.serve.engine import BucketedEngine, pad_to_bucket  # noqa: E402
from repro_torch.solvers import SolverConfig  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"

N, D, S, PAIRS, STEPS, CG_ITERS = 96, 3, 8, 32, 3, 6


def _np_params(p):
    return {"raw_lengthscales": np.asarray(p.raw_lengthscales),
            "raw_signal": np.asarray(p.raw_signal),
            "raw_noise": np.asarray(p.raw_noise), "kernel": p.kernel}


def _np_rff(r):
    return {"z": np.asarray(r.z), "u": np.asarray(r.u), "w": np.asarray(r.w),
            "kind": r.kind}


def _np_outer_state(st):
    pr = st.probes
    return {
        "params": _np_params(st.params),
        "adam": {"step": np.asarray(st.adam.step),
                 "mu": _np_params(st.adam.mu), "nu": _np_params(st.adam.nu)},
        "probes": {"estimator": pr.estimator,
                   "z": None if pr.z is None else np.asarray(pr.z),
                   "rff": None if pr.rff is None else _np_rff(pr.rff),
                   "w_eps": None if pr.w_eps is None else np.asarray(pr.w_eps)},
        "carry_v": np.asarray(st.carry_v),
        "step": np.asarray(st.step),
    }


def _np_servable(m):
    return {"x": np.asarray(m.x), "correction": np.asarray(m.correction),
            "rff": _np_rff(m.rff), "params": _np_params(m.params),
            "kind": m.kind}


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


@pytest.fixture(scope="module")
def slice_run():
    """Three outer steps in both packages from the reference's initial state."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-2.0, 2.0, size=(N, D)).astype(np.float32)
    y = (np.sin(1.5 * x[:, 0]) + 0.5 * np.cos(x[:, 1] * x[:, 2])
         + 0.1 * rng.normal(size=N)).astype(np.float32)
    xq = rng.uniform(-2.0, 2.0, size=(300, D)).astype(np.float32)
    solver = dict(name="cg", tolerance=0.0, max_epochs=CG_ITERS,
                  precond_rank=0)
    common = dict(estimator="pathwise", warm_start=True, num_probes=S,
                  num_rff_pairs=PAIRS, num_steps=STEPS, bm=64, bn=64)
    jcfg = JOuterConfig(solver=JSolverConfig(**solver), backend="streamed",
                        **common)
    tcfg = OuterConfig(solver=SolverConfig(**solver), backend="cuda", **common)
    key = jax.random.PRNGKey(11)
    init = _np_outer_state(j_init(key, jcfg, jnp.asarray(x)))
    jres = j_fit(jnp.asarray(x), jnp.asarray(y), jcfg, key=key)
    tres = fit(torch.tensor(x), torch.tensor(y), tcfg,
               state=outer_state_from_numpy(init))
    return {"x": x, "xq": xq, "jres": jres, "tres": tres}


def test_hyperparameter_trajectory_matches(slice_run):
    """Per-step constrained hyperparameters within 1e-4 relative; both runs
    do exactly CG_ITERS iterations per step (tolerance 0)."""
    jh, th = slice_run["jres"].history, slice_run["tres"].history
    assert th["hypers"].shape == jh["hypers"].shape == (STEPS, D + 2)
    assert list(th["iters"]) == list(jh["iters"]) == [CG_ITERS] * STEPS
    for step in range(STEPS):
        assert _rel(th["hypers"][step], jh["hypers"][step]) <= 1e-4, step
    np.testing.assert_allclose(th["res_y"], jh["res_y"], rtol=1e-3)
    np.testing.assert_allclose(th["res_z"], jh["res_z"], rtol=1e-3)


def test_carry_and_export_match(slice_run):
    """The warm-start carry and the exported correction within 1e-4 of the
    largest entry (fp32 CG after three steps of the same trajectory)."""
    jst, tst = slice_run["jres"].state, slice_run["tres"].state
    assert _rel(tst.carry_v.numpy(), jst.carry_v) <= 1e-4
    jm = j_export(jst, jnp.asarray(slice_run["x"]))
    tm = export_servable(tst, torch.tensor(slice_run["x"]))
    assert tm.kind == jm.kind and tm.num_samples == jm.num_samples == S
    assert _rel(tm.correction.numpy(), jm.correction) <= 1e-4
    xq = slice_run["xq"][:40]
    jp = j_predict(jnp.asarray(slice_run["x"]), jnp.asarray(xq), jst.carry_v,
                   jst.probes, jst.params)
    tp = pathwise_predict(torch.tensor(slice_run["x"]), torch.tensor(xq),
                          tst.carry_v, tst.probes, tst.params)
    for field in ("mean", "var", "samples"):
        assert _rel(getattr(tp, field).numpy(), getattr(jp, field)) <= 1e-4


def test_engine_matches_reference_on_ragged_requests(slice_run):
    """The reference's exported model, carried across, answers requests of
    5, 64 and 300 rows (padding, and chunking past the 256 bucket) like the
    reference engine: mean/var/samples within 1e-5 of the largest entry."""
    jm = j_export(slice_run["jres"].state, jnp.asarray(slice_run["x"]))
    tm = servable_from_numpy(_np_servable(jm))
    jeng = JEngine(jm, buckets=(16, 64, 256), bm=64, bn=64)
    teng = BucketedEngine(tm, buckets=(16, 64, 256))
    for m in (5, 64, 300):
        xq = slice_run["xq"][:m]
        jp = jeng.submit(jnp.asarray(xq))
        tp = teng.submit(torch.tensor(xq))
        for field in ("mean", "var", "samples"):
            got, ref = getattr(tp, field).numpy(), np.asarray(getattr(jp, field))
            assert got.shape == ref.shape
            assert _rel(got, ref) <= 1e-5, (m, field)
    assert teng.stats.batches == jeng.stats.batches == 4
    assert teng.stats.per_bucket == jeng.stats.per_bucket
    assert teng.stats_dict()["num_compiles"] is None


def test_pad_to_bucket_and_bucket_for():
    eng = BucketedEngine(None, buckets=(64, 16, 256))
    assert eng.buckets == (16, 64, 256)
    assert [eng.bucket_for(m) for m in (1, 16, 17, 300)] == [16, 16, 64, 256]
    xq = torch.ones(5, 2)
    padded = pad_to_bucket(xq, 16)
    assert padded.shape == (16, 2) and torch.all(padded[5:] == 0)
    with pytest.raises(ValueError):
        pad_to_bucket(torch.ones(20, 2), 16)


def test_serve_cli_on_cpu(capsys):
    """The CLI's fit -> export -> serve path end to end on the CPU, small."""
    args = tserve.build_parser().parse_args(
        ["--device", "cpu", "--max-n", "200", "--train-steps", "2",
         "--requests", "3", "--num-probes", "4", "--buckets", "16,64"])
    run = tserve.serve_gp(args)
    rep = run.report
    assert rep["n_train"] == 180 and len(rep["steps"]) == 2
    assert rep["cg_mvms"] == sum(st["mvms"] for st in rep["steps"])
    # warmup runs each bucket once; 3 requests + 1 metrics request
    assert rep["engine_dispatches"] == 2 + 4
    assert np.isfinite(rep["rmse"]) and np.isfinite(rep["llh"])
    assert "ZERO solves" in capsys.readouterr().out


def test_cuda_device_is_never_replaced_by_cpu():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_repro():
    """Static: no ``jax``/``repro.*``/``benchmarks.*`` import in the port,
    chip_smoke.py or the example twins (``examples/torch_*.py``). Dynamic:
    every port module and every twin imports with ``jax``, ``repro`` and
    ``benchmarks`` blocked."""
    examples = sorted((REPO / "examples").glob("torch_*.py"))
    assert examples, "no example twins found"
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + examples
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "benchmarks"), \
                f"{f}: imports {mod}"
    modules = [".".join(p.relative_to(PORT.parent).with_suffix("").parts)
               for p in sorted(PORT.rglob("*.py"))]
    modules = [m[:-len(".__init__")] if m.endswith(".__init__") else m
               for m in modules]
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro', 'benchmarks'):\n"
            "    sys.modules[name] = None\n"
            f"import importlib, importlib.util\nfor m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            f"for i, path in enumerate({[str(e) for e in examples]!r}):\n"
            "    spec = importlib.util.spec_from_file_location(f'twin{i}', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.',\n"
            "                                           'benchmarks.'))\n"
            "               for k, v in sys.modules.items() if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_quickstart_twin_matches_reference_fit():
    """``examples/torch_quickstart.py`` at a small size (300 rows of pol,
    3 steps, eval at step 3) against a JAX ``fit`` with the reference
    example's config on the same data, from the reference's initial state
    (handed over): iterations equal per step, hyperparameters within rtol
    1e-4 / atol 1e-6, the eval RMSE and LLH within rtol 1e-3."""
    import importlib.util

    from repro.data.synthetic import load_dataset as j_load
    from repro.train.adam import AdamConfig as JAdamConfig
    from repro_torch.data.synthetic import Dataset

    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", REPO / "examples" / "torch_quickstart.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    args = twin.build_parser().parse_args(
        ["--device", "cpu", "--max-n", "300", "--steps", "3",
         "--eval-every", "3"])
    ds = j_load("pol", max_n=300)
    jcfg = JOuterConfig(
        estimator="pathwise", warm_start=True, num_probes=32,
        solver=JSolverConfig(name="cg", tolerance=0.01, max_epochs=200,
                             precond_rank=50),
        adam=JAdamConfig(learning_rate=0.1), num_steps=3, bm=512, bn=512)
    key = jax.random.PRNGKey(0)
    jres = j_fit(ds.x_train, ds.y_train, jcfg, key=key, x_test=ds.x_test,
                 y_test=ds.y_test, eval_every=3)
    tds = Dataset(*(torch.tensor(np.asarray(a)) for a in
                    (ds.x_train, ds.y_train, ds.x_test, ds.y_test)), name="pol")
    state = outer_state_from_numpy(_np_outer_state(
        j_init(key, jcfg, ds.x_train)))
    out = twin.run(tds, args, state=state)
    th, jh = out["fit"].history, jres.history
    np.testing.assert_array_equal(th["iters"], jh["iters"])
    np.testing.assert_allclose(th["hypers"], jh["hypers"], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose([out["rmse"], out["llh"]],
                               [jh["eval_rmse"][-1], jh["eval_llh"][-1]],
                               rtol=1e-3)
