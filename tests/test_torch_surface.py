"""The port's public surface against the reference's, name for name.

Every module of ``src/repro/`` (the namespace packages ``launch``, ``data``
and ``train`` included) is imported beside its counterpart under
``repro_torch``. For each module: every name of the reference's
``__all__`` is in the port's ``__all__`` and resolves; every public
function and class the reference module defines has a counterpart of the
same name, and so does every public method, property and field of such a
class; every parameter of such a function or method is in the
counterpart's signature, unless the counterpart takes ``**kwargs``. The
deliberate absences are the table below, each with its reason; an entry
that no longer matches a gap fails the test too.

Beside it: ``__version__``, the star and package imports user code makes,
and parity of what became callable here (the named kernel profiles,
``HyperParams.constrained``/``num_params``) with the reference on the same
inputs, float32 at 1e-6 relative.
"""
import importlib
import inspect
import os
import pkgutil
import subprocess
import sys
from dataclasses import fields, is_dataclass
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.gp import kernels_math as jkm  # noqa: E402
from repro.gp.hyperparams import HyperParams as JHyperParams  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.gp import kernels_math as tkm  # noqa: E402
from repro_torch.kernels.registry import available_kernels  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

# -- what the port leaves out on purpose -------------------------------------

# Parameter (and NamedTuple field) names the port takes nowhere.
DROPPED_PARAMS = {
    # JAX PRNG keys: the port takes torch.Generators or handed-over draws.
    "key": "PRNG key",
    "keys": "PRNG keys",
    # Pallas tile sizes: the CUDA kernels plan their own tiles.
    "bm": "Pallas tile rows",
    "bn": "Pallas tile columns",
    # Pallas interpret mode: a CPU tensor runs the kernel's plain version.
    "interpret": "Pallas interpret mode",
}

# (reference module, "name" | "Class.member" | "function(param=)") -> why.
ABSENT = {
    # The reference's last solve's telemetry; the port's OnlineGP takes the
    # residuals as last_residuals= (interop.py drops these leaves).
    ("repro.core.outer", "OuterState.last_res_y"): "solve telemetry",
    ("repro.core.outer", "OuterState.last_res_z"): "solve telemetry",
    ("repro.core.outer", "OuterState.last_iters"): "solve telemetry",
    ("repro.core.outer", "OuterState.last_epochs"): "solve telemetry",
    # An HLO regex and the readers of a compiled XLA program: the port
    # compiles no program, its dry-run counts placements and fake tensors.
    ("repro.launch.hlo_analysis", "parse_collectives"): "HLO regex",
    ("repro.launch.hlo_analysis", "extract_cost(compiled=)"): "XLA program",
    ("repro.launch.hlo_analysis", "extract_memory(compiled=)"):
        "XLA program",
    ("repro.launch.analysis", "lower_period_encoder(chips=)"):
        "XLA program",
    # Multi-host writer election: the port runs as one process.
    ("repro.distributed.checkpoint", "_is_writer"): "one process",
    # The freeze mask became the solvers' keep closure.
    ("repro.solvers.base", "history_record(active=)"): "keep closure",
    # The compat loop's config carries only the Pallas tile sizes.
    ("repro.launch.serve", "serve_gp_compat(cfg=)"): "Pallas tile sizes",
}

# The two Pallas entry points, mapped to the port's kernel entry points.
RENAMED = {
    ("repro.kernels.tiled", "kernel_mvm_pallas"): "kernel_mvm_unit",
    ("repro.kernels.tiled", "kernel_mvm_bwd_pallas"): "kernel_mvm_bwd_unit",
}


# -- the walk ------------------------------------------------------------------

def _reference_modules() -> list:
    """Every module of ``repro``: ``pkgutil.walk_packages`` over the package
    and over each directory without an ``__init__.py`` (a namespace
    package, which ``walk_packages`` does not enter)."""
    root = Path(repro.__path__[0])
    names = ["repro"] + [m.name for m in
                         pkgutil.walk_packages(repro.__path__, "repro.")]
    for d in sorted(root.rglob("*")):
        if d.is_dir() and d.name != "__pycache__" \
                and not (d / "__init__.py").exists():
            prefix = ".".join(("repro",) + d.relative_to(root).parts) + "."
            names += [m.name for m in pkgutil.walk_packages([str(d)], prefix)]
    return names


def _import_reference(name: str):
    """Import a reference module. ``repro.launch.dryrun`` sets ``XLA_FLAGS``
    to 512 forced host devices when imported; the flag is put back at once,
    so no JAX backend of this worker starts with it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _defined_here(obj, module: str) -> bool:
    if getattr(obj, "__module__", None) == module:
        return True
    wrapped = getattr(obj, "__wrapped__", None)  # jit / custom_vjp wrappers
    return getattr(wrapped, "__module__", None) == module


def _members(cls) -> dict:
    """Public methods, properties, class attributes and fields of ``cls``
    (a field maps to None)."""
    out = {k: v for k, v in vars(cls).items() if not k.startswith("_")}
    names = list(getattr(cls, "_fields", ()))
    if is_dataclass(cls):
        names += [f.name for f in fields(cls)]
    out.update({f: None for f in names if not f.startswith("_")})
    return out


def _params(fn):
    """The signature's parameters, or None where there is none to read."""
    if isinstance(fn, (staticmethod, classmethod)):
        fn = fn.__func__
    if isinstance(fn, property) or not callable(fn):
        return None
    try:
        return inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return None


def _param_gaps(ref_fn, port_fn) -> list:
    ref, port = _params(ref_fn), _params(port_fn)
    if ref is None or port is None:
        return []
    if any(p.kind is p.VAR_KEYWORD for p in port.values()):
        return []
    return [a for a in ref if a not in ("self", "cls") and a not in port]


def surface_gaps() -> list:
    """Every gap between the two packages as (reference module, what, the
    message). ``what`` is a name, ``Class.member`` or ``function(param=)``;
    a dropped parameter is also keyed by its bare name."""
    gaps = []
    for name in _reference_modules():
        ref = _import_reference(name)
        port_name = "repro_torch" + name[len("repro"):]
        try:
            port = importlib.import_module(port_name)
        except ImportError as exc:
            gaps.append((name, name, f"{port_name} does not import: {exc}"))
            continue
        ref_all = getattr(ref, "__all__", None) or []
        port_all = getattr(port, "__all__", None) or []
        for n in ref_all:
            if n not in port_all:
                gaps.append((name, n, f"{port_name}.__all__ lacks {n!r}"))
            elif not hasattr(port, n):
                gaps.append((name, n, f"{port_name}.{n} does not resolve"))
        listed = {what for (m, what) in [*ABSENT, *RENAMED] if m == name}
        for n, obj in vars(ref).items():
            public = not n.startswith("_") and _defined_here(obj, name) \
                and callable(obj)
            if not (public or n in listed):
                continue
            counterpart = getattr(port, RENAMED.get((name, n), n), None)
            if counterpart is None:
                gaps.append((name, n, f"{port_name} lacks {n!r}"))
                continue
            if not inspect.isclass(obj):
                for a in _param_gaps(obj, counterpart):
                    gaps.append((name, f"{n}({a}=)",
                                 f"{port_name}.{n} lacks parameter {a!r}"))
                continue
            port_members = _members(counterpart)
            for m, value in _members(obj).items():
                if not (hasattr(counterpart, m) or m in port_members):
                    gaps.append((name, f"{n}.{m}",
                                 f"{port_name}.{n} lacks member {m!r}"))
                elif value is not None:
                    for a in _param_gaps(value, getattr(counterpart, m)):
                        gaps.append((name, f"{n}.{m}({a}=)",
                                     f"{port_name}.{n}.{m} lacks parameter "
                                     f"{a!r}"))
    return gaps


def _excluded(module: str, what: str) -> bool:
    if (module, what) in ABSENT or (module, what) in RENAMED:
        return True
    if what.endswith("=)"):
        return what[what.rindex("(") + 1:-2] in DROPPED_PARAMS
    return what.split(".")[-1] in DROPPED_PARAMS  # a NamedTuple field


@pytest.fixture(scope="module")
def gaps():
    return surface_gaps()


def test_port_surface_matches_reference(gaps):
    """No gap outside the exclusion table; the message names each one."""
    open_gaps = [msg for module, what, msg in gaps
                 if not _excluded(module, what)]
    assert not open_gaps, "the port lacks:\n" + "\n".join(open_gaps)


def test_every_exclusion_still_matches_a_gap(gaps):
    """An exclusion whose name the reference dropped or the port gained is
    stale; a renamed entry point must exist under its port name."""
    keys = {(module, what) for module, what, _ in gaps}
    stale = [f"{m}: {w}" for m, w in ABSENT if (m, w) not in keys]
    dropped = {w[w.rindex("(") + 1:-2] if w.endswith("=)") else
               w.split(".")[-1] for _, w, _ in gaps}
    stale += [f"parameter {p!r}" for p in DROPPED_PARAMS if p not in dropped]
    for (module, name), port_name in RENAMED.items():
        port = importlib.import_module("repro_torch" + module[len("repro"):])
        if hasattr(port, name) or not hasattr(port, port_name) \
                or not hasattr(importlib.import_module(module), name):
            stale.append(f"{module}: {name} -> {port_name}")
    assert not stale, "stale exclusions:\n" + "\n".join(stale)


def test_version_matches_reference():
    assert repro_torch.__version__ == repro.__version__ == "1.0.0"


def test_package_imports_user_code_makes():
    """The package-level imports the reference's benchmarks and examples
    make, against the port; ``import *`` of the lazy ``core`` yields every
    reference name."""
    namespace = {}
    exec("from repro_torch.core import *", namespace)
    missing = set(importlib.import_module("repro.core").__all__) - set(namespace)
    assert not missing, sorted(missing)
    from repro_torch.distributed import (DP, FSDP, TP, constrain,  # noqa: F401
                                         save_checkpoint)
    from repro_torch.gp.kernels_math import PROFILES, matern32_from_r2
    from repro_torch.solvers import make_budget_policy, pivoted_cholesky  # noqa: F401

    assert PROFILES["matern32"] is matern32_from_r2
    assert (DP, FSDP, TP) == (("pod", "data"), "data", "model")


def test_version_and_analysis_import_without_torch():
    """``repro_torch.__version__`` and the stdlib-only ``analysis`` package
    import where torch cannot be imported."""
    code = ("import sys; sys.modules['torch'] = None\n"
            "import repro_torch, repro_torch.analysis\n"
            "assert 'torch' not in [m for m in sys.modules if sys.modules[m]]\n"
            "print(repro_torch.__version__)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ,
                                         "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "1.0.0"


# -- parity of what became callable --------------------------------------------

def _r2_and_signal(seed: int):
    rng = np.random.default_rng(seed)
    r2 = rng.uniform(0.0, 9.0, size=(37, 29)).astype(np.float32)
    r2[0, :5] = 0.0  # coincident points
    return r2, np.float32(rng.uniform(0.5, 2.0))


@pytest.mark.parametrize("seed,name", enumerate(["rbf", "matern12",
                                                 "matern32", "matern52"]))
def test_named_profiles_match_reference(seed, name):
    """``PROFILES[k]`` and ``<k>_from_r2`` against the reference's on the
    same r2 and signal (float32, 1e-6 relative)."""
    r2, signal = _r2_and_signal(seed)
    want = np.asarray(getattr(jkm, f"{name}_from_r2")(jnp.asarray(r2),
                                                      jnp.asarray(signal)))
    for profile in (tkm.PROFILES[name], getattr(tkm, f"{name}_from_r2")):
        got = profile(torch.from_numpy(r2), torch.tensor(signal)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_profile_tables_match_reference():
    """The same kernels behind ``PROFILES``, ``_PROFILES`` its alias."""
    assert tkm._PROFILES is tkm.PROFILES
    assert sorted(tkm.PROFILES) == sorted(jkm.PROFILES) \
        == sorted(available_kernels())
    r2, signal = _r2_and_signal(7)
    for name, profile in tkm.PROFILES.items():
        np.testing.assert_allclose(
            profile(torch.from_numpy(r2), torch.tensor(signal)).numpy(),
            np.asarray(jkm.PROFILES[name](jnp.asarray(r2),
                                          jnp.asarray(signal))),
            rtol=1e-6, atol=0)


def _np_params(p):
    return {"raw_lengthscales": np.asarray(p.raw_lengthscales),
            "raw_signal": np.asarray(p.raw_signal),
            "raw_noise": np.asarray(p.raw_noise), "kernel": p.kernel}


def _assert_constrained(port, ref):
    got, want = port.constrained(), ref.constrained()
    assert list(got) == list(want) == ["lengthscales", "signal", "noise"]
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=0)


def test_hyperparams_constrained_and_num_params():
    """Parameters carried across through ``interop``: one system's and
    B = 3 lane-stacked (``constrained`` keeps the lane axis, ``num_params``
    counts one lane, as the reference counts one system)."""
    rng = np.random.default_rng(3)
    leaves = [rng.normal(size=(3, 5)), rng.normal(size=3), rng.normal(size=3)]
    lanes = JHyperParams(*(jnp.asarray(a, jnp.float32) for a in leaves),
                         kernel="matern52")
    port = interop._params(_np_params(lanes), "cpu")
    assert port.lanes == 3 and port.kernel == "matern52"
    _assert_constrained(port, lanes)
    assert port.num_params == 7
    for lane in range(3):
        one = jax.tree.map(lambda a, i=lane: a[i], lanes)
        port_one = interop._params(_np_params(one), "cpu")
        _assert_constrained(port_one, one)
        assert port_one.num_params == one.num_params == 7
