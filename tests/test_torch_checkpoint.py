"""Checkpoints of any tree of tensors, across the two packages.

``repro_torch.distributed.save_checkpoint`` / ``restore_checkpoint`` write
and read the reference's format (``step_<k>.npz`` with ``leaf_0 ..`` in
``jax.tree.leaves`` order, a JSON sidecar): a tree saved by either package
restores bitwise in the other onto a template of the same structure, and
both write the same arrays for the same tree. An ``OuterState`` keeps the
layout it always had (``repro_torch.checkpoint.state_leaves``, the two step
counters as int32), compared array by array: the ``.npz`` zip headers
carry timestamps, so file bytes differ between any two writes.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.estimators import ProbeState as JProbeState  # noqa: E402
from repro.distributed import load_metadata as j_load_metadata  # noqa: E402
from repro.distributed import restore_checkpoint as j_restore  # noqa: E402
from repro.distributed import save_checkpoint as j_save  # noqa: E402
from repro.gp.hyperparams import HyperParams as JHyperParams  # noqa: E402
from repro.gp.rff import RFFState as JRFFState  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.core.estimators import ProbeState  # noqa: E402
from repro_torch.core.outer import (OuterConfig, init_outer_state,  # noqa: E402
                                    init_outer_state_lanes)
from repro_torch.distributed import (load_metadata, restore_checkpoint,  # noqa: E402
                                     save_checkpoint)
from repro_torch.gp.hyperparams import HyperParams  # noqa: E402
from repro_torch.gp.rff import RFFState  # noqa: E402


def _arrays(seed: int) -> dict:
    """numpy leaves of several dtypes and shapes, a 0-d one among them."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float16),
            "i": rng.integers(-9, 9, size=(2, 3)).astype(np.int32),
            "s": np.float32(rng.normal()),
            "l": rng.normal(size=(4,)).astype(np.float32),
            "t": rng.normal(size=(2, 2)).astype(np.float32)}


def _port_tree(a: dict) -> dict:
    """A nested tree: dict (keys out of order), list, tuple, an int."""
    t = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    return {"z": {"w": t["w"], "b": t["b"]}, "a": [t["i"], (t["s"], t["l"])],
            "m": t["t"], "count": 7}


def _ref_tree(a: dict) -> dict:
    t = {k: jnp.asarray(v) for k, v in a.items()}
    return {"z": {"w": t["w"], "b": t["b"]}, "a": [t["i"], (t["s"], t["l"])],
            "m": t["t"], "count": 7}


def _hypers(seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    leaves = (rng.normal(size=6).astype(np.float32), np.float32(rng.normal()),
              np.float32(rng.normal()))
    return (HyperParams(*map(torch.tensor, leaves), kernel="matern12"),
            JHyperParams(*map(jnp.asarray, leaves), kernel="matern12"))


def _npz(path) -> dict:
    with np.load(path) as data:
        return {name: data[name] for name in data.files}


def _assert_same_arrays(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _bitwise(port_leaf, ref_leaf):
    got = port_leaf.numpy() if isinstance(port_leaf, torch.Tensor) \
        else np.asarray(port_leaf)
    want = np.asarray(ref_leaf)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_both_packages_write_the_same_arrays(tmp_path):
    """The same tree saved by each package: the same ``leaf_i`` names,
    order, dtypes, shapes and values (a Python int as ``np.asarray`` gives
    it), the same sidecar."""
    a = _arrays(0)
    tp, jp = _hypers(1)
    save_checkpoint(str(tmp_path / "port"), 2, [_port_tree(a), tp],
                    metadata={"tag": "x"})
    j_save(str(tmp_path / "ref"), 2, [_ref_tree(a), jp], metadata={"tag": "x"})
    _assert_same_arrays(_npz(tmp_path / "port" / "step_2.npz"),
                        _npz(tmp_path / "ref" / "step_2.npz"))
    sidecars = [json.loads((tmp_path / d / "step_2.json").read_text())
                for d in ("port", "ref")]
    assert sidecars[0] == sidecars[1] == {"step": 2, "num_leaves": 10,
                                          "tag": "x"}


def test_port_checkpoint_restores_in_reference(tmp_path):
    """A dict tree and a `HyperParams` saved by the port restore bitwise
    through ``repro.distributed.restore_checkpoint`` onto jnp templates of
    the same structure; the kernel name is the template's."""
    a = _arrays(2)
    tp, jp = _hypers(3)
    save_checkpoint(str(tmp_path), 5, {"tree": _port_tree(a), "params": tp})
    template = {"tree": _ref_tree(_arrays(9)),
                "params": JHyperParams(*(jnp.zeros_like(x) for x in jp[:3]),
                                       kernel="matern12")}
    back, step = j_restore(str(tmp_path), template)
    assert step == 5 and back["params"].kernel == "matern12"
    port_leaves = tckpt.tree_leaves({"tree": _port_tree(a), "params": tp})
    ref_leaves = jax.tree.leaves(back)
    assert len(port_leaves) == len(ref_leaves) == 10
    for p, r in zip(port_leaves, ref_leaves):
        _bitwise(p, r)


def test_reference_checkpoint_restores_in_port(tmp_path):
    """The reverse: the reference's save restores bitwise through the
    port's onto torch templates, in the template's dtypes, with its int
    and its static kernel name."""
    a = _arrays(4)
    tp, jp = _hypers(5)
    j_save(str(tmp_path), 3, {"tree": _ref_tree(a), "params": jp})
    template = {"tree": _port_tree(_arrays(8)),
                "params": tp.with_leaves([torch.zeros_like(x)
                                          for x in tp.leaves])}
    back, step = restore_checkpoint(str(tmp_path), template)
    assert step == 3 and back["tree"]["count"] == 7
    assert isinstance(back["tree"]["count"], int)
    assert isinstance(back["tree"]["a"][1], tuple)
    assert isinstance(back["params"], HyperParams)
    assert back["params"].kernel == "matern12"
    port_leaves = tckpt.tree_leaves(back)
    ref_leaves = jax.tree.leaves({"tree": _ref_tree(a), "params": jp})
    assert len(port_leaves) == len(ref_leaves) == 10
    for p, r in zip(port_leaves, ref_leaves):
        _bitwise(p, r)


def test_load_metadata_reads_either_sidecar(tmp_path):
    tp, jp = _hypers(6)
    save_checkpoint(str(tmp_path / "port"), 4, tp, metadata={"who": "port"})
    j_save(str(tmp_path / "ref"), 4, jp, metadata={"who": "ref"})
    for d, who in (("port", "port"), ("ref", "ref")):
        want = {"step": 4, "num_leaves": 3, "who": who}
        assert load_metadata(str(tmp_path / d)) == want
        assert j_load_metadata(str(tmp_path / d)) == want


def test_named_tuples_with_static_names_cross_packages(tmp_path):
    """`ProbeState` and `RFFState` carry their estimator and kernel names
    as static data in the reference; the port's hold no leaf for them
    either, so a pathwise probe state crosses both ways."""
    rng = np.random.default_rng(7)
    z, u, w, eps = (rng.normal(size=s).astype(np.float32)
                    for s in ((4, 3), (4,), (8, 2), (10, 2)))
    port = ProbeState("pathwise", None, RFFState(*map(torch.from_numpy,
                                                      (z, u, w)),
                                                 kind="rbf"),
                      torch.from_numpy(eps))
    ref = JProbeState("pathwise", None, JRFFState(*map(jnp.asarray, (z, u, w)),
                                                  kind="rbf"),
                      jnp.asarray(eps))
    save_checkpoint(str(tmp_path / "port"), 0, port)
    back, _ = j_restore(str(tmp_path / "port"), jax.tree.map(jnp.zeros_like,
                                                            ref))
    assert back.estimator == "pathwise" and back.rff.kind == "rbf"
    for p, r in zip(tckpt.tree_leaves(port), jax.tree.leaves(back)):
        _bitwise(p, r)
    j_save(str(tmp_path / "ref"), 0, ref)
    back, _ = restore_checkpoint(str(tmp_path / "ref"), port)
    assert back.estimator == "pathwise" and back.z is None
    assert back.rff.kind == "rbf"
    for p, r in zip(tckpt.tree_leaves(back), jax.tree.leaves(ref)):
        _bitwise(p, r)


def test_restore_takes_the_templates_dtypes_and_checks_the_count(tmp_path):
    """Leaves come back in the template's dtype (float32 saved, float64
    template); ``None`` and strings hold no leaf; a template with another
    leaf count raises."""
    tree = {"x": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "none": None, "name": "kept", "n": 3}
    assert len(tckpt.tree_leaves(tree)) == 2
    save_checkpoint(str(tmp_path), 1, tree)
    template = {"x": torch.zeros(2, 3, dtype=torch.float64), "none": None,
                "name": "template's", "n": 0}
    back, _ = restore_checkpoint(str(tmp_path), template)
    assert back["x"].dtype == torch.float64
    assert torch.equal(back["x"], tree["x"].double())
    assert back["none"] is None and back["name"] == "template's"
    assert back["n"] == 3
    with pytest.raises(ValueError, match="template has 3 leaves"):
        restore_checkpoint(str(tmp_path), {**template, "y": torch.zeros(1)})


def _legacy_arrays(state) -> dict:
    """The arrays an `OuterState` checkpoint held before any tree could be
    saved: ``state_leaves`` in order, tensors as they are, the two step
    counters as int32."""
    return {f"leaf_{i}": (leaf.numpy() if isinstance(leaf, torch.Tensor)
                          else np.asarray(leaf, dtype=np.int32))
            for i, leaf in enumerate(tckpt.state_leaves(state))}


@pytest.mark.parametrize("estimator", ["standard", "pathwise"])
@pytest.mark.parametrize("lanes", [None, 2])
def test_outer_state_checkpoint_layout_unchanged(tmp_path, estimator, lanes):
    """An `OuterState` saved through ``save_checkpoint`` holds the same
    ``leaf_i`` arrays as before (names, order, dtypes, shapes, values), and
    restores to the same state."""
    x = torch.from_numpy(np.random.default_rng(11).normal(size=(12, 3))
                         .astype(np.float32))
    cfg = OuterConfig(estimator=estimator, num_probes=4, num_rff_pairs=8)
    if lanes is None:
        state = init_outer_state(cfg, x,
                                 generator=torch.Generator().manual_seed(2))
    else:
        state = init_outer_state_lanes(
            cfg, x, [torch.Generator().manual_seed(s) for s in range(lanes)])
    state = state._replace(step=7, adam=state.adam._replace(step=5))
    save_checkpoint(str(tmp_path), 7, state)
    _assert_same_arrays(_npz(tmp_path / "step_7.npz"), _legacy_arrays(state))
    assert load_metadata(str(tmp_path))["num_leaves"] == \
        len(tckpt.state_leaves(state))
    back, step = restore_checkpoint(str(tmp_path), state)
    assert step == 7 and back.step == 7 and back.adam.step == 5
    assert back.probes.estimator == estimator
    for a, b in zip(tckpt.state_leaves(back), tckpt.state_leaves(state)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
