"""Atomic, resumable checkpoints of any tree of tensors; the port's own
copy of ``repro.distributed.checkpoint`` (single process), re-exported by
:mod:`repro_torch.distributed.checkpoint`.

Layout, as the reference's: ``<dir>/step_<k>.npz`` holds the tree's
leaves positionally as ``leaf_0 .. leaf_{L-1}``, and ``<dir>/step_<k>.json``
is a sidecar with ``step``, ``num_leaves`` and any caller metadata. Each
file is written to ``<dir>/tmp.*``, flushed and ``fsync``ed, then renamed,
so a crash mid-write never corrupts the latest restorable state. The last
``keep`` checkpoints are kept.

Leaves are taken in ``jax.tree.leaves`` order (:func:`tree_leaves`): dict
values by sorted key, list, tuple and NamedTuple items in order; ``None``
and strings (the static kernel, kind and estimator names of
`HyperParams`, `RFFState`, `ProbeState` and `ServableGP`) hold no leaf.
So a tree saved by either package restores in the other onto a template
of the same structure. Leaf order of an
:class:`~repro_torch.core.outer.OuterState`:

    params.raw_lengthscales, params.raw_signal, params.raw_noise,
    adam.step, adam.mu (3 leaves as params), adam.nu (3 leaves as params),
    probes: standard ``z`` | pathwise ``rff.z, rff.u, rff.w, w_eps``,
    carry_v, step

(the reference's order without its PRNG ``key`` and ``last_*`` leaves; the
two step counters stored as int32, the reference's dtype). Restoring takes
a template tree for the structure, the static parts and the device and
dtype of every leaf. :func:`load_leaves` reads the flat list of leaves
without a template (the serving artifact's loader, and
``repro_torch.interop``'s reader of the reference's checkpoints).
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.estimators import ProbeState
from repro_torch.core.outer import OuterState
from repro_torch.gp.rff import RFFState
from repro_torch.train.adam import AdamState

_STEP_RE = re.compile(r"step_(\d+)\.npz$")


def state_leaves(state: OuterState) -> list:
    """The state's leaves in the module's documented order (ints for the
    two step counters, tensors otherwise)."""
    pr = state.probes
    probes = [pr.z] if pr.rff is None else [pr.rff.z, pr.rff.u, pr.rff.w,
                                            pr.w_eps]
    return [*state.params.leaves, state.adam.step, *state.adam.mu.leaves,
            *state.adam.nu.leaves, *probes, state.carry_v, state.step]


def state_from_leaves(template: OuterState, leaves: list) -> OuterState:
    """Rebuild an `OuterState` from leaves in the documented order, with the
    template's static parts and the template leaves' devices and dtypes."""
    want = len(state_leaves(template))
    if len(leaves) != want:
        raise ValueError(f"template has {want} leaves, checkpoint has "
                         f"{len(leaves)}")
    tmpl = state_leaves(template)
    t = [torch.as_tensor(np.asarray(a), dtype=ref.dtype, device=ref.device)
         if isinstance(ref, torch.Tensor) else int(a)
         for a, ref in zip(leaves, tmpl)]
    params = template.params.with_leaves(t[0:3])
    pr = template.probes
    if pr.rff is None:
        probes, rest = ProbeState(pr.estimator, t[10], None, None), t[11:]
    else:
        rff = RFFState(z=t[10], u=t[11], w=t[12], kind=pr.rff.kind)
        probes, rest = ProbeState(pr.estimator, None, rff, t[13]), t[14:]
    return OuterState(
        params=params,
        adam=AdamState(step=t[3], mu=params.with_leaves(t[4:7]),
                       nu=params.with_leaves(t[7:10])),
        probes=probes, carry_v=rest[0], step=rest[1])


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in the module docstring's order (the order of
    ``jax.tree.leaves`` on the reference's counterpart)."""
    if isinstance(tree, OuterState):
        return [np.int32(leaf) if isinstance(leaf, int) else leaf
                for leaf in state_leaves(tree)]
    if tree is None or isinstance(tree, str):
        return []
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_from_leaves(template, leaves: list):
    """A tree shaped like ``template`` holding ``leaves`` (in
    :func:`tree_leaves` order), each on its template leaf's device and in
    its dtype; ``None`` and strings are the template's."""
    want = len(tree_leaves(template))
    if len(leaves) != want:
        raise ValueError(f"template has {want} leaves, checkpoint has "
                         f"{len(leaves)}")
    it = iter(leaves)

    def build(node):
        if isinstance(node, OuterState):
            return state_from_leaves(
                node, [next(it) for _ in range(len(state_leaves(node)))])
        if node is None or isinstance(node, str):
            return node
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(item) for item in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(item) for item in node)
        return _leaf_like(next(it), node)

    return build(template)


def _leaf_like(array: np.ndarray, ref):
    if isinstance(ref, torch.Tensor):
        return torch.as_tensor(array, dtype=ref.dtype, device=ref.device)
    if isinstance(ref, (int, float)):
        return type(ref)(array)
    return array


def _write_atomic(path: str, tmp: str, write) -> None:
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    metadata: Optional[dict] = None, keep: int = 3) -> str:
    """Atomically persist ``tree`` at ``step`` in the layout of the module
    docstring (tensor leaves as they are, other leaves as ``np.asarray``
    gives them), keeping the last ``keep`` checkpoints. Returns the final
    path."""
    leaves = tree_leaves(tree)
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {f"leaf_{i}": (leaf.detach().cpu().numpy()
                            if isinstance(leaf, torch.Tensor)
                            else np.asarray(leaf))
              for i, leaf in enumerate(leaves)}
    final = os.path.join(ckpt_dir, f"step_{step}.npz")
    _write_atomic(final, os.path.join(ckpt_dir, f"tmp.{step}.npz"),
                  lambda f: np.savez(f, **arrays))
    meta = {"step": int(step), "num_leaves": len(leaves), **(metadata or {})}
    _write_atomic(os.path.join(ckpt_dir, f"step_{step}.json"),
                  os.path.join(ckpt_dir, f"tmp.meta.{step}.json"),
                  lambda f: f.write(json.dumps(meta).encode()))
    _gc(ckpt_dir, keep)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest checkpointed step under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(ckpt_dir)
             if (m := _STEP_RE.search(name))]
    return max(steps) if steps else None


def _resolve_step(ckpt_dir: str, step: Optional[int]) -> int:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return step


def load_metadata(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """Read the JSON sidecar written next to a checkpoint (default: latest)."""
    step = _resolve_step(ckpt_dir, step)
    with open(os.path.join(ckpt_dir, f"step_{step}.json")) as f:
        return json.load(f)


def load_leaves(npz_path: str) -> list:
    """The positional leaves ``leaf_0 ..`` of one ``.npz`` checkpoint."""
    with np.load(npz_path) as data:
        return [data[f"leaf_{i}"] for i in range(len(data.files))]


def restore_checkpoint(ckpt_dir: str, template: Any,
                       step: Optional[int] = None) -> tuple[Any, int]:
    """Restore the tree saved at ``step`` (default: latest) onto the
    template's structure, devices and dtypes. Raises FileNotFoundError if
    there is none."""
    step = _resolve_step(ckpt_dir, step)
    leaves = load_leaves(os.path.join(ckpt_dir, f"step_{step}.npz"))
    return tree_from_leaves(template, leaves), step


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(int(m.group(1)) for name in os.listdir(ckpt_dir)
                   if (m := _STEP_RE.search(name)))
    for s in steps[:-keep] if keep > 0 else []:
        for suffix in (".npz", ".json"):
            p = os.path.join(ckpt_dir, f"step_{s}{suffix}")
            if os.path.exists(p):
                os.remove(p)
