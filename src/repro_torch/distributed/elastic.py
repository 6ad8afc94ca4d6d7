"""Elastic re-sharding: move a checkpointed state between meshes; port of
``repro.distributed.elastic``.

Every state in the port is a tree of dense tensors with mesh-agnostic
rules (spec builders take the target mesh), so re-sharding is a placement
per leaf: a leaf whose spec shards its rows becomes a
:class:`~repro_torch.distributed.sharding.RowSharded` on the new mesh, a
spec of ``()`` (or one whose axes do not divide the rows) replicates it
(one tensor on the mesh's first device). Restart on a smaller fleet:

    state = restore_checkpoint(dir, template)     # one device
    state = reshard(state, new_mesh, row_sharded_builder())
    ...
    state = unshard(state, "cpu")                  # back to one device
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from repro_torch.distributed.sharding import (
    ROW_AXES,
    RowSharded,
    shard_rows,
    valid_spec,
)
from repro_torch.lanes import map_with_path
from repro_torch.launch.mesh import Mesh


def reshard(tree: Any, mesh: Mesh,
            spec_builder: Optional[Callable[[tuple, Any], tuple]] = None
            ) -> Any:
    """Place every tensor leaf on ``mesh`` with the spec
    ``spec_builder(path, leaf)`` (a per-dimension axis tuple as
    :func:`valid_spec` takes; default: replicate everything). Only the
    row dimension may be sharded."""
    def place(path, leaf):
        if isinstance(leaf, RowSharded):
            leaf = leaf.gather(mesh.devices[0])
        spec = spec_builder(path, leaf) if spec_builder else ()
        axes = valid_spec(mesh, tuple(leaf.shape), spec)
        if any(a is not None for a in axes[1:]):
            raise NotImplementedError(f"{path}: only the row dimension is "
                                      f"sharded, got {axes}")
        if axes and axes[0] is not None:
            return shard_rows(leaf, mesh, axes[0])
        return leaf.to(mesh.devices[0])

    return map_with_path(place, tree)


def row_sharded_builder(axes=ROW_AXES):
    """All leaves with ndim >= 1 row-sharded over ``axes`` (GP state)."""
    def builder(path, leaf):
        nd = getattr(leaf, "ndim", 0)
        if nd == 0:
            return ()
        return (axes,) + (None,) * (nd - 1)

    return builder


def unshard(tree: Any, device) -> Any:
    """Every leaf as one tensor on ``device``: row-sharded leaves gathered
    (the port's counterpart of reading a global array)."""
    def one(path, leaf):
        if isinstance(leaf, RowSharded):
            return leaf.gather(device)
        return leaf.to(device)

    return map_with_path(one, tree)
