"""Mesh axis helpers and row-sharded tensors; port of the mesh helpers of
``repro.distributed.sharding``.

Axes convention (as the reference's): ``("data", "model")`` on one pod,
``("pod", "data", "model")`` across pods; a GP's rows are sharded over
every present axis of :data:`ROW_AXES`.

:func:`axis_size`, :func:`valid_spec` and the process-global mesh are the
reference's, over the port's :class:`~repro_torch.launch.mesh.Mesh`;
:func:`valid_spec` returns a tuple of per-dimension axis entries where the
reference returns a ``PartitionSpec``.

:class:`RowSharded` is the port's counterpart of an array with
``NamedSharding(mesh, P(axes, None))``: the pieces of a global (n, ...)
tensor, one per mesh position in mesh order, each on its position's
device. Position p holds shard k(p), k counting row-major over p's
coordinates along ``axes``; positions that differ only along other axes
hold copies of one shard. A value that the reference keeps replicated (the
hyperparameters, a reduction over rows) is one tensor on the mesh's first
device here, moved to a piece's device where the two meet.

The LM's sharding policy is the reference's: batch and tokens over
:data:`DP` ("pod", "data"), a weight's tensor-parallel dimension over
:data:`TP` ("model"), its other dimension over :data:`FSDP` ("data",
storage only, gathered at use). The port runs an LM on one card and only
accounts for a placement across positions (:mod:`repro_torch.launch.
dryrun`): :func:`named_sharding` returns that placement, a
:class:`NamedSharding` of the mesh and the per-dimension axis tuple, and
:func:`constrain` checks a spec without moving anything. The port's
models call neither: where the reference constrains an activation the
only effect is placement, which the accounting reads from the policy.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Union

import torch

from repro_torch.launch.mesh import Mesh

AxisSpec = Union[None, str, tuple]

ROW_AXES = ("pod", "data", "model")  # rows sharded over every mesh axis

_GLOBAL_MESH: Optional[Mesh] = None


def set_global_mesh(mesh: Optional[Mesh]) -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_global_mesh() -> Optional[Mesh]:
    return _GLOBAL_MESH


def axis_size(mesh: Mesh, axis: AxisSpec) -> int:
    """Positions along ``axis`` (a name, a tuple of names, or None: 1)."""
    if axis is None:
        return 1
    if isinstance(axis, str):
        return mesh.shape[axis]
    return math.prod(mesh.shape[a] for a in axis)


def _present(mesh: Mesh, axis: AxisSpec) -> AxisSpec:
    """Drop mesh axes that the mesh does not have (e.g. 'pod' on the
    single-pod mesh); preserves tuple vs str structure."""
    if axis is None:
        return None
    if isinstance(axis, str):
        return axis if axis in mesh.shape else None
    kept = tuple(a for a in axis if a in mesh.shape)
    return kept if kept else None


def valid_spec(mesh: Mesh, shape: Sequence[int],
               spec: Sequence[AxisSpec]) -> tuple:
    """Per-dimension axis entries with non-dividing / missing axes dropped
    (the reference's ``PartitionSpec``, as a tuple)."""
    out = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        axis = _present(mesh, axis)
        if axis is not None and dim % axis_size(mesh, axis) != 0:
            axis = None
        out.append(axis)
    return tuple(out)


class NamedSharding(NamedTuple):
    """A placement: ``spec[i]`` names the mesh axes dimension ``i`` is split
    over (None: not split), as ``valid_spec`` returns it."""

    mesh: Mesh
    spec: tuple

    @property
    def num_shards(self) -> int:
        """Positions holding distinct pieces (the product of the spec's
        axis sizes); the other positions hold copies."""
        return math.prod(axis_size(self.mesh, a) for a in self.spec)

    def shard_bytes(self, t) -> int:
        """Bytes of ``t``'s piece at one position."""
        return t.numel() * t.element_size() // self.num_shards


def named_sharding(mesh: Mesh, shape: Sequence[int],
                   spec: Sequence[AxisSpec]) -> NamedSharding:
    """The placement of a ``shape`` tensor under ``spec`` on ``mesh``
    (axes that do not divide dropped)."""
    return NamedSharding(mesh, valid_spec(mesh, shape, spec))


def constrain(x: torch.Tensor, *spec: AxisSpec) -> torch.Tensor:
    """``x`` unchanged. With a global mesh of more than one position the
    spec is checked (``valid_spec``); the port runs a model on one card,
    so there is nothing to move (the reference's sharding constraint)."""
    mesh = _GLOBAL_MESH
    if mesh is None or mesh.size == 1:
        return x
    valid_spec(mesh, x.shape, spec)
    return x


# Logical axis names of the model policy, resolved to mesh axes here.
DP = ("pod", "data")  # batch / tokens
FSDP = "data"  # weight storage sharding (gathered at use)
TP = "model"  # tensor-parallel weight dim


def batch_spec(ndim: int) -> tuple:
    """Batch-leading activation spec: (DP, None, ...)."""
    return (DP,) + (None,) * (ndim - 1)


def row_axes(mesh: Mesh) -> tuple:
    """The axes of :data:`ROW_AXES` that ``mesh`` has, outermost first."""
    return tuple(a for a in ROW_AXES if a in mesh.shape)


def _axes_tuple(axes: AxisSpec) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _shard_index(mesh: Mesh, axes: tuple, position: int) -> int:
    """The row shard ``position`` holds: row-major over its coordinates
    along ``axes``."""
    coords = mesh.coords(position)
    k = 0
    for a in axes:
        k = k * mesh.shape[a] + coords[a]
    return k


class RowSharded:
    """A global (n, ...) tensor as one row block per mesh position.

    ``+``, ``-``, ``*`` and ``/`` with another :class:`RowSharded` of the
    same layout, a tensor that broadcasts against one piece (a replicated
    value, moved to each piece's device) or a Python number on the right
    act piece by piece; :meth:`col_sum` is the global reduction over rows.
    Every operation is a plain torch operation, so autograd runs through
    them.
    """

    tree_leaf = True  # a leaf of repro_torch.lanes.tree_map

    def __init__(self, pieces: Sequence[torch.Tensor], mesh: Mesh,
                 axes: AxisSpec):
        self.mesh = mesh
        self.axes = _axes_tuple(axes)
        self.pieces = list(pieces)
        if len(self.pieces) != mesh.size:
            raise ValueError(f"{len(self.pieces)} pieces for a mesh of "
                             f"{mesh.size} positions")

    # -- layout -------------------------------------------------------------

    @property
    def num_shards(self) -> int:
        return axis_size(self.mesh, self.axes or None)

    def shard_index(self, position: int) -> int:
        """The shard position ``position`` holds."""
        return _shard_index(self.mesh, self.axes, position)

    def shard_positions(self) -> list:
        """The first position holding each shard, in shard order."""
        first = {}
        for p in range(self.mesh.size):
            first.setdefault(self.shard_index(p), p)
        return [first[k] for k in range(self.num_shards)]

    @property
    def shape(self) -> tuple:
        piece = self.pieces[0]
        return (piece.shape[0] * self.num_shards, *piece.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    def gather(self, device) -> torch.Tensor:
        """The global tensor on ``device`` (rows in shard order)."""
        return torch.cat([self.pieces[p].to(device)
                          for p in self.shard_positions()])

    # -- piecewise maths ------------------------------------------------------

    def map(self, fn: Callable, *others) -> "RowSharded":
        """``fn(piece, *others' pieces)`` at every position: another
        :class:`RowSharded` gives its piece at that position, a tensor is
        moved to the position's device, anything else is passed as is."""
        def arg(o, p, dev):
            if isinstance(o, RowSharded):
                return o.pieces[p]
            if isinstance(o, torch.Tensor):
                return o.to(dev)
            return o

        return RowSharded(
            [fn(piece, *(arg(o, p, dev) for o in others))
             for p, (piece, dev) in enumerate(zip(self.pieces,
                                                  self.mesh.devices))],
            self.mesh, self.axes)

    def __add__(self, other):
        return self.map(torch.add, other)

    def __sub__(self, other):
        return self.map(torch.sub, other)

    def __mul__(self, other):
        return self.map(torch.mul, other)

    def __truediv__(self, other):
        return self.map(torch.div, other)

    def detach(self) -> "RowSharded":
        return self.map(torch.Tensor.detach)

    def col_sum(self) -> torch.Tensor:
        """Sum over all global rows, one tensor on the mesh's first device
        (shards added in shard order: the reference's cross-device psum)."""
        home = self.mesh.devices[0]
        total = None
        for p in self.shard_positions():
            part = self.pieces[p].sum(dim=0).to(home)
            total = part if total is None else total + part
        return total


def shard_rows(t: torch.Tensor, mesh: Mesh,
               axes: AxisSpec = None) -> RowSharded:
    """``t``'s rows split over ``axes`` (default: every row axis the mesh
    has), one piece per position on its device. Raises unless the rows
    divide by the shard count, as ``NamedSharding`` does."""
    axes = row_axes(mesh) if axes is None else _axes_tuple(_present(mesh, axes))
    k = axis_size(mesh, axes or None)
    n = t.shape[0]
    if n % k != 0:
        raise ValueError(f"{n} rows do not divide over {k} shards "
                         f"(axes {axes} of {mesh.shape})")
    n_loc = n // k
    starts = [_shard_index(mesh, axes, p) * n_loc for p in range(mesh.size)]
    return RowSharded([t[i:i + n_loc].to(dev)
                       for i, dev in zip(starts, mesh.devices)], mesh, axes)


def as_row_sharded(t, mesh: Mesh) -> RowSharded:
    """``t`` when it is already a :class:`RowSharded` on ``mesh``, else its
    rows split over every row axis (what ``shard_map`` does to an input
    that comes in unsharded)."""
    if isinstance(t, RowSharded):
        if t.mesh is not mesh:
            raise ValueError("row-sharded input lives on another mesh")
        return t
    return shard_rows(t, mesh)
