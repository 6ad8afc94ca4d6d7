"""Ring MVM for the GP path: K(x, x) @ V with the rows of x and V sharded
over a mesh; port of ``repro.distributed.ring``.

Each position holds a row block (x_loc, v_loc). A rotating copy (x_rot,
v_rot) moves around a hierarchical ring over the present axes of
:data:`ROW_AXES`: the innermost axis completes a sweep between rotations of
the next, as the reference's nested ``scan``s of ``ppermute``. After one
tile per position and ring step every position has accumulated

    out_loc = sum_j K(x_loc, x_j) v_j,

the full row block of K @ V, without K ever existing. Every tile is
:func:`repro_torch.kernels.ops.kernel_mvm`: on CUDA tensors the forward
distance-tile kernel (``csrc/kernel_mvm.cu``), on CPU tensors its plain
version; the gradient through the ring is its ``_UnitMVM`` backward (the
backward kernel; the fused call on each position's own tile, where the two
operands are one tensor). Raw x rotates and each tile scales it, as the
reference does, so autograd holds only the shard-sized buffers.

The reference's single program becomes one process driving a
:class:`~repro_torch.launch.mesh.Mesh`: a rotation is a device-to-device
copy into fresh receive buffers on the mesh's copy stream of each device,
issued before the local tile (as the reference issues its ``ppermute``
before the tile contraction), after the compute stream's work so far; the
next tile waits for the copy's event, and ``record_stream`` keeps the
allocator from handing a buffer out while the other stream still uses it.
A rotation always copies, also between two positions on one device, so a
mesh of virtual shards on one card runs the code path of a multi-card
host. Rotations that land after the last tile are dropped, and consecutive
rotations (the end of an inner sweep) are one copy.

``tile_dtype=torch.bfloat16`` keeps the reference's bf16 rotating buffers
(half the copy bytes). The tile arithmetic stays the kernel's fp32, since
the ported kernels take fp32 only: unlike the reference, the distance and
profile tiles are not evaluated in bf16, so the result differs from the
reference's bf16 ring by bf16 round-off in the buffers only.

``jax.checkpoint``'s recomputation has no counterpart: ``_UnitMVM`` saves
only its inputs (the rotating buffers), never a distance tile.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch

from repro_torch.distributed.sharding import (
    ROW_AXES,
    RowSharded,
    as_row_sharded,
    row_axes,
)
from repro_torch.gp.hyperparams import HyperParams
from repro_torch.kernels.ops import kernel_mvm
from repro_torch.launch.mesh import Mesh

__all__ = ["ROW_AXES", "global_col_norms", "params_on", "ring_h_mvm",
           "ring_kernel_mvm", "ring_moves", "ring_sweep"]


def params_on(params: HyperParams, device) -> HyperParams:
    """``params`` with every leaf on ``device`` (differentiable; no copy
    where a leaf is there already)."""
    return params.with_leaves([p.to(device) for p in params.leaves])


def ring_moves(mesh: Mesh, axes: Sequence[str]) -> list:
    """The data movement between consecutive tiles of one ring sweep over
    ``axes`` (outermost first): one map per move, ``src[p]`` the position
    whose buffer position p receives. A sweep has ``prod`` of the axes'
    sizes tiles and one move fewer."""
    ops = []

    def level(lv: int) -> None:
        for _ in range(mesh.shape[axes[lv]]):
            if lv + 1 < len(axes):
                level(lv + 1)
            else:
                ops.append(None)
            ops.append(axes[lv])

    if axes:
        level(0)
    else:
        ops.append(None)
    while ops[-1] is not None:  # rotations after the last tile
        ops.pop()

    def prev(p: int, axis: str) -> int:
        c = mesh.coords(p)
        c[axis] = (c[axis] - 1) % mesh.shape[axis]
        return mesh.position(c)

    ident = list(range(mesh.size))
    moves, src = [], ident
    for op in ops[1:]:
        if op is None:
            moves.append(src)
            src = ident
        else:  # ppermute i -> i + 1: p now holds what prev(p) held
            src = [src[prev(p, op)] for p in range(mesh.size)]
    return moves


class _Streams:
    """The compute and copy streams of a mesh's CUDA devices, and the
    events that order a ring's copies and tiles."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.devices = list(dict.fromkeys(
            d for d in mesh.devices if d.type == "cuda"))
        self.compute = {d: torch.cuda.current_stream(d) for d in self.devices}
        self.copy = {d: mesh.copy_stream(d) for d in self.devices}
        self.ready = {}

    def move(self, bufs: list, src: list) -> list:
        """Copy ``bufs[src[p]]`` into fresh buffers on position p's device,
        on the copy streams, after the compute streams' work so far."""
        for d in self.devices:
            self.copy[d].wait_stream(self.compute[d])
        out = []
        with contextlib.ExitStack() as stack:
            # A cross-device copy_ runs on the source device's current
            # stream and fences the destination's: make both copy streams.
            for d in self.devices:
                stack.enter_context(torch.cuda.stream(self.copy[d]))
            for p, dst in enumerate(self.mesh.devices):
                moved = []
                for b in bufs[src[p]]:
                    o = torch.empty_like(b, device=dst)
                    o.copy_(b, non_blocking=True)
                    self.mesh.moved_bytes += b.numel() * b.element_size()
                    if dst.type == "cuda":
                        b.record_stream(self.copy[b.device])
                        o.record_stream(self.compute[dst])
                    moved.append(o)
                out.append(tuple(moved))
        self.ready = {d: self.copy[d].record_event() for d in self.devices}
        return out

    def wait_ready(self) -> None:
        """Order the next tiles after the last move's copies."""
        for d, event in self.ready.items():
            self.compute[d].wait_event(event)


def ring_sweep(mesh: Mesh, rotating: list, tile: Callable,
               axes: Sequence[str] = None) -> list:
    """One hierarchical ring sweep: ``rotating[p]`` (a tuple of tensors on
    position p's device) travels the ring over ``axes`` (default: the
    mesh's row axes), and at every step each position adds ``tile(p,
    bufs, home)`` (``home``: the position the buffers started at) to its
    sum. Returns the sums, one per position, in the reference's order
    (``acc = 0 + tile_0 + tile_1 + ...``)."""
    axes = row_axes(mesh) if axes is None else tuple(axes)
    moves = ring_moves(mesh, axes)
    streams = _Streams(mesh)
    bufs, home = list(rotating), list(range(mesh.size))
    acc = [None] * mesh.size
    for t in range(len(moves) + 1):
        streams.wait_ready()
        nxt = streams.move(bufs, moves[t]) if t < len(moves) else None
        for p in range(mesh.size):
            c = tile(p, bufs[p], home[p])
            acc[p] = c if acc[p] is None else acc[p] + c
        if nxt is not None:
            home = [home[q] for q in moves[t]]
            bufs = nxt
    return acc


def _no_grad_inputs(*ts: RowSharded) -> None:
    if any(piece.requires_grad for t in ts for piece in t.pieces):
        raise ValueError("the ring differentiates the hyperparameters only: "
                         "its rotating copies of x and v are raw data")


def ring_kernel_mvm(x, v, params: HyperParams, mesh: Mesh,
                    kind: str = "matern32",
                    tile_dtype: torch.dtype = torch.float32) -> RowSharded:
    """K(x, x) @ v on the mesh (noise NOT added).

    Args:
      x: (n, d), v: (n, s), each a :class:`RowSharded` over the mesh's row
        axes, or a tensor, then split so first. Neither may require grad.
      params: replicated hyperparameters (moved to each position's device;
        the gradient flows back to them).
      tile_dtype: the rotating buffers' dtype (see the module docstring).
    Returns:
      (n, s) :class:`RowSharded`, in v's dtype.
    """
    x, v = as_row_sharded(x, mesh), as_row_sharded(v, mesh)
    _no_grad_inputs(x, v)
    at = [params_on(params, dev) for dev in mesh.devices]
    rotating = [(xp.to(tile_dtype), vp.to(tile_dtype))
                for xp, vp in zip(x.pieces, v.pieces)]

    def tile(p, bufs, home):
        xr, vr = bufs
        # fp32 buffers at home are the local piece itself, so the own tile
        # sees one tensor twice (the fused backward's case).
        return kernel_mvm(x.pieces[p], xr.to(torch.float32),
                          vr.to(torch.float32), at[p], kind=kind)

    acc = ring_sweep(mesh, rotating, tile, axes=x.axes)
    return RowSharded([a.to(vp.dtype) for a, vp in zip(acc, v.pieces)],
                      mesh, x.axes)


def ring_h_mvm(x, v, params: HyperParams, mesh: Mesh,
               kind: str = "matern32",
               tile_dtype: torch.dtype = torch.float32) -> RowSharded:
    """H @ v = K @ v + sigma^2 v on the mesh."""
    v = as_row_sharded(v, mesh)
    kv = ring_kernel_mvm(x, v, params, mesh, kind=kind, tile_dtype=tile_dtype)
    return kv + v.map(torch.mul, params.noise**2)


def global_col_norms(r: RowSharded) -> torch.Tensor:
    """Per-column L2 norms of a row-sharded matrix (a global reduction;
    one tensor on the mesh's first device)."""
    return torch.sqrt((r * r).col_sum())
