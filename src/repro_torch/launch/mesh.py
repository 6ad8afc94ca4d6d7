"""Device meshes of the port; port of ``repro.launch.mesh``.

A :class:`Mesh` is a single-process grid of ``torch.device``\\s with named
axes, the counterpart of ``jax.make_mesh``: one process drives every
position, each shard is a tensor on its position's device, and the
distributed code (:mod:`repro_torch.distributed`) moves data between
positions with device-to-device copies. A mesh may name one device more
than once: ``devices=[torch.device("cuda:0")] * 8`` is eight virtual shards
on one card, the counterpart of XLA's forced host device count
(``--xla_force_host_platform_device_count``), and ``["cpu"] * 8`` is the
same on the CPU (the tests' meshes).

Without ``devices=`` the builders take the visible CUDA devices in order
and raise when the shape needs more than are visible: there is no silent
CPU mesh and no silent repetition. Functions, not module-level constants:
importing this module touches no device.

The LM substrate's training step (``repro_torch.models``) runs on one card
without a mesh; its model-FLOP share is taken against
:data:`PEAK_BF16_FLOPS`. :func:`make_production_mesh` builds the dry-run's
256- and 512-position meshes, whose positions are ``meta`` placeholders:
the dry-run (:mod:`repro_torch.launch.dryrun`) only accounts for a
placement over them. The reference sets a forced host device count before
JAX starts (``REPRO_DRYRUN_DEVICES``); the port has no device-count lock,
so it needs no such variable.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

DeviceLike = Union[str, torch.device]


class Mesh:
    """Named axes over a row-major grid of devices.

    Attributes:
      axis_names: the axes, outermost first.
      shape: ``{axis: size}`` in axis order (``mesh.shape["data"]`` as in
        JAX).
      devices: one ``torch.device`` per position, in mesh (row-major) order.
      moved_bytes: bytes the ring's moves have copied between positions
        on this mesh (all positions together).
    """

    def __init__(self, devices: Sequence[DeviceLike], shape: Sequence[int],
                 axis_names: Sequence[str]):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not match axes "
                             f"{axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis in {axis_names}")
        if len(devices) != math.prod(shape):
            raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} "
                             f"devices, got {len(devices)}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.devices = [_indexed(torch.device(d)) for d in devices]
        self._copy_streams: dict = {}
        self.moved_bytes = 0

    @property
    def size(self) -> int:
        """Number of positions (``mesh.devices.size`` in JAX)."""
        return len(self.devices)

    def coords(self, position: int) -> dict:
        """``{axis: index}`` of a position (row-major, last axis fastest)."""
        out = {}
        for axis in reversed(self.axis_names):
            position, out[axis] = divmod(position, self.shape[axis])
        return {a: out[a] for a in self.axis_names}

    def position(self, coords: dict) -> int:
        """The position at ``{axis: index}`` (the inverse of :meth:`coords`)."""
        p = 0
        for axis in self.axis_names:
            p = p * self.shape[axis] + coords[axis]
        return p

    def copy_stream(self, device: torch.device):
        """The side stream that this mesh's rotations copy on, one per CUDA
        device, made at first use."""
        if device not in self._copy_streams:
            self._copy_streams[device] = torch.cuda.Stream(device=device)
        return self._copy_streams[device]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so a position's device equals the
    device of the tensors placed there."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _visible_cards(count: int) -> list:
    """The first ``count`` visible CUDA devices; raises if there are fewer."""
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count > visible:
        raise RuntimeError(
            f"the mesh needs {count} CUDA device(s) but {visible} are visible; "
            "pass devices=[...] for virtual shards (e.g. [torch.device("
            "'cuda:0')] * n, or ['cpu'] * n on the CPU)")
    return [torch.device("cuda", i) for i in range(count)]


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes`` over ``devices`` (mesh
    order), by default the first ``prod(shape)`` visible CUDA devices."""
    if devices is None:
        devices = _visible_cards(math.prod(shape))
    return Mesh(devices, shape, axes)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence[DeviceLike]] = None
                         ) -> Mesh:
    """(16, 16) ("data", "model") = 256 positions on one pod; (2, 16, 16)
    ("pod", "data", "model") = 512 over two. Positions default to
    ``meta`` placeholders (nothing runs there); ``devices=`` may pass real
    cards or virtual shards."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if devices is None:
        devices = [torch.device("meta")] * math.prod(shape)
    return Mesh(devices, shape, axes)


def make_host_mesh(device: DeviceLike = "cuda") -> Mesh:
    """``(n, 1)`` over ("data", "model"): every visible card for
    ``device="cuda"`` (raises without one), the one CPU for ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return make_mesh((1, 1), ("data", "model"), devices=[dev])
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("make_host_mesh(device='cuda'): no CUDA device is "
                           "visible; pass device='cpu' for the CPU")
    return make_mesh((count, 1), ("data", "model"))


def make_lane_mesh(num_devices: Optional[int] = None,
                   devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """1-D mesh over a ``"lanes"`` axis for data-parallel scenario sweeps.

    Each position owns a contiguous slice of the lanes of a batched sweep
    (``core.driver.fit_batch(mesh=...)``): lanes are independent, so the
    sweep runs one lane-stacked program per position with nothing
    exchanged on the hot path. ``fit_batch`` runs the positions' groups
    in turn, so the cards do not overlap yet. ``devices`` when given (``num_devices``, if
    also given, must match its length); else ``num_devices`` (default:
    all) visible cards.
    """
    if devices is not None:
        if num_devices is not None and num_devices != len(devices):
            raise ValueError(f"num_devices={num_devices} but "
                             f"{len(devices)} devices given")
        return make_mesh((len(devices),), ("lanes",), devices=devices)
    if num_devices is None:
        num_devices = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if num_devices == 0:
            raise RuntimeError("make_lane_mesh: no CUDA device is visible; "
                               "pass devices=[...] for a CPU mesh")
    return make_mesh((num_devices,), ("lanes",))


# NVIDIA H100 SXM (NVIDIA H100 80GB HBM3, 700 W) data-sheet peaks for the
# roofline, per card: dense bf16 tensor cores, HBM, NVLink each way.
# NVLINK_BW stands in for the reference's ICI_BW: one link figure for every
# mesh axis, as the reference uses one.
PEAK_BF16_FLOPS = 989e12  # FLOP/s
HBM_BW = 3.35e12  # B/s
NVLINK_BW = 450e9  # B/s each way
ICI_BW = NVLINK_BW
