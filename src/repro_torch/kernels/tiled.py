"""Distance-tile kernels: the forward MVM and its backward, CUDA and plain.

Forward: ``out[i] = sum_j kappa(||u_i - w_j||^2) v_j`` on pre-scaled inputs
``u`` (n, d), ``w`` (m, d) and ``v`` (m, s), fp32, without materialising K.
Backward: ``du[i] = 2 sum_j D_ij (u_i - w_j)`` with ``D = (g v^T) .*
dkappa/dr2``, the cotangent of ``u`` for the output cotangent ``g`` (n, s);
with (u, w) and (g, v) swapped it is the cotangent of ``w``, and with
``(u, u, [g | v], [v | g])`` it is ``du + dw`` of ``kappa(u, u) @ v`` (the
fused call: ``(g_i . v_j + v_i . g_j)`` is the Gram of the concatenated
operands, so one sweep serves both roles). They replace
the TPU kernels ``kernel_mvm_pallas`` and ``kernel_mvm_bwd_pallas`` of the
reference (``src/repro/kernels/tiled.py:98`` and ``:131``); the designs and
their bounds on an H100 are described at the top of ``csrc/kernel_mvm.cu``
and ``csrc/kernel_mvm_bwd.cu``.

* :func:`kernel_mvm_cuda` and :func:`kernel_mvm_bwd_cuda` launch the
  hand-written kernels on CUDA tensors (and raise on anything else). They
  take any d and s: each kernel has a second path for large d, and the
  backward wrapper splits the columns of (g, v) over launches where its
  row tiles would not fit in shared memory. They count their launches in
  :data:`LAUNCHES`, and the launches that took their second pass (the
  split sum) in :data:`SECOND_PASSES`, both under one lock
  (:func:`count_launch`), so threads that launch at once lose no count.
  :func:`kernel_mvm_bwd_fused_cuda` is the fused call: it builds the
  concatenated operands and launches the backward kernel once (once per
  column chunk).
* :func:`split_plan` and :func:`bwd_split_plan` pick how many column splits
  each kernel runs, from the shapes and the card's SM count;
  :func:`bwd_s_chunks` the backward's column chunks of (g, v).
* :func:`kernel_mvm_plain` and :func:`kernel_mvm_bwd_plain` are the same
  functions in plain tiled PyTorch, with ``r2`` by direct differences as in
  the kernels.
* :func:`kernel_mvm_mirror` and :func:`kernel_mvm_bwd_mirror` repeat the
  kernels' arithmetic on the CPU for the tests: their column tiles and
  splits, the split sum in split order, and their 3xTF32 products
  (:func:`tf32_round`).
* :func:`kernel_mvm_unit`, :func:`kernel_mvm_bwd_unit` and
  :func:`kernel_mvm_bwd_fused_unit` pick between them
  by the device of their inputs: the plain version for CPU tensors, the
  kernel for CUDA tensors. There is no fallback from one to the other.

Every function takes one system (2-D operands) or B lanes of independent
systems stacked on a leading axis (3-D operands, ``u`` (B, n, d) etc.), as
``vmap`` of the reference's kernels adds a grid axis. A lane-stacked call is
one launch of each kernel for all B lanes, planned from B times the row
blocks (:func:`split_plan`, :func:`bwd_split_plan`); with B = 1 the plan and
the launch are the single-system ones.

The kernels are built from ``csrc/*.cu`` at first use with ``nvcc``
(``sm_90a``; one compile per source, started together, then one link) into
``build/repro_torch_kernels/`` of the checkout, as one shared library with a
plain C interface loaded through ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from functools import lru_cache, partial
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.registry import KIND_CODES, get_kernel

KERNEL_NAME = "kernel_mvm_fwd"
BWD_KERNEL_NAME = "kernel_mvm_bwd"
CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = (CSRC / "kernel_mvm.cu", CSRC / "kernel_mvm_bwd.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Launches of each kernel wrapper since the last reset (chip_smoke.py reads
# them to show the main path went through the kernels), and the calls
# among them that ran the second pass (the sum over column splits).
LAUNCHES = {KERNEL_NAME: 0, BWD_KERNEL_NAME: 0}
SECOND_PASSES = {KERNEL_NAME: 0, BWD_KERNEL_NAME: 0}

# Geometry of csrc/kernel_mvm.cu: 128-row blocks, 128-row column tiles,
# s-chunks of 8 * NT columns with NT <= 9, row strides padded as the kernel
# pads them; for planning splits and rejecting shapes before the launch.
FWD_BM, FWD_BN, FWD_MAX_NT = 128, 128, 9
# Geometry of csrc/kernel_mvm_bwd.cu: 128-row blocks, 64-row column tiles,
# row strides padded as the kernel pads them. Its per-thread sums hold up
# to 96 coordinates; for d > 96 its wide path stages u and w 96
# coordinates at a time, so shared memory is then d = 96's. g's and v's
# row tiles sit in shared memory whole, which bounds s per launch
# (:func:`bwd_s_chunks`). The fused call pads s' to a multiple of 8 (one
# mma k-step, and 16-byte rows for the copies).
BWD_BM, BWD_BN = 128, 64
_BWD_DC = 96
_FUSED_S_MULTIPLE = 8
_MAX_SMEM_BYTES = 232_448
# The kernels hold each dimension, and the row counts rounded up to their
# 128-row tiles, in 32-bit ints; every element offset (n*d, n*s, m*s,
# splits*n*s) is formed in 64 bits.
_INT32_LIMIT = 2**31

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


# One lock for both tables: the engine's worker thread and a background
# refresh launch kernels while the main thread does, and the smoke holds the
# counts to exact equalities.
_count_lock = threading.Lock()


def count_launch(name: str, second_pass: bool = False) -> None:
    """Add one launch of kernel ``name`` (and one second-pass call when
    ``second_pass``) to the counts, under their lock."""
    with _count_lock:
        LAUNCHES[name] += 1
        if second_pass:
            SECOND_PASSES[name] += 1


def reset_launch_counts() -> None:
    """Set every kernel's launch count (and second-pass count) to 0."""
    with _count_lock:
        for counts in (LAUNCHES, SECOND_PASSES):
            for name in counts:
                counts[name] = 0


def launch_counts() -> dict:
    """A copy of the launch counts since the last reset."""
    with _count_lock:
        return dict(LAUNCHES)


def second_pass_counts() -> dict:
    """A copy of the second-pass counts since the last reset."""
    with _count_lock:
        return dict(SECOND_PASSES)


# -- plain version ----------------------------------------------------------


def kernel_mvm_plain(u: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                     kind: str = "matern32", bm: int = 512,
                     bn: int = 512) -> torch.Tensor:
    """kappa(u, w) @ v in plain tiled PyTorch: (n,d),(m,d),(m,s) -> (n,s),
    or lane-stacked (B,n,d),(B,m,d),(B,m,s) -> (B,n,s).

    Same arithmetic as the kernel: ``r2`` by direct differences (exact zero
    at coincident points), the registry profile, an accumulation over column
    tiles. Works on any device and dtype, and under autograd.
    """
    kappa = get_kernel(kind).kappa_from_r2
    n, m, s = u.shape[-2], w.shape[-2], v.shape[-1]
    lead = u.shape[:-2]
    dtype = torch.result_type(u, v)
    rows = []
    for i in range(0, n, bm):
        ui = u[..., i:i + bm, :]
        acc = torch.zeros((*lead, ui.shape[-2], s), dtype=dtype,
                          device=u.device)
        for j in range(0, m, bn):
            diff = ui[..., :, None, :] - w[..., None, j:j + bn, :]
            acc = acc + kappa(torch.sum(diff * diff, dim=-1)) @ v[..., j:j + bn, :]
        rows.append(acc)
    if not rows:
        return torch.zeros((*lead, 0, s), dtype=dtype, device=u.device)
    return torch.cat(rows, dim=-2)


def kernel_mvm_bwd_plain(u: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                         v: torch.Tensor, kind: str = "matern32", bm: int = 512,
                         bn: int = 512) -> torch.Tensor:
    """Cotangent of ``u`` for ``kappa(u, w) @ v`` in plain tiled PyTorch.

    ``du_i = 2 sum_j D_ij (u_i - w_j)`` with ``D = (g v^T) * dkappa(r2)``:
    (n,d),(m,d),(n,s),(m,s) -> (n,d), or lane-stacked with a leading B axis
    on every operand. Same arithmetic as the kernel: ``r2`` by direct
    differences, the registry slope, the sum in difference form,
    accumulated over column tiles. Works on any device and dtype.
    """
    dkappa = get_kernel(kind).dkappa_dr2
    n, d = u.shape[-2:]
    m = w.shape[-2]
    lead = u.shape[:-2]
    dtype = torch.result_type(u, g)
    rows = []
    for i in range(0, n, bm):
        ui, gi = u[..., i:i + bm, :], g[..., i:i + bm, :]
        acc = torch.zeros((*lead, ui.shape[-2], d), dtype=dtype,
                          device=u.device)
        for j in range(0, m, bn):
            diff = ui[..., :, None, :] - w[..., None, j:j + bn, :]
            dt = ((gi @ v[..., j:j + bn, :].transpose(-1, -2))
                  * dkappa(torch.sum(diff * diff, dim=-1)))
            acc = acc + torch.einsum("...ij,...ijk->...ik", dt, diff)
        rows.append(2.0 * acc)
    if not rows:
        return torch.zeros((*lead, 0, d), dtype=dtype, device=u.device)
    return torch.cat(rows, dim=-2)


# -- the forward kernel's plan, and a CPU mirror of its arithmetic ----------


def _fwd_nt(s: int) -> int:
    """n8 tiles of s per block (the kernel's ``num_nt``)."""
    return min(FWD_MAX_NT, -(-s // 8))


def _fwd_grid(n: int, m: int, s: int) -> tuple:
    """(row tiles, s-chunks, column tiles) of the forward kernel."""
    return (-(-n // FWD_BM), -(-s // (8 * _fwd_nt(s))), -(-m // FWD_BN))


def _plan_splits(base: int, tiles: int, num_sms: int, lanes: int = 1) -> int:
    """Column splits for ``base`` blocks per split and lane over ``tiles``
    column tiles, one block per SM at a time.

    The blocks of a split are ``base * lanes``. One split when there is at
    most one column tile, or when those blocks alone make two waves on
    ``num_sms`` SMs. Otherwise the count, up to four waves of blocks (and
    ``lanes * splits`` within the grid's 65535), that minimises
    ``ceil(blocks / num_sms) * ceil(tiles / splits)`` (the column tiles the
    busiest SM walks), the smallest such count on ties.
    """
    base *= lanes
    if tiles <= 1 or base >= 2 * num_sms:
        return 1
    most = max(1, min(tiles, 65535 // lanes, (4 * num_sms) // base))
    return min(range(1, most + 1),
               key=lambda k: (-(-base * k // num_sms)) * -(-tiles // k))


@lru_cache(maxsize=4096)
def split_plan(n: int, m: int, s: int, num_sms: int, lanes: int = 1) -> int:
    """Number of column splits for the forward kernel at these shapes: its
    base blocks are the row tiles times the s-chunks, times the lanes
    (:func:`_plan_splits`)."""
    rows, chunks, tiles = _fwd_grid(n, m, s)
    return _plan_splits(rows * chunks, tiles, num_sms, lanes)


@lru_cache(maxsize=4096)
def bwd_split_plan(n: int, m: int, num_sms: int, lanes: int = 1) -> int:
    """Number of column splits for the backward kernel at these shapes: its
    base blocks are the 128-row tiles of u times the lanes, its column
    tiles 64 rows of w (:func:`_plan_splits`)."""
    return _plan_splits(-(-n // BWD_BM), -(-m // BWD_BN), num_sms, lanes)


def split_tile_range(z: int, splits: int, tiles: int) -> tuple:
    """Column tiles [lo, hi) that split ``z`` walks (the kernel's formula)."""
    return z * tiles // splits, (z + 1) * tiles // splits


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 (10 explicit mantissa bits), round to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``; returned as fp32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the tensor cores form it from TF32 operands: each product of
    two TF32 values is exact in fp32, and the sums are fp32. ``passes`` 3 is
    the split big*small + small*big + big*big; 1 is big*big alone."""
    a_big, b_big = tf32_round(a), tf32_round(b)
    if passes == 1:
        return a_big @ b_big
    a_small, b_small = tf32_round(a - a_big), tf32_round(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def kernel_mvm_mirror(u: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                      kind: str = "matern32", splits: Optional[int] = None,
                      passes: int = 3) -> torch.Tensor:
    """The forward kernel's arithmetic in plain PyTorch, for the tests.

    fp32 CPU tensors. Column tiles of 128 rows of (w, v); ``r2`` by direct
    differences and the registry profile in fp32 (the kernel evaluates the
    profile on the special-function units, within a few ulps); ``kappa @
    V`` per tile with TF32 operands (:func:`_tf32_product`, ``passes`` 3 or
    1); each split's sum over its own tiles, and the splits summed in split
    order. ``splits`` defaults to :func:`split_plan` on an H100's 132 SMs.
    Lane-stacked operands mirror each lane at the split count of the
    lane-stacked launch (the lanes are independent in the kernel).
    """
    if u.ndim == 3:
        if splits is None:
            splits = split_plan(u.shape[1], w.shape[1], v.shape[2], 132,
                                u.shape[0])
        return torch.stack([kernel_mvm_mirror(a, b, c, kind, splits, passes)
                            for a, b, c in zip(u, w, v)])
    kappa = get_kernel(kind).kappa_from_r2
    n, m, s = u.shape[0], w.shape[0], v.shape[1]
    tiles = _fwd_grid(n, m, s)[2]
    if splits is None:
        splits = split_plan(n, m, s, 132)
    total = None
    for z in range(splits):
        lo, hi = split_tile_range(z, splits, tiles)
        part = torch.zeros((n, s), dtype=torch.float32)
        for jt in range(lo, hi):
            j = slice(jt * FWD_BN, (jt + 1) * FWD_BN)
            diff = u[:, None, :] - w[None, j, :]
            part = part + _tf32_product(kappa(torch.sum(diff * diff, dim=-1)),
                                        v[j], passes)
        total = part if total is None else total + part
    return total


def kernel_mvm_bwd_mirror(u: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                          v: torch.Tensor, kind: str = "matern32",
                          splits: Optional[int] = None,
                          passes: int = 3) -> torch.Tensor:
    """The backward kernel's arithmetic in plain PyTorch, for the tests.

    fp32 CPU tensors. Column tiles of 64 rows of (w, v); per tile ``r2`` by
    direct differences and the registry slope in fp32 (the kernel evaluates
    the slope on the special-function units, within a few ulps), the Gram
    ``g v^T`` from 0 with TF32 operands (:func:`_tf32_product`, ``passes``
    3 or 1), and the sum in difference form ``sum_j D_ij (u_i - w_j)``;
    each split's sum over its own tiles, and the splits summed in split
    order. ``splits`` defaults to :func:`bwd_split_plan` on an H100's 132
    SMs. With ``(u, u, [g | v], [v | g])`` it mirrors the fused call.
    Lane-stacked operands mirror each lane at the split count of the
    lane-stacked launch.
    """
    if u.ndim == 3:
        if splits is None:
            splits = bwd_split_plan(u.shape[1], w.shape[1], 132, u.shape[0])
        return torch.stack([kernel_mvm_bwd_mirror(a, b, c, e, kind, splits,
                                                  passes)
                            for a, b, c, e in zip(u, w, g, v)])
    dkappa = get_kernel(kind).dkappa_dr2
    n, d = u.shape
    m = w.shape[0]
    tiles = -(-m // BWD_BN)
    if splits is None:
        splits = bwd_split_plan(n, m, 132)
    total = None
    for z in range(splits):
        lo, hi = split_tile_range(z, splits, tiles)
        part = torch.zeros((n, d), dtype=torch.float32)
        for jt in range(lo, hi):
            j = slice(jt * BWD_BN, (jt + 1) * BWD_BN)
            diff = u[:, None, :] - w[None, j, :]
            dt = (_tf32_product(g, v[j].T, passes)
                  * dkappa(torch.sum(diff * diff, dim=-1)))
            part = part + torch.einsum("ij,ijk->ik", dt, diff)
        total = 2.0 * part if total is None else total + 2.0 * part
    return total


# -- build and bind -----------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_kernels() -> Path:
    """Compile ``csrc/*.cu`` for sm_90a and link them into one library
    (once per content of the sources).

    One ``nvcc -c`` per source runs at the same time, then one ``nvcc
    -shared`` links the objects. Returns the path of the shared library;
    nvcc's ``-Xptxas -v`` report (registers, shared memory, spills per
    instantiation) is kept beside it as ``<library>.ptxas.txt``.
    """
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libkernel_mvm_{digest.hexdigest()[:12]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp, f"{src.stem}.o") for src in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [(src.name, log) for src, proc, log in zip(SOURCES, procs, logs)
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name}:\n{log}" for name, log in failed))
        lib = Path(tmp, "lib.so")
        proc = subprocess.run([nvcc, "-shared", "-o", str(lib), *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        Path(f"{out}.ptxas.txt").write_text("".join(logs))
        os.replace(lib, out)
    return out


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_kernels()))
            fwd = lib.repro_kernel_mvm_fwd
            fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
                ctypes.c_void_p]
            fwd.restype = ctypes.c_int
            bwd = lib.repro_kernel_mvm_bwd
            bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
                ctypes.c_void_p]
            bwd.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


# -- wrappers -----------------------------------------------------------------


def _padded_d(d: int) -> int:
    """The kernels' row stride of u and w: d rounded up to 4, 4 mod 8."""
    dp = -(-d // 4) * 4
    return dp + 4 if dp % 8 == 0 else dp


def _smem_bytes(d: int, s: int) -> int:
    """Least dynamic shared memory of the forward kernel's first path: the
    threads' running sums, u's row tile and one (w, v) column-tile buffer,
    at the kernel's padded row strides. (It takes a second buffer where it
    fits, d <= 52.)"""
    nt = _fwd_nt(s)
    sp = 8 * (nt | 1)
    dp = _padded_d(d)
    return 4 * (2 * nt * 4 * 2 * FWD_BM + FWD_BM * dp + FWD_BN * (dp + sp))


def fwd_wide(d: int, s: int) -> bool:
    """Whether the forward kernel takes its wide path at (d, s): where u's
    row tile and one buffer do not fit in shared memory (d > 116 at
    s >= 72), u and w are staged 64 coordinates at a time."""
    return _smem_bytes(d, s) > _MAX_SMEM_BYTES


@lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bwd_smem_bytes(d: int, s: int) -> int:
    """Least dynamic shared memory of the backward kernel: g's and u's row
    tiles and one (w, v) column-tile buffer at the kernel's padded row
    strides, u and w at most 96 coordinates wide. (It takes a second
    buffer where that fits.)"""
    sp = 8 * (-(-s // 8) | 1)
    return 4 * (BWD_BM + BWD_BN) * (_padded_d(min(d, _BWD_DC)) + sp)


def _fused_width(s: int) -> int:
    """s' of the fused call for s columns of g and v: 2s rounded up to 8."""
    return -(-2 * s // _FUSED_S_MULTIPLE) * _FUSED_S_MULTIPLE


@lru_cache(maxsize=4096)
def bwd_s_chunks(d: int, s: int, fused: bool = False) -> tuple:
    """Column ranges ``[lo, hi)`` of (g, v) that the backward kernel takes
    one launch each: as few as keep every launch's operands within
    :func:`_bwd_smem_bytes`, of near-equal width. ``fused`` counts each
    column twice, as the fused call's ``[g | v]`` and ``[v | g]`` carry it
    (a pair stays in one launch). D is a sum over the columns, so the
    launches' du add up to the whole."""
    q = (_MAX_SMEM_BYTES // (4 * (BWD_BM + BWD_BN))
         - _padded_d(min(d, _BWD_DC))) // 8
    widest = 8 * (q if q % 2 else q - 1)  # padded widths are odd multiples of 8
    most = widest // 2 if fused else widest
    count = max(1, -(-s // most))
    return tuple((k * s // count, (k + 1) * s // count) for k in range(count))


def _check_inputs(name: str, **tensors: torch.Tensor) -> int:
    """Raise unless every tensor is a contiguous fp32 CUDA tensor on one
    device that does not require grad (the raw kernels are not
    differentiable; :mod:`repro_torch.kernels.ops` wraps them), all 2-D
    (one system) or all 3-D with one lane count. Returns the lane count, 0
    for 2-D operands."""
    first = next(iter(tensors.values()))
    ndim = first.ndim
    for arg, t in tensors.items():
        if t.requires_grad:
            raise RuntimeError(
                f"{name} is forward-only: its inputs must not require grad "
                "(differentiate kernels.ops.kernel_mvm instead)")
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, not a CUDA "
                             "device")
        if t.device != first.device:
            raise ValueError(f"{name}: inputs on different devices")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} is {t.dtype}, not fp32")
        if t.ndim not in (2, 3) or t.ndim != ndim or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous and 2-D, or "
                             "3-D (lanes), like the other operands")
        if ndim == 3 and t.shape[0] != first.shape[0]:
            raise ValueError(f"{name}: {arg} has {t.shape[0]} lanes, not "
                             f"{first.shape[0]}")
    return first.shape[0] if ndim == 3 else 0


def _check_index_range(name: str, n: int, m: int, d: int, s: int,
                       lanes: int = 1) -> None:
    """Raise where a value the kernels hold in a 32-bit int would overflow
    (:data:`_INT32_LIMIT`): a dimension, the lane count, or a row count
    rounded up to the 128-row tiles; and past 65535 lanes (the grid's y
    extent, which holds lanes times splits)."""
    if max(n + FWD_BM, m + FWD_BM, d, s, lanes) >= _INT32_LIMIT or lanes > 65535:
        raise ValueError(f"{name}: n={n}, m={m}, d={d}, s={s}, lanes={lanes} "
                         "exceed the kernels' 32-bit index range")


def _launch(name: str, fn, device: torch.device, *args,
            second_pass: bool = False) -> None:
    """Call one C entry point on the current stream; raise on its code,
    else count the launch (:func:`count_launch`)."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = (_library().repro_cuda_error_string(rc).decode() if rc > 0
               else "rejected arguments")
        raise RuntimeError(f"{name} launch failed ({rc}): {msg}")
    count_launch(name, second_pass)


def kernel_mvm_cuda(u: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                    kind: str = "matern32") -> torch.Tensor:
    """Launch the forward tile kernel on CUDA tensors; (n, s) fp32 result,
    or (B, n, s) for lane-stacked (B, n, d), (B, m, d), (B, m, s) operands
    (one launch for all lanes).

    The column range is split as :func:`split_plan` says for the card's SM
    count and the lanes; with more than one split the partial sums go to a
    (splits, B, n, s) workspace and the kernel's second pass adds them in
    split order. Any d (the kernel's wide path where :func:`fwd_wide`) and
    any s. Raises on inputs that require grad (forward only), on tensors
    that are not fp32, contiguous, 2-D (or all 3-D) CUDA tensors of one
    device, on mismatched shapes, on an unknown kind and past the 32-bit
    index range.
    """
    lanes = _check_inputs("kernel_mvm_cuda", u=u, w=w, v=v)
    (n, d), (m, dw), (mv, s) = u.shape[-2:], w.shape[-2:], v.shape[-2:]
    if d != dw or m != mv:
        raise ValueError(f"kernel_mvm_cuda: shapes u{tuple(u.shape)} "
                         f"w{tuple(w.shape)} v{tuple(v.shape)} do not match")
    if kind not in KIND_CODES:
        raise ValueError(f"kernel_mvm_cuda: no CUDA profile for {kind!r}")
    if d == 0:
        raise ValueError("kernel_mvm_cuda: d = 0")
    b = max(lanes, 1)
    _check_index_range("kernel_mvm_cuda", n, m, d, s, b)
    out = torch.empty((*u.shape[:-2], n, s), dtype=torch.float32,
                      device=u.device)
    if u.numel() == 0 or s == 0:
        return out
    splits = split_plan(n, m, s, _num_sms(u.device.index), b)
    workspace = (torch.empty((splits, b, n, s), dtype=torch.float32,
                             device=u.device) if splits > 1 else None)
    _launch(KERNEL_NAME, _library().repro_kernel_mvm_fwd, u.device,
            u.data_ptr(), w.data_ptr(), v.data_ptr(), out.data_ptr(),
            workspace.data_ptr() if workspace is not None else None,
            n, m, d, s, KIND_CODES[kind], splits, b,
            second_pass=splits > 1)
    return out


def kernel_mvm_bwd_cuda(u: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                        v: torch.Tensor, kind: str = "matern32") -> torch.Tensor:
    """Launch the backward tile kernel on CUDA tensors; (n, d) fp32 result,
    or (B, n, d) for lane-stacked operands (one launch per column chunk for
    all lanes).

    The same checks as :func:`kernel_mvm_cuda`, for u (n, d), w (m, d),
    g (n, s) and v (m, s); any d (the kernel's wide path for d > 96) and
    any s: where g's and v's row tiles would not fit in shared memory, the
    columns go to one launch per chunk of :func:`bwd_s_chunks` and the du's
    are added. Within a launch the column range is split as
    :func:`bwd_split_plan` says; with more than one split the partial sums
    go to a workspace and the kernel's second pass adds them in split order.
    """
    lanes = _check_inputs("kernel_mvm_bwd_cuda", u=u, w=w, g=g, v=v)
    (n, d), (m, dw) = u.shape[-2:], w.shape[-2:]
    (ng, s), (mv, sv) = g.shape[-2:], v.shape[-2:]
    if d != dw or m != mv or n != ng or s != sv:
        raise ValueError(
            f"kernel_mvm_bwd_cuda: shapes u{tuple(u.shape)} w{tuple(w.shape)} "
            f"g{tuple(g.shape)} v{tuple(v.shape)} do not match")
    _check_bwd(n, m, d, s, kind, lanes)
    if u.numel() == 0 or s == 0:
        return torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    du = None
    for lo, hi in bwd_s_chunks(d, s):
        part = _bwd_launch(u, w, g[..., lo:hi].contiguous(),
                           v[..., lo:hi].contiguous(), kind)
        du = part if du is None else du.add_(part)
    return du


def _check_bwd(n: int, m: int, d: int, s: int, kind: str, lanes: int) -> None:
    if kind not in KIND_CODES:
        raise ValueError(f"kernel_mvm_bwd_cuda: no CUDA profile for {kind!r}")
    if d == 0:
        raise ValueError("kernel_mvm_bwd_cuda: d = 0")
    _check_index_range("kernel_mvm_bwd_cuda", n, m, d, s, max(lanes, 1))


def _bwd_launch(u: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                v: torch.Tensor, kind: str) -> torch.Tensor:
    """One launch of the backward kernel on checked operands (2-D, or 3-D
    lanes) whose row tiles fit in shared memory."""
    (n, d), m, s = u.shape[-2:], w.shape[-2], g.shape[-1]
    lanes = u.shape[0] if u.ndim == 3 else 1
    du = torch.empty(u.shape, dtype=torch.float32, device=u.device)
    splits = bwd_split_plan(n, m, _num_sms(u.device.index), lanes)
    workspace = (torch.empty((splits, lanes, n, d), dtype=torch.float32,
                             device=u.device) if splits > 1 else None)
    _launch(BWD_KERNEL_NAME, _library().repro_kernel_mvm_bwd, u.device,
            u.data_ptr(), w.data_ptr(), g.data_ptr(), v.data_ptr(),
            du.data_ptr(),
            workspace.data_ptr() if workspace is not None else None,
            n, m, d, s, KIND_CODES[kind], splits, lanes,
            second_pass=splits > 1)
    return du


def fused_operands(g: torch.Tensor, v: torch.Tensor) -> tuple:
    """``([g | v | 0], [v | g | 0])`` for the fused backward call: (n, s')
    each (with the lanes' leading axis, if any), s' = 2s padded with zero
    columns to a multiple of 8 (a zero column adds nothing to the Gram)."""
    s = g.shape[-1]
    gv = torch.zeros((*g.shape[:-1], _fused_width(s)), dtype=torch.float32,
                     device=g.device)
    vg = torch.zeros_like(gv)
    gv[..., :s], gv[..., s:2 * s] = g, v
    vg[..., :s], vg[..., s:2 * s] = v, g
    return gv, vg


def kernel_mvm_bwd_fused_cuda(u: torch.Tensor, g: torch.Tensor,
                              v: torch.Tensor,
                              kind: str = "matern32") -> torch.Tensor:
    """``du + dw`` of ``kappa(u, u) @ v`` for the output cotangent ``g``:
    one launch of the backward kernel on ``(u, u, [g | v], [v | g])`` per
    chunk of :func:`bwd_s_chunks` (``fused``: chunk k launches on
    ``[g_k | v_k]``, ``[v_k | g_k]``), the du's added. u (n, d), g and v
    (n, s) CUDA tensors, or all lane-stacked (B, ...): one launch per chunk
    for all lanes, the chunks splitting columns, never lanes; the checks of
    :func:`kernel_mvm_bwd_cuda`."""
    lanes = _check_inputs("kernel_mvm_bwd_fused_cuda", u=u, g=g, v=v)
    if g.shape != v.shape or g.shape[:-1] != u.shape[:-1]:
        raise ValueError(
            f"kernel_mvm_bwd_fused_cuda: shapes u{tuple(u.shape)} "
            f"g{tuple(g.shape)} v{tuple(v.shape)} do not match")
    (n, d), s = u.shape[-2:], g.shape[-1]
    _check_bwd(n, n, d, _fused_width(s), kind, lanes)
    if u.numel() == 0 or s == 0:
        return torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    du = None
    for lo, hi in bwd_s_chunks(d, s, fused=True):
        gv, vg = fused_operands(g[..., lo:hi], v[..., lo:hi])
        part = _bwd_launch(u, u, gv, vg, kind)
        du = part if du is None else du.add_(part)
    return du


def kernel_mvm_unit(u: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                    kind: str = "matern32") -> torch.Tensor:
    """kappa(u, w) @ v: the CUDA kernel for CUDA tensors, plain for CPU ones."""
    if u.device.type == "cpu":
        return kernel_mvm_plain(u, w, v, kind=kind)
    return kernel_mvm_cuda(u, w, v, kind=kind)


def kernel_mvm_bwd_unit(u: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                        v: torch.Tensor, kind: str = "matern32") -> torch.Tensor:
    """Cotangent of ``u``: the CUDA kernel for CUDA tensors, plain for CPU."""
    if u.device.type == "cpu":
        return kernel_mvm_bwd_plain(u, w, g, v, kind=kind)
    return kernel_mvm_bwd_cuda(u, w, g, v, kind=kind)


def kernel_mvm_bwd_fused_unit(u: torch.Tensor, g: torch.Tensor,
                              v: torch.Tensor,
                              kind: str = "matern32") -> torch.Tensor:
    """``du + dw`` of ``kappa(u, u) @ v`` in one call of the backward unit
    on ``(u, u, [g | v], [v | g])``: the CUDA kernel for CUDA tensors, the
    plain version for CPU ones."""
    if u.device.type == "cpu":
        return kernel_mvm_bwd_plain(u, u, torch.cat([g, v], dim=-1),
                                    torch.cat([v, g], dim=-1), kind=kind)
    return kernel_mvm_bwd_fused_cuda(u, g, v, kind=kind)


# The reference's Matérn-3/2 aliases of its two Pallas kernels, kept under
# their names: the same two kernels (plain versions on CPU tensors).
matern_mvm_pallas = partial(kernel_mvm_unit, kind="matern32")
matern_mvm_bwd_pallas = partial(kernel_mvm_bwd_unit, kind="matern32")
