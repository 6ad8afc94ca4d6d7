"""Forward distance-tile kernel MVM: the CUDA kernel and its plain version.

Computes ``out[i] = sum_j kappa(||u_i - w_j||^2) v_j`` on pre-scaled inputs
``u`` (n, d), ``w`` (m, d) and ``v`` (m, s), fp32, without materialising K.
It replaces the TPU kernel ``kernel_mvm_pallas`` of the reference
(``src/repro/kernels/tiled.py:98``); the design and its bound on an H100 are
described at the top of ``csrc/kernel_mvm.cu``.

* :func:`kernel_mvm_cuda` launches the hand-written kernel on CUDA tensors
  (and raises on anything else). It counts its launches in :data:`LAUNCHES`.
* :func:`kernel_mvm_plain` is the same function in plain tiled PyTorch,
  with ``r2`` by direct differences as in the kernel.
* :func:`kernel_mvm_unit` picks between them by the device of its inputs:
  the plain version for CPU tensors, the kernel for CUDA tensors. There is
  no fallback from one to the other.

The kernel is built from ``csrc/kernel_mvm.cu`` at first use with ``nvcc``
(``sm_90a``) into ``build/repro_torch_kernels/`` of the checkout, as a shared
library with a plain C interface loaded through ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.registry import KIND_CODES, get_kernel

KERNEL_NAME = "kernel_mvm_fwd"
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "kernel_mvm.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Launches of each kernel wrapper since the last reset (chip_smoke.py reads
# them to show the main path went through the kernels).
LAUNCHES = {KERNEL_NAME: 0}

# Shared-memory geometry of csrc/kernel_mvm.cu (BM = BN = 64, KS = BN + 16,
# SC = 16 * TS with TS <= 8), for rejecting shapes before the launch.
_BM, _BN, _KS, _MAX_TS = 64, 64, 80, 8
_MAX_SMEM_BYTES = 232_448

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    """A copy of the launch counts since the last reset."""
    return dict(LAUNCHES)


# -- plain version ----------------------------------------------------------


def kernel_mvm_plain(u: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                     kind: str = "matern32", bm: int = 512,
                     bn: int = 512) -> torch.Tensor:
    """kappa(u, w) @ v in plain tiled PyTorch: (n,d),(m,d),(m,s) -> (n,s).

    Same arithmetic as the kernel: ``r2`` by direct differences (exact zero
    at coincident points), the registry profile, an accumulation over column
    tiles. Works on any device and dtype, and under autograd.
    """
    kappa = get_kernel(kind).kappa_from_r2
    n, m, s = u.shape[0], w.shape[0], v.shape[1]
    dtype = torch.result_type(u, v)
    rows = []
    for i in range(0, n, bm):
        ui = u[i:i + bm]
        acc = torch.zeros((ui.shape[0], s), dtype=dtype, device=u.device)
        for j in range(0, m, bn):
            diff = ui[:, None, :] - w[None, j:j + bn, :]
            acc = acc + kappa(torch.sum(diff * diff, dim=-1)) @ v[j:j + bn]
        rows.append(acc)
    if not rows:
        return torch.zeros((0, s), dtype=dtype, device=u.device)
    return torch.cat(rows)


# -- build and bind -----------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")


def build_kernels() -> Path:
    """Compile ``csrc/kernel_mvm.cu`` for sm_90a (once per source content).

    Returns the path of the shared library; nvcc's ``-Xptxas -v`` report
    (registers, shared memory, spills per instantiation) is kept beside it
    as ``<library>.ptxas.txt``.
    """
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libkernel_mvm_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        Path(f"{out}.ptxas.txt").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_kernels()))
            fn = lib.repro_kernel_mvm_fwd
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


# -- wrappers -----------------------------------------------------------------


def _smem_bytes(d: int, s: int) -> int:
    ts = min(_MAX_TS, -(-s // 16))
    return 4 * (_BM * d + d * _BN + _BN * 16 * ts + _BM * _KS)


def kernel_mvm_cuda(u: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                    kind: str = "matern32") -> torch.Tensor:
    """Launch the forward tile kernel on CUDA tensors; (n, s) fp32 result.

    Raises on inputs that require grad (forward only), on tensors that are
    not fp32, contiguous, 2-D CUDA tensors of one device, on mismatched
    shapes and on an unknown kind.
    """
    if u.requires_grad or w.requires_grad or v.requires_grad:
        raise RuntimeError(
            "kernel_mvm_cuda is forward-only: its inputs must not require "
            "grad (differentiate solvers.operator.kernel_mvm_tiled instead)")
    for name, t in (("u", u), ("w", w), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"kernel_mvm_cuda: {name} is on {t.device}, "
                             "not a CUDA device")
        if t.device != u.device:
            raise ValueError("kernel_mvm_cuda: inputs on different devices")
        if t.dtype != torch.float32:
            raise TypeError(f"kernel_mvm_cuda: {name} is {t.dtype}, not fp32")
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"kernel_mvm_cuda: {name} must be 2-D and "
                             "contiguous")
    (n, d), (m, dw), (mv, s) = u.shape, w.shape, v.shape
    if d != dw or m != mv:
        raise ValueError(f"kernel_mvm_cuda: shapes u{tuple(u.shape)} "
                         f"w{tuple(w.shape)} v{tuple(v.shape)} do not match")
    if kind not in KIND_CODES:
        raise ValueError(f"kernel_mvm_cuda: no CUDA profile for {kind!r}")
    if d == 0 or _smem_bytes(d, s) > _MAX_SMEM_BYTES:
        raise ValueError(f"kernel_mvm_cuda: d={d} outside the kernel's range")
    if max(n, m, s) >= 2**31:
        raise ValueError("kernel_mvm_cuda: dimension exceeds int32")
    out = torch.empty((n, s), dtype=torch.float32, device=u.device)
    if n == 0 or s == 0:
        return out
    lib = _library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = lib.repro_kernel_mvm_fwd(
            u.data_ptr(), w.data_ptr(), v.data_ptr(), out.data_ptr(),
            n, m, d, s, KIND_CODES[kind], stream)
    if rc != 0:
        msg = (lib.repro_cuda_error_string(rc).decode() if rc > 0
               else "rejected arguments")
        raise RuntimeError(f"kernel_mvm_fwd launch failed ({rc}): {msg}")
    LAUNCHES[KERNEL_NAME] += 1
    return out


def kernel_mvm_unit(u: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                    kind: str = "matern32") -> torch.Tensor:
    """kappa(u, w) @ v: the CUDA kernel for CUDA tensors, plain for CPU ones."""
    if u.device.type == "cpu":
        return kernel_mvm_plain(u, w, v, kind=kind)
    return kernel_mvm_cuda(u, w, v, kind=kind)
