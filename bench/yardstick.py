"""The chip's published peaks and the least time of each kernel's work.

``bound`` and ``bound_bwd`` are copied from ``chip_smoke.py`` (the port's
card check), frozen here so that a change to the program cannot move the
yardstick.
"""
from __future__ import annotations

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12


def bound(n: int, m: int, d: int, s: int) -> dict:
    """Least time for one forward call, as the kernel splits the work:
    2nmd + nm operations (r2 and the profile) at the fp32 CUDA-core peak,
    3 * 2nms (kappa @ V in 3xTF32) at the TF32 tensor-core peak, and each
    input read once and the output written once at the HBM rate; the
    largest of the three. ``bound_fp32_ms`` is the all-fp32 bound of the
    earlier design (2nm(d+s) + nm operations on the CUDA cores), kept so
    shares stay comparable."""
    cuda_ops = 2 * n * m * d + n * m
    tc_ops = 3 * 2 * n * m * s
    nbytes = 4 * (n * d + m * d + m * s + n * s)
    times = {"cuda_cores": cuda_ops / PEAK_FP32_FLOPS * 1e3,
             "tensor_cores": tc_ops / PEAK_TF32_FLOPS * 1e3,
             "bytes": nbytes / PEAK_HBM_BYTES * 1e3}
    unit = max(times, key=times.get)
    fp32_ops = 2 * n * m * (d + s) + n * m
    return {"ops_cuda_cores": cuda_ops, "ops_tensor_cores": tc_ops,
            "bytes": nbytes, "bound_ms": times[unit],
            "bound_by": "bytes" if unit == "bytes" else "operations",
            "bound_unit": unit,
            "bound_fp32_ms": max(fp32_ops / PEAK_FP32_FLOPS * 1e3,
                                 times["bytes"])}


def bound_bwd(n: int, m: int, d: int, s: int, nbytes: int) -> dict:
    """Least time for one backward call at Gram width s, as the kernel
    splits the work: 2nmd (r2) + 2nmd (contraction with the differences)
    + 3nm (slope, product, row sum) operations at the fp32 CUDA-core peak,
    3 * 2nms (g v^T in 3xTF32) at the TF32 tensor-core peak, and ``nbytes``
    (each input read once, du written once) at the HBM rate; the largest
    of the three. ``bound_fp32_ms`` is the all-fp32 bound of the earlier
    design (4nmd + 2nms + 3nm operations on the CUDA cores)."""
    cuda_ops = 4 * n * m * d + 3 * n * m
    tc_ops = 3 * 2 * n * m * s
    times = {"cuda_cores": cuda_ops / PEAK_FP32_FLOPS * 1e3,
             "tensor_cores": tc_ops / PEAK_TF32_FLOPS * 1e3,
             "bytes": nbytes / PEAK_HBM_BYTES * 1e3}
    unit = max(times, key=times.get)
    fp32_ops = cuda_ops + 2 * n * m * s
    return {"ops_cuda_cores": cuda_ops, "ops_tensor_cores": tc_ops,
            "bytes": nbytes, "bound_ms": times[unit],
            "bound_by": "bytes" if unit == "bytes" else "operations",
            "bound_unit": unit,
            "bound_fp32_ms": max(fp32_ops / PEAK_FP32_FLOPS * 1e3,
                                 times["bytes"])}
