"""Backward kernel's share of its roofline, in %: the least time of the
backward products that the traced segment's steps needed, over the device
time of every launch of the backward kernel there.

``src/repro_torch/core/gradients.py::mll_grad_estimate`` differentiates
``S = sum_t c_t a_t^T H b_t`` once per step: one backward product per step
and lane over all n x n pairs, at the pathwise estimator's Gram width t =
1 + probes (a = b = V, so the Gram ``sum_t c_t v_it v_jt`` is symmetric
and one sweep serves du and dw). It reads the scaled inputs (n x d) and V
(n x t) once and writes du (n x d) once; the least time is
``bench/yardstick.py::bound_bwd``.
"""
import re

from bench.yardstick import bound_bwd

PATTERNS = (r"kernel_mvm_bwd",)


def products(ctx) -> list:
    """[(count, n, d, gram width, bytes)] of the traced segment."""
    sh = ctx.shape
    nbytes = 4 * (2 * sh.n * sh.d + sh.n * sh.t)
    return [(sh.lanes * ctx.traced.steps, sh.n, sh.d, sh.t, nbytes)]


def least_s(ctx) -> float:
    return sum(count * bound_bwd(n, n, d, s, nbytes)["bound_ms"] / 1e3
               for count, n, d, s, nbytes in products(ctx))


def device_s(ctx) -> float:
    return sum((end - start) / 1e6 for name, start, end in ctx.trace.kernels
               if any(re.search(p, name) for p in PATTERNS))


def read(ctx):
    spent = device_s(ctx)
    if spent <= 0.0:
        return None
    return 100.0 * least_s(ctx) / spent
