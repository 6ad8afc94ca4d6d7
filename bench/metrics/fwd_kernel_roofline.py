"""Forward kernel's share of its roofline, in %: the least time of the
forward products that the traced segment's steps needed, over the device
time of every launch of the forward kernel there (second passes and the
wide path included).

The products are counted from the algorithm and the cell's shapes, never
from launches, lane by lane, with each step's iterations as the solver
reported them (``fit`` history ``iters``): each solver's count, with the
solver lines it follows, is ``forward_products`` of its reference,
``bench/reference/solve_<name>.py``. t = 1 + probes is the width of [y |
probes]; the least time of one product is ``bench/yardstick.py::bound``.
"""
import re

from bench.reference import solver
from bench.yardstick import bound

PATTERNS = (r"kernel_mvm_fwd",)


def products(ctx) -> list:
    """[(count, n, m, d, s)] of the traced segment's forward products."""
    sh = ctx.shape
    return solver(sh.solver["name"]).forward_products(
        sh.n, sh.d, sh.t, sh.solver, sh.lanes * ctx.traced.steps,
        float(ctx.traced.history["iters"].sum()))


def least_s(ctx) -> float:
    return sum(count * bound(n, m, d, s)["bound_ms"] / 1e3
               for count, n, m, d, s in products(ctx))


def device_s(ctx) -> float:
    return sum((end - start) / 1e6 for name, start, end in ctx.trace.kernels
               if any(re.search(p, name) for p in PATTERNS))


def read(ctx):
    spent = device_s(ctx)
    if spent <= 0.0:
        return None
    return 100.0 * least_s(ctx) / spent
