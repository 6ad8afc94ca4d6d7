"""The outer loop's own host time per lane-stacked outer step, in ms: the
untraced segments' self time (duration less child spans) of ``fit.round``,
``step``, ``step.targets``, ``step.adam`` and ``fit.readback``, over their
``step`` spans; the solve, the gradient and the round's synchronise are
left out (``bench/spans.py``)."""
from bench.spans import OUTER


def read(ctx):
    spans = getattr(ctx, "spans", None)
    if spans is None or not spans.steps:
        return None
    return sum(spans.self_ns.get(n, 0) for n in OUTER) / 1e6 / spans.steps
