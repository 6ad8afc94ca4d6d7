"""Host time to issue one solver iteration, in us: the untraced segments'
``solve.iter`` spans (an iteration's launches; the stopping read before
each is its sibling, not inside it), their durations summed, over their
count (``bench/spans.py``)."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    iters = spans.count.get("solve.iter", 0) if spans is not None else 0
    if not iters:
        return None
    return spans.total_ns["solve.iter"] / 1e3 / iters
