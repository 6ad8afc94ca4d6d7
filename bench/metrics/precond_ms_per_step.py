"""Host time of the solver's set-up per lane-stacked outer step, in ms:
the untraced segments' ``solve.precond`` spans (CG's pivoted-Cholesky
preconditioner, AP's block Cholesky factors), summed, over their ``step``
spans (``bench/spans.py``)."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    if spans is None or not spans.steps or "solve.precond" not in spans.count:
        return None
    return spans.total_ns["solve.precond"] / 1e6 / spans.steps
