"""Device time of the gradient per lane-stacked outer step, in ms: every
kernel of the traced segment launched inside a ``step.grad`` span
(``core/gradients.py::mll_grad_estimate``: its forward product and the
fused backward), over the segment's ``step`` spans (``bench/spans.py``)."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    if spans is None or not spans.traced_steps:
        return None
    spent = spans.device_ns.get("step.grad", 0)
    return spent / 1e6 / spans.traced_steps if spent > 0 else None
