"""Kernels the device ran per outer step in the traced segment: the trace's
kernel events (copies and fills left out) over the segment's steps."""


def read(ctx):
    if not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.traced.steps
