"""Share of an outer-step segment's wall time in which no operation ran on
the device, in %: 1 - (union of the traced segment's device intervals /
the mean wall time of the window's untraced segments, the same work). The
traced segment's own wall carries the trace's cost on the host (~35 us a
launch), which the driver's idle share from ``busy_s`` / ``window_s``
keeps."""


def read(ctx):
    if ctx.segment_s <= 0.0 or ctx.trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.segment_s)
