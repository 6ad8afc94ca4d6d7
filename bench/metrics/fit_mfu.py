"""The whole step's share of the chip's peak, in %: the summed least time
of every kernel product that a segment's steps needed (the forward and
backward counts of ``fwd_kernel_roofline`` and ``bwd_kernel_roofline``, at
the published peaks), over the mean wall time of the window's untraced
segments. A kernel taken off the path leaves its roofline silent; this
share still counts its work."""


def read(ctx):
    least = sum(ctx.metric(name).least_s(ctx)
                for name in ("fwd_kernel_roofline", "bwd_kernel_roofline"))
    if ctx.segment_s <= 0.0 or least <= 0.0:
        return None
    return 100.0 * least / ctx.segment_s
