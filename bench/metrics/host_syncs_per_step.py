"""The solver's reads of its stopping rule per outer step (``fit``
history ``host_syncs``, one count per lane-stacked step), averaged over
the window's steps."""


def read(ctx):
    syncs = ctx.window["host_syncs"][:, 0, 0]
    return float(syncs.mean()) if syncs.size else None
