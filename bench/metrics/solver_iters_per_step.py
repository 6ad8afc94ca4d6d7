"""Solver iterations per outer step and lane (``fit`` history ``iters``),
averaged over the window's steps and lanes."""


def read(ctx):
    iters = ctx.window["iters"]
    return float(iters.mean()) if iters.size else None
