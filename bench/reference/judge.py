"""Judging one marginal-likelihood step, and the reference in the program's
place (the control).

A step takes a state ``{raw, mu, nu, step, v}`` (raw hyperparameter
leaves, Adam's moments and count, the warm-start carry) to the next. The
judge reads the state before the step and the state after it, works out
the step's targets, system and gradient again from the inputs and the
hyperparameters before the step, and gives:

* ``grad_gap``: the gradient as Adam received it (from its first moments
  before and after: ``g = -(mu' - b1 mu) / (1 - b1)``, the ascent's sign
  undone) against the reference's gradient at the step's solutions;
* ``param_gap``: the hyperparameters after the step against the
  reference's Adam step with the reference's gradient;
* with ``residual=True``: the true residuals of the step's solutions over
  the real rows: ``res`` (the larger of the mean system's and the probes'
  mean relative residual, the solver's own stopping measure) and
  ``res_norm`` (|B - H V|_F / |B|_F);
* with ``excess=True``: ``res_excess``, the step's Frobenius residual over
  that of the reference's own solve from the same warm start under the
  same budget (its tracked residual), minus 1, and ``solve_gap``,
  |V - V_ref|_F / |V_ref|_F against that solve's solutions.

A gap is taken leaf by leaf (lengthscales, signal, noise): the norm of the
difference over the larger of the reference leaf's norm and the median
leaf's, and the worst leaf is reported.
"""
from __future__ import annotations

import statistics

import torch

from bench.reference import gp, solver

ADAM_B1 = 0.9


def leaf_gap(got: list, want: list) -> float:
    """Worst leaf of |got - want| / max(|want|, median leaf |want|)."""
    norms = [float(torch.linalg.vector_norm(w.double())) for w in want]
    floor = statistics.median(norms)
    return max(float(torch.linalg.vector_norm(g.double() - w.double()))
               / max(nw, floor, 1e-30)
               for g, w, nw in zip(got, want, norms))


def solve(ar: gp.Arith, prob: dict, b: torch.Tensor, v0, raw: list):
    """The cell's solver on ``H V = b`` from ``v0``; (V, iterations,
    residual)."""
    s = prob["solver"]
    return solver(s["name"]).solve(ar, prob["x"], b, v0, raw, s)


def judge_step(prob: dict, draws: dict, pre: dict, post: dict,
               residual: bool = False, excess: bool = False) -> dict:
    """Readings of the step ``pre`` -> ``post`` (see the module doc), in
    float32 with TF32 off."""
    ar = gp.Arith(lower=False)
    x, rows = prob["x"], prob["n_real"]
    out = {}
    with ar.flags(), torch.no_grad():
        raw = pre["raw"]
        g_ref = gp.grad(ar, x, post["v"], raw, rows)
        g_got = [-(m1.double() - ADAM_B1 * m0.double()) / (1.0 - ADAM_B1)
                 for m0, m1 in zip(pre["mu"], post["mu"])]
        out["grad_gap"] = leaf_gap(g_got, g_ref)
        new_raw = gp.adam(raw, pre["mu"], pre["nu"], pre["step"], g_ref,
                          prob["adam_lr"])[0]
        change = [n - r for n, r in zip(new_raw, raw)]
        out["param_gap"] = leaf_gap(
            [p - r for p, r in zip(post["raw"], raw)], change)
        if residual or excess:
            b = gp.targets(ar, x, prob["y"], draws, raw)
            cols, out["res_norm"] = gp.residuals(ar, x, b, post["v"], raw,
                                                 rows)
            out["res"] = float(max(cols[0], torch.mean(cols[1:])))
        if excess:
            v_ref, _, r_ref = solve(ar, prob, b, pre["v"], raw)
            out["res_excess"] = out["res_norm"] / float(
                torch.linalg.vector_norm(r_ref[:rows].double())
                / torch.linalg.vector_norm(b[:rows].double())) - 1.0
            out["solve_gap"] = float(
                torch.linalg.vector_norm((post["v"] - v_ref)[:rows].double())
                / torch.linalg.vector_norm(v_ref[:rows].double()))
    return out


def reference_step(ar: gp.Arith, prob: dict, draws: dict,
                   state: dict) -> dict:
    """One step of the reference in the program's place: targets, the
    cell's solve warm-started from the carry, the pathwise gradient, Adam."""
    with ar.flags(), torch.no_grad():
        raw = state["raw"]
        b = gp.targets(ar, prob["x"], prob["y"], draws, raw)
        v, _, _ = solve(ar, prob, b, state["v"], raw)
        g = gp.grad(ar, prob["x"], v, raw, prob["n_real"])
        new_raw, mu, nu = gp.adam(raw, state["mu"], state["nu"],
                                  state["step"], g, prob["adam_lr"])
    return {"raw": new_raw, "mu": mu, "nu": nu, "step": state["step"] + 1,
            "v": v}
