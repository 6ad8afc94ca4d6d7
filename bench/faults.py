"""Faults planted in the program under a run, to show that the judge
catches each one a cell can have (the tests and ``bench/calibrate.py``).

* ``unchanged``: a step returns its state unchanged, its count advanced;
* ``half_batch``: the gradient is estimated from half of the probes, the
  mean taken over the rest;
* ``answer``: the solve's answer is altered where it is produced (the mean
  system's solution halved).

The cells run on one card, so the exchange between cards has no fault.
"""
from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "answer")


@contextlib.contextmanager
def plant(fault: str):
    """Run the block with ``fault`` planted in ``repro_torch.core.outer``."""
    from repro_torch.core import outer

    name = {"unchanged": "_outer_step_lanes", "half_batch": "mll_grad_estimate",
            "answer": "solve"}[fault]
    original = getattr(outer, name)

    def unchanged(states, *args, **kwargs):
        _, metrics = original(states, *args, **kwargs)
        return states._replace(step=states.step + 1), metrics

    def half_batch(x, y, params, v, targets, *args, **kwargs):
        keep = 1 + (v.shape[-1] - 1) // 2
        return original(x, y, params, v[..., :keep], targets[..., :keep],
                        *args, **kwargs)

    def answer(*args, **kwargs):
        res = original(*args, **kwargs)
        v = res.v.clone()
        v[..., 0] *= 0.5
        return res._replace(v=v)

    setattr(outer, name, {"unchanged": unchanged, "half_batch": half_batch,
                          "answer": answer}[fault])
    try:
        yield
    finally:
        setattr(outer, name, original)
