"""Gradient compression with error feedback; port of
``repro.distributed.compression``.

bf16 compression halves the gradient-exchange volume of a data-parallel
all-reduce. Error feedback keeps the optimiser unbiased over time: the
quantisation residual of step t is added back into the gradient at t+1
(Seide et al. / Karimireddy et al.):

    g_c, state = compress(grads, state)     # bf16 + carried residual
    ... the exchange happens in g_c's dtype ...
    adam_update(decompress(g_c), ...)

The GP path does not use it (its gradient is d + 2 scalars); it exists for
the LM substrate. Trees are NamedTuples, tuples, lists and dicts of
tensors (:func:`repro_torch.lanes.tree_map`).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.lanes import tree_map


class EFState(NamedTuple):
    residual: Any  # fp32 tree, same structure as the gradients


def ef_init(params: Any) -> EFState:
    """Zero fp32 residuals shaped like ``params``' leaves."""
    return EFState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def compress(grads: Any, state: EFState, dtype=torch.bfloat16):
    """(compressed_grads, new_state): quantisation to ``dtype`` (bf16,
    round to nearest even) with error feedback."""
    corrected = tree_map(lambda g, r: g.to(torch.float32) + r, grads,
                         state.residual)
    q = tree_map(lambda c: c.to(dtype), corrected)
    residual = tree_map(lambda c, qc: c - qc.to(torch.float32), corrected, q)
    return q, EFState(residual=residual)


def decompress(grads_c: Any) -> Any:
    return tree_map(lambda g: g.to(torch.float32), grads_c)
