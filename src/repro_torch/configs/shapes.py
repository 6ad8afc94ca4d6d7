"""Assigned input-shape sets (the 4 LM shapes) + GP production shapes.

Port of ``repro.configs.shapes`` (the same names, fields and values).

``train_*``   run train_step  (fwd + bwd + Adam, microbatched)
``prefill_*`` run prefill_step (full-sequence forward, no grad)
``decode_*``/``long_*`` run serve_step (one token against a seq_len cache)
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str  # train | prefill | decode
    # Microbatch rows per device for the train step (grad accumulation).
    microbatch_rows: int = 2


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# Smoke-scale variants of the same steps (CPU, 1 device).
SMOKE_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 64, 2, "train", microbatch_rows=1),
    "prefill_32k": ShapeSpec("prefill_32k", 64, 2, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 64, 2, "decode"),
    "long_500k": ShapeSpec("long_500k", 128, 1, "decode"),
}


@dataclass(frozen=True)
class GPShapeSpec:
    """Production shapes for the paper's own 'architecture' (gp-iterative)."""

    name: str
    n: int  # training rows (divisible by 512 devices)
    d: int
    num_probes: int = 64
    solver_epochs: int = 10  # budget per outer step (paper §5 large-data)


GP_SHAPES = {
    # Shapes mirror the paper's large-data regime (3droad/buzz/houseelectric),
    # rounded to multiples of 512 * block for even row sharding.
    "gp_392k": GPShapeSpec("gp_392k", 391_168, 3),
    "gp_525k": GPShapeSpec("gp_525k", 524_288, 77),
    "gp_1m8": GPShapeSpec("gp_1m8", 1_843_200, 11),
}
