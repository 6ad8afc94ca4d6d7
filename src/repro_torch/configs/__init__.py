"""Architecture registry of the port: ``--arch <id>`` resolves here.

Port of ``repro.configs``: the 10 assigned LM-family architectures + the
paper's own gp-iterative, with the same names and order. Each LM module
exposes CONFIG (exact published spec) and SMOKE (reduced same-family
variant for CPU tests); modules are imported at first use.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.shapes import (
    GP_SHAPES,
    LM_SHAPES,
    SMOKE_SHAPES,
    GPShapeSpec,
    ShapeSpec,
)

_MODULES = {
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "gp-iterative": "repro_torch.configs.gp_iterative",
}

LM_ARCHS = tuple(k for k in _MODULES if k != "gp-iterative")
ALL_ARCHS = tuple(_MODULES)


def get_config(name: str, smoke: bool = False):
    """The arch's CONFIG (or SMOKE); ``KeyError`` for an unknown name."""
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[name])
    return mod.SMOKE if smoke else mod.CONFIG


def runnable_cells(include_skips: bool = False):
    """All (arch, shape) cells. long_500k only runs for archs with a
    sub-quadratic path (the reference's skip rule); encoder-only archs would
    skip decode shapes (none in this pool — whisper has a decoder)."""
    cells = []
    for arch in LM_ARCHS:
        cfg = get_config(arch)
        for shape in LM_SHAPES.values():
            skip = shape.name == "long_500k" and not cfg.has_subquadratic_path
            if skip and not include_skips:
                continue
            cells.append((arch, shape.name, "skip" if skip else "run"))
    for shape in GP_SHAPES.values():
        cells.append(("gp-iterative", shape.name, "run"))
    return cells


__all__ = [
    "ALL_ARCHS", "LM_ARCHS", "GP_SHAPES", "LM_SHAPES", "SMOKE_SHAPES",
    "GPShapeSpec", "ShapeSpec", "get_config", "runnable_cells",
]
