"""torch-lint: stdlib-``ast`` static analysis for the port's invariants.

The port's own copy of ``repro.analysis``: five checkers, each encoding a
contract ``src/repro_torch`` depends on but Python cannot express:

* :mod:`repro_torch.analysis.trace_safety` — every device read inside the
  loops of ``solvers/``, ``core/``, ``gp/``, ``online/`` and ``lanes.py``
  (``.item()``, ``float()`` of a tensor, ``if`` on a tensor, ...) is
  flagged; the meant ones are the baseline (retargeted from the
  reference's ``jit`` rules).
* :mod:`repro_torch.analysis.config_discipline` — the static
  ``SolverConfig`` / per-lane ``SolverNumerics`` split stays intact.
* :mod:`repro_torch.analysis.freeze_mask` — the lane loops' state updates
  stay behind the freeze mask (retargeted to the port's host loops).
* :mod:`repro_torch.analysis.lock_discipline` — annotated shared
  attributes of the threaded serve/obs classes are only touched under
  their lock.
* :mod:`repro_torch.analysis.telemetry` — bounded metric label sets and
  documented ``emit()`` event schemas.

Run via ``python tools/torch_lint.py --check``; the suppression
(``# torch-lint: disable=<rule> -- <reason>``) and baseline contract lives
in :mod:`repro_torch.analysis.runner`. The package imports neither torch
nor jax, so it runs in a bare job.
"""
from repro_torch.analysis.common import ALL_RULES, Finding

__all__ = ["ALL_RULES", "Finding"]
