"""torch-lint CLI: static analysis of the PyTorch port's invariants.

Thin wrapper, the twin of ``tools/repro_lint.py``, so the suite runs from a
checkout without installing the package: puts ``src`` on ``sys.path`` and
delegates to :mod:`repro_torch.analysis.runner`. Stdlib-only — neither
torch nor jax is imported — so it runs in a bare job.

Usage::

    python tools/torch_lint.py --check            # exit 1 on findings
    python tools/torch_lint.py --verbose          # also list the baseline
    python tools/torch_lint.py --update-baseline  # refresh the ledger
"""
from __future__ import annotations

import sys
from pathlib import Path

_REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_REPO / "src"))

from repro_torch.analysis.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] + ([] if any(
        a.startswith("--root") for a in sys.argv[1:])
        else ["--root", str(_REPO)])))
