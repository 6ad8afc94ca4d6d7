"""Nothing under bench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program either. Top-level module names
(before the first dot) are compared whole, so ``repro_torch`` is not
``repro``."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FORBIDDEN_IN_REFERENCE = FORBIDDEN | {"repro_torch"}


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            tops |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_imports(path):
    reference = BENCH / "reference" in path.parents
    banned = FORBIDDEN_IN_REFERENCE if reference else FORBIDDEN
    assert not imported_tops(path) & banned


def test_the_comparison_is_by_whole_top_level_name(tmp_path):
    ok = tmp_path / "ok.py"
    ok.write_text("import repro_torch.core\nfrom repro_torch import lanes\n")
    bad = tmp_path / "bad.py"
    bad.write_text("import numpy\nfrom repro.core import fit\n")
    assert not imported_tops(ok) & FORBIDDEN
    assert imported_tops(ok) & FORBIDDEN_IN_REFERENCE == {"repro_torch"}
    assert imported_tops(bad) & FORBIDDEN == {"repro"}
