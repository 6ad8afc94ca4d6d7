"""The reference's documentation gate, applied to the port: every public
module, class, function and method of the port's counterparts of
``tools/docs_lint.py``'s ``LINT_PACKAGES`` carries a docstring (the tool's
own ``missing_docstrings``, unedited)."""
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import docs_lint  # noqa: E402

PORT_PACKAGES = [pkg.replace("src/repro/", "src/repro_torch/")
                 for pkg in docs_lint.LINT_PACKAGES]


def test_port_packages_mirror_the_gated_ones():
    assert PORT_PACKAGES == [f"src/repro_torch/{p}" for p in
                             ("solvers", "core", "serve", "online", "obs",
                              "analysis")]


@pytest.mark.parametrize("pkg", PORT_PACKAGES)
def test_port_public_api_has_docstrings(pkg):
    files = sorted((REPO / pkg).rglob("*.py"))
    assert files, pkg
    findings = [f for py in files for f in docs_lint.missing_docstrings(py)]
    assert findings == [], "\n".join(findings)
