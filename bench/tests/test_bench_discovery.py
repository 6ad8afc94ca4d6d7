"""The harness finds cells, configurations and metrics by name, every
per-layer metric moves an end-to-end metric its cells report, and a run
without a card fails without a result."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import core  # noqa: E402


def test_new_files_join_by_name_without_editing_any(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
              if p.is_file()}
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    config = json.loads((tmp_path / "bench/configs/protein.json").read_text())
    config["name"] = "protein_b"
    (tmp_path / "bench/configs/protein_b.json").write_text(json.dumps(config))
    traffic = json.loads(
        (tmp_path / "bench/workloads/protein.cg-tol.json").read_text())
    traffic.update(name="protein_b.cg-tol-b", traffic="cg-tol-b")
    (tmp_path / "bench/workloads/protein_b.cg-tol-b.json").write_text(
        json.dumps(traffic))
    (tmp_path / "bench/metrics/steps_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.traced.steps)\n")
    spec["configs"].append({**spec["configs"][0], "name": "protein_b",
                            "file": "bench/configs/protein_b.json"})
    spec["workloads"].append({"name": "protein_b.cg-tol-b", "config":
                              "protein_b", "traffic": "cg-tol-b", "chips": 1,
                              "why": "a cell added as data"})
    spec["per_layer"].append({"name": "steps_seen", "unit": "steps",
                              "better": "higher", "source": "program_counter",
                              "layer": "outer loop", "moves": "step_s",
                              "workloads": ["protein_b.cg-tol-b"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    plan = core.plan_cell(core.load_spec(tmp_path), "protein_b.cg-tol-b",
                          tmp_path)
    assert plan.config["name"] == "protein_b"
    assert plan.traffic["traffic"] == "cg-tol-b"
    assert "steps_seen" in plan.per_layer
    assert "step_s" in plan.end_to_end and "setup_s" in plan.end_to_end
    ctx = type("Ctx", (), {"traced": type("T", (), {"steps": 7})})
    assert core.load_metric(tmp_path, "steps_seen").read(ctx) == 7.0
    old = core.plan_cell(core.load_spec(tmp_path), "protein.cg-tol", tmp_path)
    assert "steps_seen" not in old.per_layer
    assert all(p.read_bytes() == b for p, b in before.items())


SPEC = core.load_spec(ROOT)


def test_a_configuration_the_reference_cannot_compute_is_refused(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    path = tmp_path / "bench/configs/protein.json"
    config = json.loads(path.read_text())
    path.write_text(json.dumps({**config, "kernel": "rbf"}))
    with pytest.raises(ValueError, match="Matérn-3/2"):
        core.plan_cell(core.load_spec(tmp_path), "protein.cg-tol", tmp_path)


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_every_moves_names_a_metric_its_cells_report(metric):
    cells = metric.get("workloads", [c["name"] for c in SPEC["workloads"]])
    assert cells
    e2e = core.named(SPEC["end_to_end"], metric["moves"])
    for cell in cells:
        core.named(SPEC["workloads"], cell)
        assert core.reports(e2e, cell), (metric["name"], cell)
        assert (ROOT / "bench/metrics" / f"{metric['name']}.py").exists()


@pytest.mark.parametrize("cell", [c["name"] for c in SPEC["workloads"]])
def test_every_cell_has_its_files_and_reports_enough(cell):
    plan = core.plan_cell(SPEC, cell)
    assert "setup_s" in plan.end_to_end and len(plan.end_to_end) >= 2
    assert plan.per_layer
    assert (ROOT / core.named(SPEC["configs"], plan.cell["config"])["file"]).exists()


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    cell = SPEC["workloads"][0]["name"]
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench/run.py"), "--workload", cell,
         "--seed", "2147483649", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "metrics" not in proc.stdout and "{" not in proc.stdout
