"""torch-lint gates, the twin of ``tests/test_repro_lint.py``: seeded
fixtures hit exact rules/lines, the suppression/baseline round-trip holds,
the live ``src/repro_torch`` tree stays clean, and the two retargeted rules
fire on the live solvers once their contract is broken (in a copy)."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))

from repro_torch.analysis import (config_discipline,  # noqa: E402
                                  freeze_mask, lock_discipline, runner,
                                  telemetry, trace_safety)
from repro_torch.analysis.common import load_baseline  # noqa: E402

FIXTURES = REPO / "tests" / "fixtures" / "torch_lint"
PORT = REPO / "src" / "repro_torch"


def _findings(checker, name):
    return checker.run([FIXTURES / name], REPO)


def _pairs(findings):
    return [(f.rule, f.line) for f in findings]


# -- each checker: bad fixture yields exact (rule, line), good is clean ------

def test_trace_safety_fixture():
    """The host-sync rule: a branch on a tensor, ``.item()``, ``float()`` of
    a tensor, ``torch.cuda.synchronize`` and a call to a function that
    reads, all inside a loop; the same read outside a loop (line 6) and
    host metadata are not findings."""
    assert _pairs(_findings(trace_safety, "bad_trace.py")) == [
        ("trace-python-branch", 14),
        ("trace-host-sync", 16),
        ("trace-host-sync", 17),
        ("trace-host-sync", 18),
        ("trace-host-sync", 19),
    ]
    assert _findings(trace_safety, "good_trace.py") == []


def test_config_discipline_fixture():
    assert _pairs(_findings(config_discipline, "bad_config.py")) == [
        ("config-static-array", 13),
        ("config-static-traced", 17),
        ("config-static-traced", 18),
        ("config-static-traced", 22),
    ]
    assert _findings(config_discipline, "good_config.py") == []


def test_freeze_mask_fixture():
    assert _pairs(_findings(freeze_mask, "bad_freeze.py")) == [
        ("freeze-mask", 18),   # a generator draw advances stopped lanes
        ("freeze-mask", 21),   # loop-carried residual not frozen
    ]
    assert _findings(freeze_mask, "good_freeze.py") == []


def test_lock_discipline_fixture():
    assert _pairs(_findings(lock_discipline, "bad_lock.py")) == [
        ("lock-discipline", 13),   # guarded attr touched without the lock
        ("lock-discipline", 19),   # *_locked helper called outside a lock
        ("lock-discipline", 31),   # foreign class reaches into guarded attr
    ]
    assert _findings(lock_discipline, "good_lock.py") == []


def test_telemetry_fixture():
    assert _pairs(_findings(telemetry, "bad_telemetry.py")) == [
        ("telemetry-label", 11),
        ("telemetry-label", 13),
        ("telemetry-event-schema", 14),
        ("telemetry-event-schema", 15),
    ]
    assert _findings(telemetry, "good_telemetry.py") == []


def test_findings_carry_hints():
    for f in _findings(freeze_mask, "bad_freeze.py"):
        assert f.hint  # every finding ships a fix hint
        assert "keep(" in f.hint
    for f in _findings(trace_safety, "bad_trace.py"):
        assert f.hint and "loop" in f.hint


# -- CLI: nonzero exit + rule/line in output per seeded fixture --------------

@pytest.mark.parametrize("fixture,subdir,expect", [
    ("bad_trace.py", "src/repro_torch/solvers", "[trace-host-sync]"),
    ("bad_config.py", "src/repro_torch/core", "[config-static-traced]"),
    ("bad_freeze.py", "src/repro_torch/solvers", "[freeze-mask]"),
    ("bad_lock.py", "src/repro_torch/serve", "[lock-discipline]"),
    ("bad_telemetry.py", "src/repro_torch/obs", "[telemetry-label]"),
])
def test_cli_fails_on_seeded_fixture(tmp_path, capsys, fixture, subdir,
                                     expect):
    dest = tmp_path / subdir
    dest.mkdir(parents=True)
    shutil.copy(FIXTURES / fixture, dest / fixture)
    assert runner.main(["--root", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert expect in out
    assert f"{subdir}/{fixture}:" in out


def test_cli_scans_top_level_lanes_module(tmp_path, capsys):
    """``lanes.py`` is a file in the scopes of both retargeted rules."""
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    shutil.copy(FIXTURES / "bad_freeze.py",
                tmp_path / "src" / "repro_torch" / "lanes.py")
    assert runner.main(["--root", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "src/repro_torch/lanes.py:21: [freeze-mask]" in out


# -- suppression / baseline round-trip ---------------------------------------

def _toy_repo(tmp_path, source):
    sol = tmp_path / "src" / "repro_torch" / "solvers"
    sol.mkdir(parents=True)
    (tmp_path / "src" / "repro_torch" / "analysis").mkdir()
    (sol / "toy.py").write_text(source)
    return sol / "toy.py"


_BAD = (FIXTURES / "bad_freeze.py").read_text() if FIXTURES.exists() else ""
_MARKED = "        res = (b - v).norm(dim=-1)"
_DRAW = "        noise = torch.randn("
_SUPPRESSED = _BAD.replace(
    _MARKED, "        # torch-lint: disable=freeze-mask -- toy keeps res live\n"
    + _MARKED).replace(
    _DRAW, "        # torch-lint: disable=freeze-mask -- toy draws per lane\n"
    + _DRAW)
_NO_REASON = _SUPPRESSED.replace(" -- toy keeps res live", "")


def test_suppression_baseline_round_trip(tmp_path, capsys):
    toy = _toy_repo(tmp_path, _SUPPRESSED)
    # Suppressed inline but not baselined: the ledger contract fails.
    assert runner.main(["--root", str(tmp_path)]) == 1
    assert "missing from" in capsys.readouterr().out
    # --update-baseline records the reviewed entry; the tree goes clean.
    assert runner.main(["--root", str(tmp_path), "--update-baseline"]) == 0
    assert runner.main(["--root", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "2 baselined suppression" in out
    # Dropping the inline comments revives the findings AND stales the entry.
    toy.write_text(_BAD)
    assert runner.main(["--root", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "[freeze-mask]" in out and "stale entry" in out


def test_suppression_requires_reason(tmp_path, capsys):
    _toy_repo(tmp_path, _NO_REASON)
    assert runner.main(["--root", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "has no reason" in out


def test_reference_marker_does_not_suppress(tmp_path, capsys):
    """The reference suite's ``repro-lint`` marker answers for nothing
    here: the two ledgers cannot be confused."""
    _toy_repo(tmp_path, _SUPPRESSED.replace("torch-lint:", "repro-lint:"))
    assert runner.main(["--root", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "[freeze-mask]" in out and "baselined" not in out


def test_baseline_entries_have_inline_comments():
    """Acceptance: every baseline entry maps to a live inline suppression."""
    findings = runner.collect_findings(REPO)
    _active, suppressed, errors = runner.partition(REPO, findings)
    assert errors == []
    assert runner.check_baseline(REPO, suppressed) == []
    live = {(f.rule, f.path) for f, _ in suppressed}
    for e in load_baseline(REPO / runner.BASELINE):
        assert (e["rule"], e["path"]) in live
        assert e["reason"].strip()


# -- the live tree -----------------------------------------------------------

def test_live_tree_clean(capsys):
    assert runner.main(["--root", str(REPO), "--check"]) == 0
    assert "clean" in capsys.readouterr().out


def test_refresh_lock_discipline_reports_nothing():
    """``OnlineGP`` keeps its ``#: guarded by self._lock`` contract: no
    finding on ``serve/refresh.py`` and nothing baselined there."""
    path = PORT / "serve" / "refresh.py"
    assert "guarded by self._lock" in path.read_text()
    assert lock_discipline.run([path], REPO) == []
    rel = "src/repro_torch/serve/refresh.py"
    assert not [e for e in load_baseline(REPO / runner.BASELINE)
                if e["path"] == rel]


def _scope_findings(checker):
    scopes = dict((c, dirs) for c, dirs in runner.CHECKER_SCOPES)
    from repro_torch.analysis.common import iter_py
    return checker.run(list(iter_py(REPO, scopes[checker])), REPO)


def test_stopping_reads_are_keep_going_call_sites():
    """Each solver's one stopping read per iteration is flagged where the
    loop calls ``keep_going``, not where ``keep_going`` reads (outside any
    loop), and is baselined with the stopping-read reason."""
    findings = _scope_findings(trace_safety)
    _, suppressed, _ = runner.partition(REPO, findings)
    reasons = {(f.path.rsplit("/", 1)[-1], f.line): (f.message, r)
               for f, r in suppressed}
    for name in ("cg.py", "ap.py", "sgd.py"):
        lines = (PORT / "solvers" / name).read_text().splitlines()
        site = next(i for i, t in enumerate(lines, 1)
                    if "= keep_going(" in t)
        message, reason = reasons[(name, site)]
        assert "`keep_going`" in message
        assert "stopping read" in reason
    base = PORT / "solvers" / "base.py"
    assert not [f for f in findings if f.path.endswith("solvers/base.py")
                and "keep_going" in base.read_text().splitlines()[
                    f.line - 1]]


# -- the retargeted rules fire on the live solvers once broken (a copy) ------

def _mutated(tmp_path, name, old, new):
    src = (PORT / "solvers" / name).read_text()
    assert old in src, old
    dest = tmp_path / "src" / "repro_torch" / "solvers"
    dest.mkdir(parents=True, exist_ok=True)
    (dest / name).write_text(src.replace(old, new, 1))
    return dest / name


@pytest.mark.parametrize("name,old,new", [
    ("cg.py", "v, r, d = keep(v_new, v), keep(r_new, r), keep(d_new, d)",
     "v, r, d = v_new, keep(r_new, r), keep(d_new, d)"),
    ("ap.py", "v, r = keep(v_new, v), keep(r_new, r)",
     "v, r = keep(v_new, v), r_new"),
    ("sgd.py", "v, m, r = keep(v_new, v), keep(m_new, m), keep(r_new, r)",
     "v, m, r = keep(v_new, v), m_new, keep(r_new, r)"),
])
def test_freeze_mask_fires_on_an_unfrozen_solver_write(tmp_path, name, old,
                                                      new):
    """Dropping one ``keep`` from a lane-stacked solver's update is a
    finding on that line; the unmutated solver has only its baselined
    generator draw (SGD) or nothing."""
    path = _mutated(tmp_path, name, old, new)
    line = next(i for i, t in enumerate(path.read_text().splitlines(), 1)
                if new in t)
    pairs = _pairs(freeze_mask.run([path], tmp_path))
    assert ("freeze-mask", line) in pairs
    live = _pairs(freeze_mask.run([PORT / "solvers" / name], REPO))
    assert len(pairs) == len(live) + 1


@pytest.mark.parametrize("name,anchor", [
    ("cg.py", "            hd = op.mvm(d)\n"),
    ("ap.py", "            ry, rz = residual_norms(r_new)\n"),
    ("sgd.py", "            steps += 1\n"),
])
def test_host_sync_fires_on_a_read_added_to_a_solver_loop(tmp_path, name,
                                                          anchor):
    """A ``.item()`` and a ``float()`` of the residual added to a solver's
    loop are two new findings, beside the ``keep_going`` call (scanned with
    ``base.py``, whose annotations type the residuals as tensors)."""
    indent = anchor[:len(anchor) - len(anchor.lstrip())]
    extra = (f"{indent}worst = res_y.max().item()\n"
             f"{indent}worst = worst + float(res_z.max())\n")
    path = _mutated(tmp_path, name, anchor, extra + anchor)
    shutil.copy(PORT / "solvers" / "base.py", path.parent / "base.py")
    found = trace_safety.run([path, path.parent / "base.py"], tmp_path)
    live = trace_safety.run([PORT / "solvers" / name,
                             PORT / "solvers" / "base.py"], REPO)
    assert len(found) == len(live) + 2
    lines = path.read_text().splitlines()
    added = [i for i, t in enumerate(lines, 1) if "worst = " in t]
    assert [(f.rule, f.line) for f in found if f.line in added] == [
        ("trace-host-sync", added[0]), ("trace-host-sync", added[1])]


def test_package_imports_without_torch_or_jax():
    """The suite is stdlib ``ast``: it imports and runs the live check with
    ``torch``, ``jax`` and ``repro`` blocked."""
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'torch', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import repro_torch.analysis\n"
            "from repro_torch.analysis import runner\n"
            f"rc = runner.main(['--root', {str(REPO)!r}, '--check'])\n"
            "assert not [k for k, v in sys.modules.items() if v is not None\n"
            "            and k.split('.')[0] in ('torch', 'jax', 'repro')]\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "torch-lint: clean" in proc.stdout


def test_cli_script_runs_from_the_checkout():
    proc = subprocess.run([sys.executable, str(REPO / "tools" /
                                               "torch_lint.py"), "--check"],
                          capture_output=True, text=True, timeout=120,
                          cwd=str(REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "torch-lint: clean" in proc.stdout
