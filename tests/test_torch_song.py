"""The song configuration (UCI YearPredictionMSD, 463 811 x 90) on the CPU:
the port's plain path against the benchmark's plain reference
(``bench/reference``) at d = 90, on inputs made by ``bench/data.py`` from a
seed, with the rows cut to a few hundred; the song cell's files; the loop
each of the cell's kernel calls takes; and one whole run of
``song.ap-budget`` at a cut size, judged correct.

The lengthscales start near the cell's sqrt(90), where the Matérn-3/2
kernel between z-scored rows is ~0.3: a dense system, as the cell solves.
"""
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import core, data  # noqa: E402
from bench.reference import gp, solver  # noqa: E402
from repro_torch.core.estimators import ProbeState, build_system_targets  # noqa: E402
from repro_torch.core.gradients import mll_grad_estimate  # noqa: E402
from repro_torch.data.synthetic import UCI_SHAPES, pad_to_block_multiple  # noqa: E402
from repro_torch.gp.hyperparams import HyperParams  # noqa: E402
from repro_torch.gp.rff import RFFState  # noqa: E402
from repro_torch.kernels import tiled  # noqa: E402
from repro_torch.solvers import HOperator, SolverConfig  # noqa: E402
from repro_torch.solvers.ap import solve_ap  # noqa: E402

CELL = "song.ap-budget"
N, D, S, PAIRS = 450, 90, 8, 1000
BLOCK = 100
SEED = 2**31 + 91


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread beside the other workers of a parallel run
    (restored after)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problem():
    """Seeded song-shaped inputs padded with phantom rows to AP's block
    (450 real rows, 50 phantom), 90 lengthscales spread around sqrt(90)."""
    gen = torch.Generator().manual_seed(SEED)
    x, y = data.make_data(gen, N, D, "cpu")
    x, y, n_real = pad_to_block_multiple(x, y, BLOCK)
    draws = data.make_draws(gen, x.shape[0], D, S, PAIRS, "cpu")
    ell = math.sqrt(D) * torch.linspace(0.8, 1.25, D)
    raw = [torch.log(torch.expm1(ell)), torch.tensor(0.4), torch.tensor(-0.2)]
    params = HyperParams(*raw, kernel="matern32")
    probes = ProbeState("pathwise", None,
                        RFFState(draws["z"], draws["u"], draws["w"],
                                 "matern32"), draws["w_eps"])
    op = HOperator(x=x, params=params, backend="cuda")
    return x, y, n_real, draws, raw, params, probes, op


def test_the_configuration_is_song_at_its_published_size():
    spec = core.load_spec(ROOT)
    plan = core.plan_cell(spec, CELL, ROOT)
    cfg, tr = plan.config, plan.traffic
    assert (cfg["n"], cfg["d"]) == UCI_SHAPES["song"] == (463_811, 90)
    assert core.named(spec["configs"], "song")["reduced"] == []
    assert cfg["init"]["lengthscale"] == pytest.approx(math.sqrt(90), abs=1e-4)
    # 3droad.ap-budget's traffic at song's (n, d): only its name and why differ
    other = core.load_json(ROOT, "workloads", "3droad.ap-budget")
    same = {k for k in tr if k not in ("name", "why", "limits")}
    assert {k: tr[k] for k in same} == {k: other[k] for k in same}
    # 464 blocks of 1000 rows, 189 of them phantom rows in the last block
    assert -(-cfg["n"] // tr["solver"]["block_size"]) == 464
    assert (-cfg["n"]) % tr["solver"]["block_size"] == 189
    assert {"step_s", "setup_s"} <= set(plan.end_to_end)
    assert "fwd_kernel_roofline" in plan.per_layer
    assert "bwd_kernel_roofline" in plan.per_layer


def test_the_start_makes_a_dense_system_where_one_would_not():
    """The configuration's note under ``assumed``: between z-scored rows
    at d = 90, the Matérn-3/2 kernel is ~2e-9 at lengthscale 1 (H ~ 2 I)
    and ~0.30 at sqrt(90)."""
    gen = torch.Generator().manual_seed(SEED + 1)
    x, _ = data.make_data(gen, 400, D, "cpu")
    off = ~torch.eye(400, dtype=torch.bool)

    def kappa(ell):
        u = gp.scaled(x, torch.full((D,), ell))
        return gp.matern32(gp.sqdist(u, u))[off]

    at_one, at_root = kappa(1.0), kappa(math.sqrt(D))
    assert float(at_one.median()) < 1e-8 and float(at_one.max()) < 5e-4
    assert 0.25 < float(at_root.median()) < 0.35


def test_targets(problem):
    """The pathwise targets [y | f + sigma eps]: RFF features over 90
    coordinates in the reference's row chunks and the port's one product,
    float32 sums in another order: 1e-4 relative, 1e-5 absolute (the
    features are O(1) and their 1000-pair sums O(1))."""
    x, y, _, draws, raw, params, probes, _ = problem
    want = build_system_targets(probes, x, y, params)
    got = gp.targets(gp.Arith(), x, y, draws, raw)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)


def test_h_product(problem):
    """H v over the padded rows: squared distances over 90 coordinates by
    direct differences (the port) against the expanded form (the
    reference), whose absolute error ~1e-7 |u|^2 moves the kernel by ~1e-6
    at these distances: 1e-5 of the largest output."""
    x, _, _, _, raw, _, _, op = problem
    v = torch.randn(x.shape[0], S + 1, generator=torch.Generator().manual_seed(3))
    got, want = gp.h_product(gp.Arith(), x, v, raw), op.mvm(v)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_gradient_of_all_92_leaves(problem):
    """The pathwise gradient's 90 lengthscale, signal and noise entries at
    the solutions held fixed, the phantom rows included as the cell has
    them: the reference sums in float64, the port in float32 over 500^2
    pairs: 1e-4 relative, and 1e-5 of the largest entry of each leaf
    absolute (a lengthscale entry near 0 is a difference of sums)."""
    x, y, n_real, _, raw, params, probes, _ = problem
    v = torch.randn(x.shape[0], S + 1, generator=torch.Generator().manual_seed(4))
    targets = build_system_targets(probes, x, y, params)
    want, _ = mll_grad_estimate(x, y, params, v, targets, "pathwise",
                                backend="cuda")
    got = gp.grad(gp.Arith(), x, v, raw, n_real)
    assert sum(g.numel() for g in got) == 92
    for g, w in zip(got, want.leaves):
        assert g.shape == w.shape
        assert torch.allclose(g, w, rtol=1e-4, atol=1e-5 * float(w.abs().max()))


def test_ap_solve_across_the_phantom_rows(problem):
    """One AP solve of the padded system under a 2-epoch budget from a warm
    start: the same block order, so the same iterations, and solutions
    within 1e-3 relative, 1e-4 absolute (float32 residual updates over 10
    iterations in another order); the phantom rows' solution is their own
    diagonal system's."""
    x, y, n_real, _, raw, params, probes, op = problem
    b = build_system_targets(probes, x, y, params)
    v0 = 0.5 * torch.linalg.solve(op.dense(), b)
    cfg = {"name": "ap", "tolerance": 1e-3, "max_epochs": 2,
           "block_size": BLOCK}
    want = solve_ap(op, b, v0, SolverConfig(**cfg))
    got, iters, _ = solver("ap").solve(gp.Arith(), x, b, v0, raw, cfg)
    assert iters == want.iters > 0
    assert torch.allclose(got, want.v, rtol=1e-3, atol=1e-4)
    _, sig, noise = gp.constrained(raw)
    phantom = b[n_real:] / (sig * sig + noise * noise)
    assert torch.allclose(want.v[n_real:], phantom, rtol=1e-4, atol=1e-6)


def test_the_cells_calls_take_the_first_loop():
    """At song's (n, d, s) on the card's 132 SMs: AP's slabs, the full
    products and the gradient's forward take the forward kernel's first
    loop (the warp-specialised loop's rings do not fit at d = 90), not its
    wide path; the fused backward is one launch (s' = 72) on its normal
    path (the wide one starts beyond d = 96)."""
    n, d, s, sms = 464_000, 90, 33, 132
    assert not tiled.fwd_ws(d, s) and not tiled.fwd_wide(d, s)
    for m in (1000, n):
        assert tiled.fwd_plan(n, m, d, s, sms)[0] is False
    assert tiled.bwd_s_chunks(d, s, fused=True) == ((0, s),)
    assert d <= tiled._BWD_DC


def test_a_sound_run_of_the_cell_is_correct():
    """``song.ap-budget`` through ``core.run_cell`` on the CPU at 1500 rows
    (padded to 2000, two blocks): the warm-up step and a 2-step segment,
    judged against the reference at the cell's own limits."""
    plan = core.plan_cell(core.load_spec(ROOT), CELL, ROOT)
    out = core.run_cell(plan, 2**31 + 17, 0.0, False, device="cpu",
                        rows=1500)
    assert out["correct"], out["checks"]
    assert out["attempted"] == plan.traffic["segment_steps"]
    assert out["readings"]["nonfinite_steps"] == 0
