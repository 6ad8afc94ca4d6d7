"""The plain reference against the port's plain (CPU) path at n ~ 500:
targets, H products, the pathwise gradient, Adam, the preconditioner and
the CG and AP solves; then whole runs of every cell on the CPU at a small
size, judged correct. The same inputs go to both sides."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import core, data  # noqa: E402
from bench.reference import gp, judge, solver, solvers  # noqa: E402
from repro_torch.core.estimators import ProbeState, build_system_targets  # noqa: E402
from repro_torch.core.gradients import mll_grad_estimate  # noqa: E402
from repro_torch.gp.hyperparams import HyperParams  # noqa: E402
from repro_torch.gp.rff import RFFState  # noqa: E402
from repro_torch.solvers import HOperator, SolverConfig  # noqa: E402
from repro_torch.solvers.ap import solve_ap  # noqa: E402
from repro_torch.solvers.cg import solve_cg  # noqa: E402
from repro_torch.solvers.precond import pivoted_cholesky  # noqa: E402
from repro_torch.train.adam import AdamConfig, AdamState, adam_update  # noqa: E402

N, D, S, PAIRS = 500, 5, 8, 200
FP32 = dict(rtol=2e-5, atol=2e-6)


@pytest.fixture(scope="module")
def problem():
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(2**31 + 5)
    x, y = data.make_data(gen, N, D, "cpu")
    draws = data.make_draws(gen, N, D, S, PAIRS, "cpu")
    raw = [torch.linspace(-0.3, 0.8, D), torch.tensor(0.4),
           torch.tensor(-0.2)]
    params = HyperParams(*raw, kernel="matern32")
    probes = ProbeState("pathwise", None,
                        RFFState(draws["z"], draws["u"], draws["w"],
                                 "matern32"), draws["w_eps"])
    op = HOperator(x=x, params=params, backend="cuda")
    return x, y, draws, raw, params, probes, op


def test_targets(problem):
    x, y, draws, raw, params, probes, _ = problem
    want = build_system_targets(probes, x, y, params)
    assert torch.allclose(gp.targets(gp.Arith(), x, y, draws, raw), want,
                          rtol=1e-4, atol=1e-5)


def test_h_product(problem):
    x, _, _, raw, _, _, op = problem
    v = torch.randn(N, S + 1, generator=torch.Generator().manual_seed(3))
    assert torch.allclose(gp.h_product(gp.Arith(), x, v, raw), op.mvm(v),
                          **FP32)


def test_gradient(problem):
    x, y, draws, raw, params, probes, _ = problem
    v = torch.randn(N, S + 1, generator=torch.Generator().manual_seed(4))
    targets = build_system_targets(probes, x, y, params)
    want, _ = mll_grad_estimate(x, y, params, v, targets, "pathwise",
                                backend="cuda")
    got = gp.grad(gp.Arith(), x, v, raw)
    for g, w in zip(got, want.leaves):
        assert torch.allclose(g, w, rtol=1e-4, atol=1e-5 * float(w.abs().max()))


def test_adam(problem):
    raw, params = problem[3], problem[4]
    g = [torch.linspace(-1.0, 2.0, D), torch.tensor(0.3), torch.tensor(-0.7)]
    mu = [0.1 * t for t in g]
    nu = [0.01 * t * t for t in g]
    want_p, want = adam_update(
        params.with_leaves(g),
        AdamState(step=3, mu=params.with_leaves(mu), nu=params.with_leaves(nu)),
        params, AdamConfig(learning_rate=0.1), maximize=True)
    got = gp.adam(raw, mu, nu, 3, g, 0.1)
    for a, b in zip(got[0], want_p.leaves):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-7)
    for a, b in zip(got[1], want.mu.leaves):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-8)


def test_preconditioner(problem):
    x, _, _, raw, _, _, op = problem
    assert torch.allclose(solvers.pivoted_cholesky(x, raw, 40),
                          pivoted_cholesky(op, 40), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["cg", "ap"])
def test_solves(problem, name):
    x, y, draws, raw, params, probes, op = problem
    b = build_system_targets(probes, x, y, params)
    v0 = 0.5 * torch.linalg.solve(op.dense(), b)
    cfg = {"name": name, "tolerance": 1e-3, "max_epochs": 2,
           "precond_rank": 40, "block_size": 100}
    want = (solve_cg if name == "cg" else solve_ap)(op, b, v0,
                                                    SolverConfig(**cfg))
    got, iters, _ = solver(name).solve(gp.Arith(), x, b, v0, raw, cfg)
    assert iters == want.iters
    assert torch.allclose(got, want.v, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", ["cg", "ap"])
def test_forward_products_follow_the_solver(name):
    cfg = {"name": name, "block_size": 1000}
    got = solver(name).forward_products(392000, 3, 33, cfg, 2, 2352.0)
    want = ([(2354.0, 392000, 392000, 3, 33)] if name == "cg" else
            [(2, 392000, 392000, 3, 33), (2352.0, 392000, 1000, 3, 33)])
    assert got == want


def test_leaf_gap():
    want = [torch.tensor([3.0, 4.0]), torch.tensor(1.0), torch.tensor(0.0)]
    got = [torch.tensor([3.0, 4.5]), torch.tensor(1.0), torch.tensor(0.1)]
    # leaf 0: 0.5 / 5; leaf 2: 0.1 over the median leaf norm 1
    assert judge.leaf_gap(got, want) == pytest.approx(0.1)


CELLS = {"protein.cg-tol": 500, "protein.cg-tol-lanes4": 400,
         "3droad.cg-budget": 800, "3droad.ap-budget": 1500}


@pytest.mark.parametrize("cell", list(CELLS))
def test_a_sound_run_is_correct(cell):
    plan = core.plan_cell(core.load_spec(ROOT), cell)
    out = core.run_cell(plan, 2**31 + 17, 0.0, False, device="cpu",
                        rows=CELLS[cell])
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] == plan.traffic["segment_steps"]
