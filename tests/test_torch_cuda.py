"""Tests of the port's kernels that need a CUDA card (marked ``cuda``; they
skip without one). This file imports no JAX, so it runs on a machine with a
card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The forward and backward kernels (and the backward's fused call) are held
to their plain versions, and the hyper-gradient through the kernel pair and
the AP and SGD solves on the card to the same functions on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.gradients import mll_grad_estimate  # noqa: E402
from repro_torch.gp.hyperparams import HyperParams  # noqa: E402
from repro_torch.kernels import tiled  # noqa: E402
from repro_torch.solvers import HOperator, SolverConfig, solve  # noqa: E402

KINDS = ("rbf", "matern12", "matern32", "matern52")


def _draws(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _params(d, seed, kernel):
    rng = np.random.default_rng(seed)
    leaves = (rng.uniform(-0.3, 0.8, size=d).astype(np.float32),
              np.float32(0.6), np.float32(-0.4))
    return HyperParams(*map(torch.tensor, leaves), kernel=kernel)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


# Forward kernel shapes (n, m, d, s): short and long row counts against
# the full pol column range and a ragged one, m < 64 and m = 0, one column,
# the path's 65 and two s-chunks (129), d = 5 and 26, d = 90 (one tile
# buffer: two do not fit in shared memory beyond d = 52), the padded
# pol slabs of AP (13000 x 1000 columns) and SGD (500 x 12500), and the
# wide path for large d (d = 120 and 200 at s = 65, split and not, and
# d = 213 at s = 1; d = 200 at s = 1 still fits the first path).
FWD_SHAPES = [
    (13000, 1000, 26, 65), (500, 12500, 26, 65),
    (1, 12150, 26, 65), (16, 12150, 26, 65), (64, 12150, 26, 65),
    (300, 12150, 26, 65), (1, 277, 26, 65), (16, 277, 26, 65),
    (64, 277, 26, 65), (300, 277, 26, 65), (300, 50, 26, 65),
    (300, 0, 26, 65), (64, 277, 26, 1), (300, 277, 26, 129),
    (300, 277, 5, 65), (300, 277, 90, 65),
    (300, 277, 120, 65), (300, 277, 200, 65), (64, 12150, 200, 65),
    (300, 277, 213, 1), (300, 277, 200, 1), (300, 277, 120, 129),
]


def _fwd_inputs(n, m, d, s, seed=0):
    """Scaled so that the kernel's values spread over (0, 1] at d = 26."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = 0.3 * torch.randn((n, d), generator=gen, device="cuda")
    w = 0.3 * torch.randn((m, d), generator=gen, device="cuda")
    v = torch.randn((m, s), generator=gen, device="cuda")
    return u, w, v


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FWD_SHAPES,
                         ids=["x".join(map(str, s)) for s in FWD_SHAPES])
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_fwd_kernel_matches_plain(kind, shape):
    """On a card: the forward kernel vs its plain version, fp32 at 1e-5 of
    the largest output (the two sum in different orders, the kernel's
    products in 3xTF32), Matérn-1/2 against float64 at 1e-4."""
    _cuda_or_skip()
    u, w, v = _fwd_inputs(*shape)
    got = tiled.kernel_mvm_cuda(u, w, v, kind).double()
    if kind == "matern12":
        ref, tol = tiled.kernel_mvm_plain(u.double(), w.double(), v.double(),
                                          kind), 1e-4
    else:
        ref, tol = tiled.kernel_mvm_plain(u, w, v, kind).double(), 1e-5
    assert got.shape == ref.shape
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.cuda
def test_cuda_fwd_split_path_is_deterministic():
    """On a card: at the prediction shape the column range is split and the
    partial sums go through the second pass; two launches give bitwise equal
    outputs, and each call counts one launch and one second pass."""
    _cuda_or_skip()
    u, w, v = _fwd_inputs(64, 12150, 26, 65, seed=1)
    sms = torch.cuda.get_device_properties(u.device).multi_processor_count
    assert tiled.split_plan(64, 12150, 65, sms) > 1
    tiled.reset_launch_counts()
    first = tiled.kernel_mvm_cuda(u, w, v, "matern32")
    second = tiled.kernel_mvm_cuda(u, w, v, "matern32")
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert tiled.LAUNCHES[tiled.KERNEL_NAME] == 2
    assert tiled.SECOND_PASSES[tiled.KERNEL_NAME] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_bwd_kernel_matches_plain(kind):
    """On a card: the backward kernel vs its plain version in float64 on a
    ragged shape (n, m, s and d not multiples of the tiles), at 2e-5 of the
    largest output (fp32 sums of m * (s + d) products in another order)."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    u, w = (torch.randn(shape, generator=gen, device="cuda")
            for shape in ((300, 7), (277, 7)))
    g, v = (torch.randn(shape, generator=gen, device="cuda")
            for shape in ((300, 9), (277, 9)))
    got = tiled.kernel_mvm_bwd_cuda(u, w, g, v, kind).double()
    ref = tiled.kernel_mvm_bwd_plain(u.double(), w.double(), g.double(),
                                     v.double(), kind)
    assert (got - ref).abs().max().item() <= 2e-5 * ref.abs().max().item()


# Backward kernel shapes (n, m, d, s): 1, 64, 300 and 12150 rows against
# the full pol column range and a ragged one, m < 64 and m = 0, one column,
# the path's s = 65 and the fused call's 130 (and 136 and 200 at the top of
# one launch's range), d = 5, 26, 90 and 96 (one tile buffer where two do
# not fit); s = 272 and 208 (two launches over column chunks), and the
# wide path for d > 96 (97, 120 and 200; split over 12150 columns).
BWD_SHAPES = [
    (1, 12150, 26, 65), (64, 12150, 26, 65), (300, 12150, 26, 65),
    (12150, 277, 26, 65), (1, 277, 26, 65), (64, 277, 26, 65),
    (300, 50, 26, 65), (300, 0, 26, 65), (64, 277, 26, 1),
    (300, 277, 26, 130), (300, 277, 5, 65), (300, 277, 90, 65),
    (300, 277, 90, 136), (64, 277, 96, 200),
    (300, 277, 26, 272), (64, 277, 96, 208), (300, 277, 97, 65),
    (300, 277, 120, 65), (64, 277, 200, 130), (300, 12150, 120, 65),
]


def _bwd_inputs(n, m, d, s, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = 0.3 * torch.randn((n, d), generator=gen, device="cuda")
    w = 0.3 * torch.randn((m, d), generator=gen, device="cuda")
    g = torch.randn((n, s), generator=gen, device="cuda")
    v = torch.randn((m, s), generator=gen, device="cuda")
    return u, w, g, v


def _bwd_ref(u, w, g, v, kind):
    """The plain version: fp32 at 2e-5 of the largest output, Matérn-1/2
    in float64 at 1e-4."""
    if kind == "matern12":
        return tiled.kernel_mvm_bwd_plain(u.double(), w.double(), g.double(),
                                          v.double(), kind), 1e-4
    return tiled.kernel_mvm_bwd_plain(u, w, g, v, kind).double(), 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BWD_SHAPES,
                         ids=["x".join(map(str, s)) for s in BWD_SHAPES])
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_bwd_kernel_matches_plain_over_shapes(kind, shape):
    """On a card: the backward kernel vs its plain version over the shape
    list (splits, ragged edges, the one-buffer path), at the tolerances of
    ``chip_smoke.py``."""
    _cuda_or_skip()
    u, w, g, v = _bwd_inputs(*shape)
    got = tiled.kernel_mvm_bwd_cuda(u, w, g, v, kind).double()
    ref, tol = _bwd_ref(u, w, g, v, kind)
    assert got.shape == ref.shape
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= tol * max(
        ref.abs().max().item(), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_bwd_fused_matches_plain(kind):
    """On a card: the fused call (u, u, [g | v], [v | g], padded to s' =
    136) vs the plain version on the unpadded operands, with coincident
    points on the diagonal."""
    _cuda_or_skip()
    u, _, g, v = _bwd_inputs(1000, 1000, 26, 65, seed=2)
    got = tiled.kernel_mvm_bwd_fused_cuda(u, g, v, kind).double()
    ref, tol = _bwd_ref(u, u, torch.cat([g, v], 1), torch.cat([v, g], 1),
                        kind)
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.cuda
def test_cuda_bwd_split_path_is_deterministic():
    """On a card: at 300 x 12150 the column range is split and the partial
    sums go through the second pass; two launches give bitwise equal
    outputs, and each call counts one launch and one second pass."""
    _cuda_or_skip()
    u, _, g, v = _bwd_inputs(300, 300, 26, 65, seed=4)
    sms = torch.cuda.get_device_properties(u.device).multi_processor_count
    assert tiled.bwd_split_plan(300, 300, sms) > 1
    tiled.reset_launch_counts()
    first = tiled.kernel_mvm_bwd_fused_cuda(u, g, v, "matern32")
    second = tiled.kernel_mvm_bwd_fused_cuda(u, g, v, "matern32")
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert tiled.LAUNCHES[tiled.BWD_KERNEL_NAME] == 2
    assert tiled.SECOND_PASSES[tiled.BWD_KERNEL_NAME] == 2


@pytest.mark.cuda
def test_cuda_bwd_rejects_shapes_outside_its_range():
    """On a card: the range is the reference's, so d = 97 and s = 208 at
    d = 96 (once refused) run, in one launch and in two; what raises
    before any launch is a wrong input: mismatched shapes, an unknown
    kind, fp64, a CPU tensor, d = 0."""
    _cuda_or_skip()
    for (n, d, s), launches in (((8, 97, 9), 1), ((8, 96, 208), 2)):
        u, w, g, v = _bwd_inputs(n, n, d, s)
        before = tiled.launch_counts()[tiled.BWD_KERNEL_NAME]
        got = tiled.kernel_mvm_bwd_cuda(u, w, g, v)
        assert got.shape == (n, d) and torch.isfinite(got).all()
        assert tiled.launch_counts()[tiled.BWD_KERNEL_NAME] == before + launches
    u, w, g, v = _bwd_inputs(8, 8, 5, 9)
    before = tiled.launch_counts()[tiled.BWD_KERNEL_NAME]
    bad = ((ValueError, (u, w[:7].contiguous(), g, v, "matern32")),
           (ValueError, (u, w, g, v, "cosine")),
           (TypeError, (u.double(), w, g, v, "matern32")),
           (ValueError, (u.cpu(), w, g, v, "matern32")),
           (ValueError, (u[:, :0].contiguous(), w[:, :0].contiguous(), g, v,
                         "matern32")))
    for exc, args in bad:
        with pytest.raises(exc):
            tiled.kernel_mvm_bwd_cuda(*args)
    assert tiled.launch_counts()[tiled.BWD_KERNEL_NAME] == before


@pytest.mark.cuda
def test_cuda_wrappers_refuse_past_the_int32_index_range():
    """On a card: a row count whose round-up to the 128-row tiles passes
    2**31 (2**31 - 64 rows, one coordinate, 8.6 GB each for u and g) is
    refused by both wrappers before any launch or output allocation."""
    _cuda_or_skip()
    n = 2**31 - 64
    u = torch.empty((n, 1), device="cuda")
    w, v = torch.zeros((8, 1), device="cuda"), torch.zeros((8, 1), device="cuda")
    before = tiled.launch_counts()
    with pytest.raises(ValueError, match="32-bit index range"):
        tiled.kernel_mvm_cuda(u, w, v)
    g = torch.empty((n, 1), device="cuda")
    with pytest.raises(ValueError, match="32-bit index range"):
        tiled.kernel_mvm_bwd_cuda(u, w, g, v)
    del u, g
    torch.cuda.empty_cache()
    assert tiled.launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("d,s", [(26, 136), (120, 65), (200, 65)],
                         ids=["d26_s136", "d120_s65", "d200_s65"])
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_bwd_fused_over_the_range(kind, d, s):
    """On a card: the fused call where one launch's shared memory ends
    (s' = 272 at d = 26: two launches on [g_k | v_k], [v_k | g_k]) and on
    the wide path (d = 120, 200), against the plain version on the
    unpadded operands, at the tolerances of ``chip_smoke.py``; one launch
    counted per column chunk."""
    _cuda_or_skip()
    u, _, g, v = _bwd_inputs(700, 700, d, s, seed=5)
    tiled.reset_launch_counts()
    got = tiled.kernel_mvm_bwd_fused_cuda(u, g, v, kind).double()
    assert (tiled.LAUNCHES[tiled.BWD_KERNEL_NAME]
            == len(tiled.bwd_s_chunks(d, s, fused=True)))
    ref, tol = _bwd_ref(u, u, torch.cat([g, v], 1), torch.cat([v, g], 1),
                        kind)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("estimator", ["pathwise", "standard"])
def test_cuda_mll_grad_matches_cpu(estimator):
    """On a card: the hyper-gradient through the kernel pair vs the same
    function on the CPU (plain versions), per leaf at 1e-4 of the largest
    entry."""
    _cuda_or_skip()
    x, y, v, tg = _draws(13, (500, 4), (500,), (500, 9), (500, 9))
    tp = _params(4, 14, "matern32")
    cpu, _ = mll_grad_estimate(*map(torch.tensor, (x, y)), tp,
                               *map(torch.tensor, (v, tg)), estimator,
                               backend="cuda")
    dev = [torch.tensor(a, device="cuda") for a in (x, y, v, tg)]
    card, _ = mll_grad_estimate(
        dev[0], dev[1], tp.with_leaves([p.cuda() for p in tp.leaves]),
        dev[2], dev[3], estimator, backend="cuda")
    scale = max(c.abs().max().item() for c in cpu.leaves)
    for a, b in zip(card.leaves, cpu.leaves):
        assert (a.cpu() - b).abs().max().item() <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_unit_mvm_grads_match_cpu(kind):
    """On a card: gradients of sum(K(x1, x2) v ** 2) for x1, x2, v and the
    hyperparameters through the ``autograd.Function`` (forward kernel, two
    backward kernels, forward kernel with roles swapped for dv) vs the same
    on the CPU, at 1e-4 of each gradient's largest entry. (A squared loss
    keeps the signal leaf a sum of positive terms; under sin() it is a sum
    of 2,700 terms of both signs whose fp32 rounding alone reaches ~1e-4.)"""
    _cuda_or_skip()
    from repro_torch.kernels.ops import kernel_mvm

    x1, x2, v = _draws(15, (300, 5), (277, 5), (277, 9))
    tp = _params(5, 16, kind)

    def grads(device):
        args = [torch.tensor(a, device=device, requires_grad=True)
                for a in (x1, x2, v)]
        leaves = [p.to(device).requires_grad_(True) for p in tp.leaves[:2]]
        p = tp.with_leaves(leaves + [tp.raw_noise.to(device)])
        loss = torch.sum(kernel_mvm(*args, p) ** 2)
        return [g.cpu() for g in torch.autograd.grad(loss, args + leaves)]

    for a, b in zip(grads("cuda"), grads("cpu")):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_unit_mvm_grads_same_input_match_cpu(kind):
    """On a card: x1 is x2 (the GP case, one fused backward launch): the
    gradients of sum(K(x, x) v ** 2) for x, v and the hyperparameters vs
    the same on the CPU, at 1e-4 of each gradient's largest entry; one
    backward launch on the card."""
    _cuda_or_skip()
    from repro_torch.kernels.ops import kernel_mvm

    x, v = _draws(17, (300, 5), (300, 9))
    tp = _params(5, 18, kind)

    def grads(device):
        args = [torch.tensor(a, device=device, requires_grad=True)
                for a in (x, v)]
        leaves = [p.to(device).requires_grad_(True) for p in tp.leaves[:2]]
        p = tp.with_leaves(leaves + [tp.raw_noise.to(device)])
        loss = torch.sum(kernel_mvm(args[0], args[0], args[1], p) ** 2)
        return [g.cpu() for g in torch.autograd.grad(loss, args + leaves)]

    tiled.reset_launch_counts()
    card = grads("cuda")
    assert tiled.LAUNCHES[tiled.BWD_KERNEL_NAME] == 1
    for a, b in zip(card, grads("cpu")):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ap", "sgd"])
def test_cuda_ap_sgd_solve_matches_cpu(name):
    """On a card: AP (3 epochs of 64-row blocks) and SGD (3 epochs of
    64-row batches, one schedule handed to both) through the forward
    kernel's slabs vs the same solve on the CPU: equal iteration counts,
    solutions within 1e-4 of the largest entry."""
    _cuda_or_skip()
    x, b = _draws(15, (512, 5), (512, 9))
    tp = _params(5, 16, "matern32")
    sched = np.random.default_rng(17).integers(0, 8, size=24).tolist()
    cfg = SolverConfig(name=name, tolerance=0.0, max_epochs=3, block_size=64,
                       batch_size=64, learning_rate=5.0)
    cpu = solve(HOperator(torch.tensor(x), tp, backend="cuda"),
                torch.tensor(b), None, cfg, batch_idx=sched)
    card = solve(HOperator(torch.tensor(x, device="cuda"),
                           tp.with_leaves([p.cuda() for p in tp.leaves]),
                           backend="cuda"),
                 torch.tensor(b, device="cuda"), None, cfg, batch_idx=sched)
    assert card.iters == cpu.iters == 24
    scale = cpu.v.abs().max().item()
    assert (card.v.cpu() - cpu.v).abs().max().item() <= 1e-4 * scale


# Lanes: (label, n, m, d, s) of each kernel at B = 1 and 4 (one launch for
# all lanes), held lane by lane to the plain version of that lane at the
# kernels' tolerances: the CG shape, AP's padded-pol column slab and SGD's
# row slab, a ragged shape and the wide path (d = 120); for the backward
# also the fused call at s' = 130 and 272 (two launches per call).
LANE_SHAPES = [("cg", 12150, 12150, 26, 65), ("ap_slab", 13000, 1000, 26, 65),
               ("sgd_slab", 500, 12500, 26, 65), ("ragged", 1001, 777, 7, 9),
               ("wide_d120", 8192, 8192, 120, 65)]


def _lane_inputs(lanes, n, m, d, s, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    scale = 0.3 * (26.0 / d) ** 0.5

    def rnd(*shape, k=1.0):
        return k * torch.randn(shape, generator=gen, device="cuda")

    return (rnd(lanes, n, d, k=scale), rnd(lanes, m, d, k=scale),
            rnd(lanes, n, s), rnd(lanes, m, s))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("shape", LANE_SHAPES, ids=[s[0] for s in LANE_SHAPES])
def test_cuda_fwd_lanes_match_plain(shape, lanes):
    """On a card: the forward kernel on lane-stacked operands, one launch
    for all lanes; each lane within 1e-5 of its largest output of the
    plain version on that lane's operands (Matérn-3/2)."""
    _cuda_or_skip()
    _, n, m, d, s = shape
    u, w, _, v = _lane_inputs(lanes, n, m, d, s, seed=lanes)
    before = tiled.launch_counts()[tiled.KERNEL_NAME]
    got = tiled.kernel_mvm_cuda(u, w, v, "matern32")
    assert tiled.launch_counts()[tiled.KERNEL_NAME] == before + 1
    assert got.shape == (lanes, n, s)
    for i in range(lanes):
        ref = tiled.kernel_mvm_plain(u[i], w[i], v[i], "matern32")
        assert (got[i] - ref).abs().max().item() <= \
            1e-5 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("shape", LANE_SHAPES + [("cg_fused", 12150, 12150, 26, 65),
                                                 ("cg_fused_s272", 12150, 12150, 26, 136)],
                         ids=[s[0] for s in LANE_SHAPES] + ["cg_fused", "cg_fused_s272"])
def test_cuda_bwd_lanes_match_plain(shape, lanes):
    """On a card: the backward kernel on lane-stacked operands (the fused
    call for ``cg_fused*``: one launch per column chunk for all lanes,
    s' = 130 and 272); each lane within 2e-5 of its largest output of the
    plain version on that lane's operands (Matérn-3/2)."""
    _cuda_or_skip()
    label, n, m, d, s = shape
    fused = label.startswith("cg_fused")
    u, w, g, v = _lane_inputs(lanes, n, n if fused else m, d, s, seed=7 + lanes)
    if fused:
        v = torch.randn_like(g)
        chunks = len(tiled.bwd_s_chunks(d, s, fused=True))
        before = tiled.launch_counts()[tiled.BWD_KERNEL_NAME]
        got = tiled.kernel_mvm_bwd_fused_cuda(u, g, v, "matern32")
        assert tiled.launch_counts()[tiled.BWD_KERNEL_NAME] == before + chunks
        refs = [tiled.kernel_mvm_bwd_plain(u[i], u[i],
                                           torch.cat([g[i], v[i]], 1),
                                           torch.cat([v[i], g[i]], 1),
                                           "matern32") for i in range(lanes)]
    else:
        got = tiled.kernel_mvm_bwd_cuda(u, w, g, v, "matern32")
        refs = [tiled.kernel_mvm_bwd_plain(u[i], w[i], g[i], v[i], "matern32")
                for i in range(lanes)]
    assert got.shape == (lanes, n, d)
    for i, ref in enumerate(refs):
        assert (got[i] - ref).abs().max().item() <= \
            2e-5 * ref.abs().max().item()


@pytest.mark.cuda
def test_cuda_lane_solve_matches_single_solves():
    """On a card: lane-stacked CG and AP of 3 lanes against each lane's
    single solve on the card: equal iterations, solutions within 1e-3
    relative (the lane-stacked launch plans its own splits)."""
    _cuda_or_skip()
    from repro_torch.gp.hyperparams import stack_params
    from repro_torch.solvers import solve_lanes

    x, b = _draws(21, (512, 5), (3, 512, 9))
    singles = [_params(5, 22 + i, "matern32") for i in range(3)]
    params = stack_params([p.with_leaves([q.cuda() for q in p.leaves])
                           for p in singles])
    xc, bc = torch.tensor(x, device="cuda"), torch.tensor(b, device="cuda")
    for cfg in (SolverConfig(tolerance=0.01, max_epochs=200, precond_rank=20),
                SolverConfig(name="ap", tolerance=0.01, max_epochs=50,
                             block_size=64)):
        res = solve_lanes(xc, params, bc, None, cfg, backend="cuda")
        for i in range(3):
            one = solve(HOperator(xc, params.lane(i), backend="cuda"), bc[i],
                        None, cfg)
            assert one.iters == int(res.iters[i])
            rel = ((res.v[i] - one.v).norm() / one.v.norm()).item()
            assert rel < 1e-3


# The block refresh's shapes at full pol (12150 rows, d = 26, s = 65): the
# k x cap cross-MVM against the carry, the cap x k one against dv, and the
# k x k operator of the block solve, at k = 1 (a BO round), 7 and 64.
REFRESH_K = (1, 7, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("k", REFRESH_K)
@pytest.mark.parametrize("orient", ["k_by_cap", "cap_by_k", "k_by_k"])
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_fwd_refresh_shapes_match_plain(kind, orient, k):
    """On a card: the forward kernel at the block refresh's shapes (n = 1
    against the whole column range; m = 1, where the 3xTF32 product's
    K-dimension is almost all padding; n = m = 1) against its plain
    version, at the tolerances of ``test_cuda_fwd_kernel_matches_plain``."""
    _cuda_or_skip()
    cap = 12150
    n, m = {"k_by_cap": (k, cap), "cap_by_k": (cap, k), "k_by_k": (k, k)}[orient]
    u, w, v = _fwd_inputs(n, m, 26, 65, seed=k)
    if orient == "k_by_k":
        w = u
    got = tiled.kernel_mvm_cuda(u, w, v, kind).double()
    if kind == "matern12":
        ref, tol = tiled.kernel_mvm_plain(u.double(), w.double(), v.double(),
                                          kind), 1e-4
    else:
        ref, tol = tiled.kernel_mvm_plain(u, w, v, kind).double(), 1e-5
    err = (got - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_ghost_rows_are_inert(kind):
    """Ghost rows at the coordinates geometric growth gives them (~1e5
    after scaling): the kernel's direct-difference ``r2`` stays finite, the
    ghost diagonal is ``kappa(0)`` (1, or Matérn-1/2's floored profile, as
    its plain version), and every cross term, Matérn-1/2's exp(-256) the
    slowest, underflows to exactly 0."""
    _cuda_or_skip()
    from repro_torch.gp.kernels_math import profile_from_r2

    gen = torch.Generator(device="cuda").manual_seed(0)
    real = 0.5 * torch.randn((300, 26), generator=gen, device="cuda")
    unit = 256.0 * (float(real.abs().max()) + 1.0 + 1.0)
    ghosts = (torch.arange(1, 65, device="cuda", dtype=torch.float32)[:, None]
              * unit * torch.ones((1, 26), device="cuda"))
    u = torch.cat([real, ghosts])
    eye = torch.eye(u.shape[0], device="cuda")
    k = tiled.kernel_mvm_cuda(u, u, eye, kind)
    assert torch.isfinite(k).all()
    kappa0 = profile_from_r2(kind)(torch.zeros((), device="cuda"),
                                   torch.ones((), device="cuda"))
    g = slice(300, None)
    assert torch.equal(torch.diagonal(k[g, g]),
                       kappa0.expand(64).to(k.dtype))
    off = k[g] - torch.diag_embed(torch.diagonal(k))[g]
    assert torch.all(off == 0)


@pytest.mark.cuda
def test_cuda_refresh_and_engine_match_cpu():
    """A small OnlineGP on the card (block + damped auto, then a solve,
    both through the forward kernel) against the same refines on the CPU
    from the same state and rows, and the engine's queue on the card
    against its synchronous path: iterations equal, carries within 1e-4 of
    their largest entry, predictions within 1e-4."""
    _cuda_or_skip()
    from repro_torch.core.driver import fit
    from repro_torch.core.outer import OuterConfig
    from repro_torch.serve import BucketedEngine, OnlineGP

    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    y = np.sin(x.sum(1)).astype(np.float32)
    x_new = rng.uniform(-2, 2, (12, 3)).astype(np.float32)
    y_new = np.cos(x_new.sum(1)).astype(np.float32)
    rows = rng.normal(size=(12, 8)).astype(np.float32)
    cfg = OuterConfig(estimator="pathwise", num_probes=8, num_rff_pairs=64,
                      solver=SolverConfig(name="cg", tolerance=1e-2,
                                          precond_rank=0),
                      num_steps=2, backend="cuda")
    state = fit(torch.tensor(x), torch.tensor(y), cfg,
                generator=torch.Generator().manual_seed(0)).state
    out = {}
    for dev in ("cpu", "cuda"):
        st = state._replace(
            params=state.params.with_leaves([t.to(dev) for t in
                                             state.params.leaves]),
            probes=state.probes._replace(
                rff=state.probes.rff._replace(
                    z=state.probes.rff.z.to(dev), u=state.probes.rff.u.to(dev),
                    w=state.probes.rff.w.to(dev)),
                w_eps=state.probes.w_eps.to(dev)),
            carry_v=state.carry_v.to(dev))
        o = OnlineGP(torch.tensor(x, device=dev), torch.tensor(y, device=dev),
                     st, cfg)
        o.append(torch.tensor(x_new[:6], device=dev),
                 torch.tensor(y_new[:6], device=dev),
                 rows=torch.tensor(rows[:6], device=dev))
        r1 = o.refine(mode="auto", correction="damped")
        o.append(torch.tensor(x_new[6:], device=dev),
                 torch.tensor(y_new[6:], device=dev),
                 rows=torch.tensor(rows[6:], device=dev))
        r2 = o.refine(mode="solve", budget_epochs=5.0)
        out[dev] = (o, r1, r2)
    (oc, c1, c2), (og, g1, g2) = out["cpu"], out["cuda"]
    assert (g1.iters, g1.corrected, g1.escalated) == (c1.iters, c1.corrected,
                                                       c1.escalated)
    assert g2.iters == c2.iters == 5
    cv = oc.state.carry_v
    assert (og.state.carry_v.cpu() - cv).abs().max() <= 1e-4 * cv.abs().max()
    engine = BucketedEngine(og.export(), buckets=(16, 64))
    xq = torch.tensor(rng.uniform(-2, 2, (40, 3)).astype(np.float32),
                      device="cuda")
    try:
        futs = [engine.enqueue(xq[i:i + 8]) for i in range(0, 40, 8)]
        got = torch.cat([f.result(timeout=60).mean for f in futs])
    finally:
        engine.stop()
    want = engine.submit(xq).mean
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def _card_servable(n=300, d=3, s=8, m=64, seed=0):
    """A servable of random draws on the card (the wire needs no fit)."""
    from repro_torch.gp.rff import RFFState
    from repro_torch.serve import ServableGP

    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.tensor((scale * rng.normal(size=shape)).astype(
            np.float32), device="cuda")

    params = HyperParams(*(torch.tensor(v, device="cuda") for v in (
        np.full(d, 0.3, np.float32), np.float32(0.5), np.float32(-1.0))),
        kernel="matern32")
    return ServableGP(x=t(n, d), correction=t(n, 1 + s),
                      rff=RFFState(z=t(m, d), u=torch.tensor(
                          rng.chisquare(3, size=m).astype(np.float32),
                          device="cuda"), w=t(2 * m, s), kind="matern32"),
                      params=params, kind="matern32")


def _post(url, payload):
    from repro_torch.serve.cluster.replica import _http_json

    status, body = _http_json(url, payload, timeout=60)
    assert status == 200, body
    return body


@pytest.mark.cuda
def test_cuda_http_predict_bitwise_equals_engine(tmp_path):
    """The in-process HTTP front-end on the card: mean, var and samples of
    ``/predict`` bitwise equal to ``engine.submit`` on the same rows (one
    deterministic kernel launch in the same bucket each), and one forward
    launch per dispatch."""
    _cuda_or_skip()
    from repro_torch.serve import MultiModelServer
    from repro_torch.serve import cluster as tc

    model = _card_servable()
    server = MultiModelServer(buckets=(16, 64))
    server.register("default", model, warmup=True)
    httpd, _ = tc.start_http_server(tc.ServeFrontend(server, device="cuda"))
    url = f"http://127.0.0.1:{httpd.port}"
    xq = torch.tensor(np.random.default_rng(1).normal(size=(40, 3)).astype(
        np.float32), device="cuda")
    try:
        for rows in (1, 16, 40):
            torch.cuda.synchronize()
            tiled.reset_launch_counts()
            body = _post(url + "/predict", {"x": xq[:rows].cpu().tolist(),
                                            "samples": True})
            torch.cuda.synchronize()
            assert tiled.launch_counts()[tiled.KERNEL_NAME] == 1
            want = server.engine.submit(xq[:rows], model=model)
            for key in ("mean", "var", "samples"):
                got = torch.tensor(np.float32(body[key]))
                assert torch.equal(got, getattr(want, key).cpu()), (rows, key)
    finally:
        httpd.shutdown()
        httpd.server_close()


@pytest.mark.cuda
def test_cuda_spawned_worker_predicts_bitwise_like_parent(tmp_path):
    """A worker process on the card serving a model this process published:
    its ``/predict`` bitwise equal to this process's engine."""
    _cuda_or_skip()
    from repro_torch.serve import BucketedEngine
    from repro_torch.serve import cluster as tc

    model = _card_servable(seed=2)
    store = str(tmp_path / "store")
    tc.publish_servable(store, model)
    engine = BucketedEngine(model, buckets=(16, 64))
    xq = torch.tensor(np.random.default_rng(3).normal(size=(24, 3)).astype(
        np.float32), device="cuda")
    tiled.build_kernels()
    sup = tc.ReplicaSupervisor(store, num_replicas=1, buckets=(16, 64),
                               device="cuda")
    try:
        (url,) = sup.start(timeout_s=300)
        body = _post(url + "/predict", {"x": xq.cpu().tolist()})
        want = engine.submit(xq)
        assert body["version"] == "v0000001"
        for key in ("mean", "var"):
            got = torch.tensor(np.float32(body[key]))
            assert torch.equal(got, getattr(want, key).cpu()), key
    finally:
        sup.stop()


@pytest.mark.cuda
def test_cuda_fetch_servable_after_admin_swap(tmp_path):
    """``/admin/swap`` on a card replica fetches the new version onto the
    card; ``fetch_servable(device="cuda")`` returns the published tensors
    on the card, and the swapped replica predicts as an engine on them."""
    _cuda_or_skip()
    from repro_torch.serve import BucketedEngine, MultiModelServer
    from repro_torch.serve import cluster as tc

    store = str(tmp_path / "store")
    v1_model, v2_model = _card_servable(seed=4), _card_servable(seed=5)
    tc.publish_servable(store, v1_model)
    server = MultiModelServer(buckets=(16, 64))
    frontend = tc.ServeFrontend(server, store_dir=store, device="cuda")
    poller = tc.ArtifactPoller(store, server, interval_s=60.0, device="cuda")
    assert poller.poll_once()
    httpd, _ = tc.start_http_server(frontend)
    url = f"http://127.0.0.1:{httpd.port}"
    try:
        v2 = tc.publish_servable(store, v2_model)
        body = _post(url + "/admin/swap", {})
        assert body == {"swapped": True, "version": v2, "model": "default"}
        served = server.get("default")
        assert served.x.device.type == "cuda"
        fetched, version, _ = tc.fetch_servable(store, device="cuda")
        assert version == v2 and fetched.correction.device.type == "cuda"
        for a, b in ((fetched.x, v2_model.x),
                     (fetched.correction, v2_model.correction),
                     (fetched.rff.w, v2_model.rff.w)):
            assert torch.equal(a, b)
        xq = v2_model.x[:10] + 0.1
        body = _post(url + "/predict", {"x": xq.cpu().tolist()})
        want = BucketedEngine(fetched, buckets=(16, 64)).submit(xq)
        assert torch.equal(torch.tensor(np.float32(body["mean"])),
                           want.mean.cpu())
    finally:
        httpd.shutdown()
        httpd.server_close()


# The distributed path on virtual shards of one card: a mesh that repeats
# cuda:0 runs the ring's copies and tiles as a multi-card host would.
RING_N, RING_D, RING_S = 4000, 26, 65


def _virtual_mesh(shape, axes):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, axes,
                     devices=[torch.device("cuda", 0)] * int(np.prod(shape)))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_ring_matches_one_launch(kind):
    """On a card: ring_h_mvm over 8 virtual cuda:0 shards ((2, 2, 2) pod x
    data x model) against the one-launch h_mvm, within 2e-5 of the largest
    entry (both 3xTF32 kernels; the ring sums 64 tiles in another order),
    and one ring MVM launches the forward kernel P^2 = 64 times."""
    _cuda_or_skip()
    from repro_torch.distributed.ring import ring_h_mvm
    from repro_torch.distributed.sharding import shard_rows
    from repro_torch.kernels.ops import h_mvm

    mesh = _virtual_mesh((2, 2, 2), ("pod", "data", "model"))
    x, v = _draws(31, (RING_N, RING_D), (RING_N, RING_S))
    xc = 0.3 * torch.tensor(x, device="cuda")
    vc = torch.tensor(v, device="cuda")
    params = _params(RING_D, 32, kind)
    params = params.with_leaves([p.cuda() for p in params.leaves])
    xs, vs = shard_rows(xc, mesh), shard_rows(vc, mesh)
    tiled.reset_launch_counts()
    got = ring_h_mvm(xs, vs, params, mesh, kind=kind)
    torch.cuda.synchronize()
    assert tiled.launch_counts()[tiled.KERNEL_NAME] == mesh.size ** 2
    want = h_mvm(xc, vc, params)
    err = (got.gather("cuda") - want).abs().max().item()
    assert err <= 2e-5 * want.abs().max().item()


@pytest.mark.cuda
def test_cuda_gp_step_on_8_shards_matches_1():
    """On a card: three make_gp_outer_step steps on 8 virtual shards
    against the same on a (1, 1) mesh from one state: hyperparameters
    within 1e-4 (the CPU-vs-card bound), res_z falling."""
    _cuda_or_skip()
    from repro_torch.distributed.gp_step import GPStepState, make_gp_outer_step
    from repro_torch.distributed.sharding import shard_rows
    from repro_torch.gp.rff import init_rff
    from repro_torch.train.adam import adam_init

    n, d, s = 2048, 5, 8
    x, y, w_eps = _draws(33, (n, d), (n,), (n, s))
    rff = init_rff(torch.Generator(device="cuda").manual_seed(34), 256, d, s,
                   device="cuda")
    runs = []
    for shape in ((4, 2), (1, 1)):
        mesh = _virtual_mesh(shape, ("data", "model"))
        params = _params(d, 35, "matern32")
        params = params.with_leaves([p.cuda() for p in params.leaves])
        state = GPStepState(params, adam_init(params), shard_rows(
            torch.zeros((n, 1 + s), device="cuda"), mesh),
            torch.zeros((), device="cuda"), torch.zeros((), device="cuda"))
        step = make_gp_outer_step(mesh, s, solver_epochs=10)
        args = [shard_rows(torch.tensor(a, device="cuda"), mesh)
                for a in (x, y, w_eps)]
        res_z = []
        for _ in range(3):
            state = step(state, args[0], args[1], rff, args[2])
            res_z.append(float(state.res_z))
        runs.append((state.params.flat().cpu(), res_z))
    (h8, z8), (h1, z1) = runs
    assert torch.allclose(h8, h1, rtol=1e-4, atol=1e-6)
    assert z8[2] < z8[0] and z1[2] < z1[0]


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["cg", "sgd"])
@pytest.mark.parametrize("k", [2, 4])
def test_cuda_lane_groups_at_once_bitwise_their_groups_alone(k, solver):
    """On a card: fit_batch over k virtual cuda:0 lane positions (the
    groups at once, a thread and a stream each) against fit_batch over
    each group's lanes alone with no mesh: every state tensor and the
    iteration, residual and hyperparameter histories bitwise equal."""
    _cuda_or_skip()
    from repro_torch import lanes as lanes_mod
    from repro_torch.core.driver import fit_batch
    from repro_torch.core.outer import OuterConfig
    from repro_torch.launch.mesh import make_lane_mesh
    from repro_torch.solvers import stack_numerics
    from repro_torch.solvers.base import numerics_of

    n, d, lanes = 1000, 3, 4
    x, y = (torch.tensor(a, device="cuda") for a in _draws(36, (n, d), (n,)))
    if solver == "cg":
        base = dict(name="cg", max_epochs=30, precond_rank=0)
        grid = [dict(tolerance=t) for t in (0.01, 0.05, 0.02, 0.1)]
    else:
        base = dict(name="sgd", tolerance=0.01, max_epochs=3, batch_size=100)
        grid = [dict(learning_rate=lr) for lr in (2.0, 5.0, 3.0, 4.0)]
    cfg = OuterConfig(estimator="pathwise", warm_start=True, num_steps=3,
                      num_probes=8, num_rff_pairs=64,
                      solver=SolverConfig(**base), backend="cuda")
    nums = stack_numerics([numerics_of(SolverConfig(**base, **g))
                           for g in grid])
    seeds = list(range(40, 40 + lanes))
    got = fit_batch(x, y, cfg, seeds, numerics=nums, mesh=make_lane_mesh(
        devices=[torch.device("cuda", 0)] * k))
    per = lanes // k
    for g in range(k):
        sl = slice(g * per, (g + 1) * per)
        alone = fit_batch(x, y, cfg, seeds[sl],
                          numerics=lanes_mod.tree_map(lambda t: t[sl], nums))
        for i, want in enumerate(alone):
            a, b = [], []
            lanes_mod.tree_map(a.append, got[g * per + i].state)
            lanes_mod.tree_map(b.append, want.state)
            assert all(torch.equal(p, q) for p, q in zip(a, b, strict=True))
            for key in ("iters", "res_y", "res_z", "hypers"):
                np.testing.assert_array_equal(got[g * per + i].history[key],
                                              want.history[key])


@pytest.mark.cuda
def test_cuda_distributed_ap_tracks_its_residual():
    """On a card: distributed_ap_sweeps over 8 virtual shards; the tracked
    residual against b - H v through the one-launch h_mvm (1e-3, the
    reference test's bound), and a warm continuation decreases it."""
    _cuda_or_skip()
    from repro_torch.distributed.ap import distributed_ap_sweeps
    from repro_torch.distributed.ring import global_col_norms
    from repro_torch.kernels.ops import h_mvm

    mesh = _virtual_mesh((4, 2), ("data", "model"))
    x, b = _draws(36, (4096, 5), (4096, 9))
    xc, bc = torch.tensor(x, device="cuda"), torch.tensor(b, device="cuda")
    params = _params(5, 37, "matern32")
    params = params.with_leaves([p.cuda() for p in params.leaves])
    v, r = distributed_ap_sweeps(xc, bc, torch.zeros_like(bc), params, mesh,
                                 block_size=128, num_iters=20)
    r_true = bc - h_mvm(xc, v.gather("cuda"), params)
    assert (r.gather("cuda") - r_true).abs().max().item() <= 1e-3 * max(
        1.0, r_true.abs().max().item())
    v2, r2 = distributed_ap_sweeps(xc, bc, v, params, mesh, block_size=128,
                                   num_iters=20)

    def relres(rr):
        return (global_col_norms(rr) / bc.norm(dim=0)).max().item()

    assert relres(r2) < relres(r) < 1.0


@pytest.mark.cuda
def test_cuda_matern_aliases_launch_the_kernels():
    """The Matérn-3/2 compatibility names on the card: each launches its
    CUDA kernel once and is bitwise equal to the ``kind="matern32"`` call
    it aliases; the op against the CPU within 1e-5 of the largest output
    (the kernels' fp32 bound)."""
    _cuda_or_skip()
    from repro_torch.kernels import ops

    x, v, g = _draws(41, (300, 5), (300, 7), (300, 7))
    params = _params(5, 42, "rbf")
    dev = [torch.tensor(a, device="cuda") for a in (x, v, g)]
    pdev = HyperParams(*(t.cuda() for t in params[:3]), kernel="rbf")
    xd, vd, gd = dev
    u = (xd / pdev.lengthscales).contiguous()
    fwd, bwd = tiled.KERNEL_NAME, tiled.BWD_KERNEL_NAME
    for kernel, alias, wrapped in (
            (fwd, lambda: ops.matern_mvm(xd, xd, vd, pdev),
             lambda: ops.kernel_mvm(xd, xd, vd, pdev, kind="matern32")),
            (fwd, lambda: tiled.matern_mvm_pallas(u, u, vd),
             lambda: tiled.kernel_mvm_cuda(u, u, vd, "matern32")),
            (bwd, lambda: tiled.matern_mvm_bwd_pallas(u, u, gd, vd),
             lambda: tiled.kernel_mvm_bwd_cuda(u, u, gd, vd, "matern32"))):
        before = tiled.launch_counts()[kernel]
        got = alias()
        torch.cuda.synchronize()
        assert tiled.launch_counts()[kernel] - before == 1
        assert torch.equal(got, wrapped())
    cpu = ops.matern_mvm(*map(torch.tensor, (x, x, v)), params)
    got = ops.matern_mvm(xd, xd, vd, pdev).cpu()
    assert (got - cpu).abs().max() <= 1e-5 * cpu.abs().max()


@pytest.mark.cuda
def test_cuda_checkpoint_restores_onto_the_card(tmp_path):
    """A tree of card tensors (a dict, `HyperParams`, an int) saved through
    ``repro_torch.distributed`` restores onto CUDA templates bitwise and on
    the card, never onto the CPU."""
    _cuda_or_skip()
    from repro_torch.distributed import restore_checkpoint, save_checkpoint

    x, v = (torch.tensor(a, device="cuda") for a in _draws(3, (50, 4), (7,)))
    params = _params(4, 1, "rbf")
    params = params.with_leaves([p.cuda() for p in params.leaves])
    tree = {"x": x, "v": [v, 3], "params": params}
    save_checkpoint(str(tmp_path), 0, tree)
    template = {"x": torch.zeros_like(x), "v": [torch.zeros_like(v), 0],
                "params": params.with_leaves(
                    [torch.zeros_like(p) for p in params.leaves])}
    back, _ = restore_checkpoint(str(tmp_path), template)
    assert back["v"][1] == 3 and back["params"].kernel == "rbf"
    for got, want in ((back["x"], x), (back["v"][0], v),
                      *zip(back["params"].leaves, params.leaves)):
        assert got.device == want.device and got.dtype == want.dtype
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("solver,pathwise,warm", [("cg", True, True),
                                                  ("ap", False, False),
                                                  ("sgd", True, False)])
def test_cuda_solver_comparison_variant_matches_cpu(solver, pathwise, warm):
    """On a card: the twin of ``examples/solver_comparison.py``'s
    ``run_variant`` (to tolerance, 3 steps, eval at the last) at 300 rows
    of the elevators stand-in, from one initial state drawn on the CPU and
    with the same per-step draws handed over (fresh probes, SGD's
    schedules, the eval probes and schedule), against the same call on the
    CPU, through ``chip_smoke.py``'s own recipe: iterations equal per step,
    hyperparameters within its ``TOL_TRAIN_VS_CPU`` of the largest, the
    test LLH within 1e-3."""
    _cuda_or_skip()
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    twin = smoke._example("torch_solver_comparison")
    rec = smoke._card_vs_cpu_variant(
        torch, twin, dict(solver=solver, pathwise=pathwise, warm=warm,
                          steps=3, sgd_lr=2.0))
    assert rec["iters_equal"], (rec["iters_cpu"], rec["iters_card"])
    assert rec["ok"], rec["rel_err_per_step"]
    want, got = rec["test_llh"]
    assert abs(got - want) <= 1e-3 * abs(want)
