"""The backward CUDA kernel's plan, arithmetic and fused route, on the CPU.

``bwd_split_plan`` (how many column splits the backward kernel runs), the
CPU mirror of the kernel's arithmetic (``kernel_mvm_bwd_mirror``: its
64-row column tiles and splits, the split sum in split order, the Gram
``g v^T`` in 3xTF32 emulated with ``tf32_round``), and the fused route of
``kernels.ops`` (one backward call on ``(u, u, [g | v], [v | g])`` when x1
is x2) against the JAX reference: the Pallas kernel in interpret mode and
``jax.grad`` through the reference's custom VJP for the smooth kernels, a
float64 evaluation for Matérn-1/2, at the tolerances the kernel is held to
on the card (2e-5 and 1e-4 of the largest output). Inputs are numpy draws
from fixed seeds."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.gp.hyperparams import HyperParams as JHyperParams  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.tiled import kernel_mvm_bwd_pallas  # noqa: E402
from repro_torch.gp.hyperparams import HyperParams  # noqa: E402
from repro_torch.kernels import ops, tiled  # noqa: E402

KINDS = ("rbf", "matern12", "matern32", "matern52")
SMOOTH = ("rbf", "matern32", "matern52")
TOL_BWD_VS_PLAIN = 2e-5
TOL_M12_VS_F64 = 1e-4


def _tiles(m):
    return -(-m // tiled.BWD_BN)


@pytest.mark.parametrize("m", [0, 1, 63, 64, 65, 12150])
@pytest.mark.parametrize("n", [1, 128, 300, 2000, 12150])
def test_bwd_split_plan_covers_every_column_tile_once(n, m):
    """On 1 and 132 SMs, the splits' tile ranges (the kernel's formula)
    partition the 64-row column tiles: each tile once, no split empty, and
    no more splits than tiles (one split when there is none)."""
    for sms in (1, 132):
        splits = tiled.bwd_split_plan(n, m, sms)
        tiles = _tiles(m)
        assert 1 <= splits <= max(1, tiles)
        ranges = [tiled.split_tile_range(z, splits, tiles)
                  for z in range(splits)]
        covered = [jt for lo, hi in ranges for jt in range(lo, hi)]
        assert covered == list(range(tiles))
        if tiles:
            assert all(hi > lo for lo, hi in ranges)


def test_bwd_split_plan_at_the_path_shapes():
    """On an H100's 132 SMs: 4 splits at the CG shape (95 row tiles of 128
    against 190 column tiles: 380 blocks, at most 3 x 48 tiles on one SM),
    8 at the smoke's gradient check (n = 2000) and 11 at its card-vs-CPU
    run (n = 667); one split once the row tiles fill two waves. The
    forward kernel's plans are unchanged (tests/test_torch_split.py)."""
    assert tiled.bwd_split_plan(12150, 12150, 132) == 4
    assert tiled.bwd_split_plan(2000, 2000, 132) == 8
    assert tiled.bwd_split_plan(667, 667, 132) == 11
    assert tiled.bwd_split_plan(2 * 132 * 128, 12150, 132) == 1
    assert tiled.split_plan(12150, 12150, 65, 132) == 4


def _draws(seed, n=64, m=4096, d=26, s=65, scale=0.3):
    """Inputs at the path's widths (d = 26, s = 65), scaled so that the
    kernel's values spread over (0, 1] rather than vanish at d = 26."""
    rng = np.random.default_rng(seed)
    u = (scale * rng.normal(size=(n, d))).astype(np.float32)
    w = (scale * rng.normal(size=(m, d))).astype(np.float32)
    g = rng.normal(size=(n, s)).astype(np.float32)
    v = rng.normal(size=(m, s)).astype(np.float32)
    return u, w, g, v


def _pallas(u, w, g, v, kind):
    return np.asarray(kernel_mvm_bwd_pallas(
        *map(jnp.asarray, (u, w, g, v)), kind=kind, bm=64, bn=512,
        interpret=True))


def _bwd_m12_f64(u, w, g, v):
    diff = u[:, None, :].astype(np.float64) - w[None, :, :]
    r2 = np.sum(diff * diff, axis=-1)
    r = np.sqrt(np.maximum(r2, 1e-12))
    slope = np.where(r2 > 1e-12, -np.exp(-r) / (2.0 * r), 0.0)
    dt = (g.astype(np.float64) @ v.astype(np.float64).T) * slope
    return 2.0 * np.einsum("ij,ijk->ik", dt, diff)


def _mirror(u, w, g, v, kind, **kw):
    return tiled.kernel_mvm_bwd_mirror(*map(torch.tensor, (u, w, g, v)), kind,
                                       **kw).numpy()


@pytest.mark.parametrize("splits", [1, 4, 32])
@pytest.mark.parametrize("kind", SMOOTH)
def test_bwd_mirror_matches_pallas(kind, splits):
    """The kernel's arithmetic (the Gram in 3xTF32, the split sum in split
    order) at the fused call's width (s' = 2 * 65 = 130) vs the Pallas
    kernel in interpret mode at 64 x 4096, d = 26: 2e-5 of the largest
    output, the card's tolerance."""
    u, w, g, v = _draws(3, s=130)
    ref = _pallas(u, w, g, v, kind)
    got = _mirror(u, w, g, v, kind, splits=splits)
    assert got.shape == ref.shape == (64, 26)
    assert np.abs(got - ref).max() <= TOL_BWD_VS_PLAIN * np.abs(ref).max()


@pytest.mark.parametrize("splits", [1, 32])
def test_bwd_mirror_matern12_against_float64(splits):
    """Matérn-1/2 with coincident points (w holds u's rows): the kernel's
    arithmetic vs float64 at 1e-4 of the largest output, and exactly 0 from
    each coincident pair (the slope's clamped region)."""
    u, w, g, v = _draws(4)
    w[:64] = u
    ref = _bwd_m12_f64(u, w, g, v)
    got = _mirror(u, w, g, v, "matern12", splits=splits)
    assert np.abs(got - ref).max() <= TOL_M12_VS_F64 * np.abs(ref).max()
    one = _mirror(u[:1], u[:1], g[:1], v[:1], "matern12", splits=1)
    assert np.all(one == 0.0)


def test_bwd_mirror_plans_splits_like_the_kernel():
    """Without ``splits`` the mirror takes the planned count, and its split
    sum, in split order, agrees with one split to fp32 rounding."""
    u, w, g, v = map(torch.tensor, _draws(5, n=16, m=1000, s=9))
    assert tiled.bwd_split_plan(16, 1000, 132) == _tiles(1000)
    planned = tiled.kernel_mvm_bwd_mirror(u, w, g, v, "matern32")
    one = tiled.kernel_mvm_bwd_mirror(u, w, g, v, "matern32", splits=1)
    assert torch.allclose(planned, one, rtol=0, atol=1e-5 * one.abs().max())


@pytest.mark.parametrize("kind", SMOOTH)
def test_bwd_single_tf32_product_is_not_enough(kind):
    """One TF32 product for the Gram (big * big) misses the card's 2e-5
    tolerance at the fused width by ~9x (more than 5x is asserted), where
    three products stay ~50x inside it: why the kernel splits both operands
    (3xTF32)."""
    u, w, g, v = _draws(3, s=130)
    ref = _pallas(u, w, g, v, kind)
    scale = np.abs(ref).max()
    one = np.abs(_mirror(u, w, g, v, kind, passes=1) - ref).max()
    three = np.abs(_mirror(u, w, g, v, kind, passes=3) - ref).max()
    assert one > 5 * TOL_BWD_VS_PLAIN * scale
    assert three <= 0.1 * TOL_BWD_VS_PLAIN * scale


@pytest.mark.parametrize("kind", KINDS)
def test_fused_unit_is_du_plus_dw(kind):
    """The fused call on (u, u, [g | v], [v | g]) equals du + dw of
    kappa(u, u) @ v from two plain backward calls, in float64 to 1e-12 of
    the largest entry (the identity is exact; only rounding differs)."""
    rng = np.random.default_rng(21)
    u, g, v = (torch.tensor(rng.normal(size=s)) for s in
               ((150, 5), (150, 7), (150, 7)))
    two = (tiled.kernel_mvm_bwd_plain(u, u, g, v, kind)
           + tiled.kernel_mvm_bwd_plain(u, u, v, g, kind))
    one = tiled.kernel_mvm_bwd_fused_unit(u, g, v, kind)
    assert (one - two).abs().max() <= 1e-12 * two.abs().max()


def test_fused_operands_pad_to_the_mma_step():
    """[g | v | 0] and [v | g | 0], 2s rounded up to a multiple of 8: 130
    becomes 136 for the path's s = 65, with zero columns past 2s."""
    g, v = torch.randn(5, 65), torch.randn(5, 65)
    gv, vg = tiled.fused_operands(g, v)
    assert gv.shape == vg.shape == (5, 136)
    assert torch.equal(gv[:, :65], g) and torch.equal(gv[:, 65:130], v)
    assert torch.equal(vg[:, :65], v) and torch.equal(vg[:, 65:130], g)
    assert not gv[:, 130:].any() and not vg[:, 130:].any()
    assert tiled.fused_operands(g[:, :4], v[:, :4])[0].shape == (5, 8)


def _params(d, seed, kernel):
    rng = np.random.default_rng(seed)
    leaves = (rng.uniform(-0.3, 0.8, size=d).astype(np.float32),
              np.float32(0.6), np.float32(-0.4))
    return (JHyperParams(*map(jnp.asarray, leaves), kernel=kernel),
            HyperParams(*map(torch.tensor, leaves), kernel=kernel))


@pytest.mark.parametrize("kind", SMOOTH)
def test_fused_route_grads_match_jax(kind):
    """x1 is x2: gradients of sum(sin(K(x, x) v)) for x, v and every
    hyperparameter leaf through the fused route vs ``jax.grad`` through the
    reference's ``kernel_mvm(a, a, ...)`` (Pallas custom VJP in interpret
    mode), at 1e-4 of each gradient's largest entry."""
    rng = np.random.default_rng(23)
    x = rng.normal(size=(56, 4)).astype(np.float32)
    v = rng.normal(size=(56, 5)).astype(np.float32)
    jp, tp = _params(4, 24, kind)

    def loss_j(a, c, p):
        return jnp.sum(jnp.sin(jops.kernel_mvm(a, a, c, p, bm=8, bn=8)))

    ref = jax.tree.leaves(jax.grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(v), jp))
    xt, vt = (torch.tensor(a, requires_grad=True) for a in (x, v))
    leaves = [p.clone().requires_grad_(True) for p in tp.leaves[:2]]
    loss = torch.sum(torch.sin(ops.kernel_mvm(
        xt, xt, vt, tp.with_leaves(leaves + [tp.raw_noise]))))
    got = torch.autograd.grad(loss, [xt, vt] + leaves)
    for a, r in zip(got, ref[:4]):
        r = np.asarray(r)
        assert a.shape == r.shape
        assert np.abs(a.numpy() - r).max() <= 1e-4 * np.abs(r).max()


def test_fused_route_runs_the_backward_once(monkeypatch):
    """kernel_mvm(x, x, ...) runs one backward call (the fused one); two
    distinct tensors of equal values still run two (du and dw); dv goes
    through the forward unit in both cases."""
    calls = {"fwd": 0, "bwd": 0}

    def count(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(ops, "kernel_mvm_unit", count("fwd", ops.kernel_mvm_unit))
    for fn in ("kernel_mvm_bwd_unit", "kernel_mvm_bwd_fused_unit"):
        monkeypatch.setattr(ops, fn, count("bwd", getattr(ops, fn)))
    rng = np.random.default_rng(25)
    x = rng.normal(size=(30, 2)).astype(np.float32)
    v = rng.normal(size=(30, 3)).astype(np.float32)
    _, tp = _params(2, 26, "matern32")
    grads = {}
    for label, pair in (("same", (torch.tensor(x),) * 2),
                        ("distinct", (torch.tensor(x), torch.tensor(x)))):
        calls.update(fwd=0, bwd=0)
        a, b = (t.requires_grad_(True) for t in pair)
        vt = torch.tensor(v, requires_grad=True)
        out = ops.kernel_mvm(a, b, vt, tp)
        ins = [a, vt] if label == "same" else [a, b, vt]
        grads[label] = torch.autograd.grad(out.square().sum(), ins)
        want_bwd = 1 if label == "same" else 2
        assert calls == {"fwd": 2, "bwd": want_bwd}, label
    same_dx, same_dv = grads["same"]
    da, db, dist_dv = grads["distinct"]
    scale = (da + db).abs().max()
    assert (same_dx - (da + db)).abs().max() <= 1e-5 * scale
    assert (same_dv - dist_dv).abs().max() <= 1e-5 * dist_dv.abs().max()


def test_fused_cuda_wrapper_rejects_cpu_tensors():
    """The fused wrapper takes CUDA tensors only, and counts nothing for a
    refused call."""
    u, g = torch.randn(8, 2), torch.randn(8, 3)
    before = tiled.launch_counts()[tiled.BWD_KERNEL_NAME]
    with pytest.raises(ValueError, match="not a CUDA device"):
        tiled.kernel_mvm_bwd_fused_cuda(u, g, g)
    assert tiled.launch_counts()[tiled.BWD_KERNEL_NAME] == before


def test_reset_clears_backward_second_pass_counts():
    """Both kernels count their second passes, and ``reset_launch_counts``
    sets them to 0."""
    assert set(tiled.SECOND_PASSES) == set(tiled.LAUNCHES)
    tiled.SECOND_PASSES[tiled.BWD_KERNEL_NAME] = 2
    tiled.reset_launch_counts()
    assert tiled.SECOND_PASSES[tiled.BWD_KERNEL_NAME] == 0


# -- the range: column chunks of (g, v), the wide paths, the index check -----


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("s", [1, 65, 130, 136, 200, 264, 272, 1000])
@pytest.mark.parametrize("d", [3, 26, 77, 90, 96, 97, 120, 200])
def test_bwd_s_chunks_fit_and_cover_every_column(d, s, fused):
    """The chunks are contiguous, cover columns 0..s-1 once, and each
    launch's operands (the fused call's [g_k | v_k] and [v_k | g_k]: a
    column and its pair in one launch) fit in shared memory; one fewer
    chunk of even width would not fit."""
    chunks = tiled.bwd_s_chunks(d, s, fused)
    assert chunks[0][0] == 0 and chunks[-1][1] == s
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(hi > lo for lo, hi in chunks)

    def width(k):
        return tiled._fused_width(k) if fused else k

    limit = tiled._MAX_SMEM_BYTES
    assert all(tiled._bwd_smem_bytes(d, width(hi - lo)) <= limit
               for lo, hi in chunks)
    if len(chunks) > 1:
        fewer = -(-s // (len(chunks) - 1))
        assert tiled._bwd_smem_bytes(d, width(fewer)) > limit


def test_bwd_s_chunks_at_the_path_shapes():
    """One launch at the GP gradient's widths of the paper's datasets (64
    probes: s' = 130 at d = 3, 11, 26, 77, 90; 32 probes at d = 3), two at
    s' = 272 (135 probes at d = 26) and at s = 272 in the standard roles."""
    for d in (3, 11, 26, 77, 90):
        assert len(tiled.bwd_s_chunks(d, 65, fused=True)) == 1
    assert len(tiled.bwd_s_chunks(3, 33, fused=True)) == 1
    assert tiled.bwd_s_chunks(26, 136, fused=True) == ((0, 68), (68, 136))
    assert tiled.bwd_s_chunks(26, 272) == ((0, 136), (136, 272))


@pytest.mark.parametrize("kind", KINDS)
def test_bwd_chunked_plain_sum_equals_unchunked(kind):
    """D is a sum over the columns of (g, v), so the backward's du summed
    over the chunks of ``bwd_s_chunks`` equals the unchunked du within fp32
    reassociation (1e-5 of the largest entry): in the standard roles at
    s = 272 and as the fused call at s' = 272 (136 pairs, chunks of
    [g_k | v_k], [v_k | g_k])."""
    rng = np.random.default_rng(27)
    u, w = (torch.tensor(0.3 * rng.normal(size=sh).astype(np.float32))
            for sh in ((40, 26), (33, 26)))
    g, v = (torch.tensor(rng.normal(size=sh).astype(np.float32))
            for sh in ((40, 272), (33, 272)))
    whole = tiled.kernel_mvm_bwd_plain(u, w, g, v, kind)
    parts = sum(tiled.kernel_mvm_bwd_plain(u, w, g[:, lo:hi], v[:, lo:hi],
                                           kind)
                for lo, hi in tiled.bwd_s_chunks(26, 272))
    assert (parts - whole).abs().max() <= 1e-5 * whole.abs().max()
    g, v = g[:, :136], g[:, 136:]
    whole = tiled.kernel_mvm_bwd_fused_unit(u, g, v, kind)
    parts = sum(tiled.kernel_mvm_bwd_plain(u, u, *tiled.fused_operands(
        g[:, lo:hi], v[:, lo:hi]), kind)
        for lo, hi in tiled.bwd_s_chunks(26, 136, fused=True))
    assert (parts - whole).abs().max() <= 1e-5 * whole.abs().max()


def test_fwd_wide_path_where_shared_memory_ends():
    """The forward kernel takes its wide path exactly where u's row tile
    and one buffer no longer fit beside the running sums: past d = 116 at
    s >= 72 (s-chunks of 72), past d = 212 at s <= 8."""
    limit = tiled._MAX_SMEM_BYTES
    for d in (1, 26, 90, 116, 117, 120, 200, 212, 213, 1000):
        for s in (1, 8, 65, 72, 130):
            assert tiled.fwd_wide(d, s) == (tiled._smem_bytes(d, s) > limit)
    assert not tiled.fwd_wide(116, 130) and tiled.fwd_wide(117, 65)
    assert not tiled.fwd_wide(212, 1) and tiled.fwd_wide(213, 1)


def test_index_range_check_rejects_int32_overflow():
    """The wrappers refuse a dimension, or a row count rounded up to the
    128-row tiles, that a 32-bit int cannot hold, and take the paper's
    largest shapes (houseelectric's 1.66 M rows at s' = 136)."""
    big = tiled._INT32_LIMIT
    for n, m, d, s in ((big - 100, 5, 3, 4), (5, big - 1, 3, 4),
                       (5, 5, big, 4), (5, 5, 3, big)):
        with pytest.raises(ValueError, match="32-bit index range"):
            tiled._check_index_range("kernel_mvm_cuda", n, m, d, s)
    tiled._check_index_range("kernel_mvm_cuda", big - 129, big - 129, 200, 4)
    tiled._check_index_range("kernel_mvm_bwd_cuda", 1_660_000, 1_660_000,
                             11, 136)
