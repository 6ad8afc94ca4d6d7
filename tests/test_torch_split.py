"""The forward CUDA kernel's plan and arithmetic, on the CPU.

``split_plan`` (how many column splits the forward kernel runs) and the
CPU mirror of the kernel's arithmetic (``kernel_mvm_mirror``: its column
tiles and splits, the split sum in split order, and 3xTF32 products emulated
with ``tf32_round``) against the JAX reference: the Pallas kernel in
interpret mode for the smooth kernels, and a float64 evaluation for
Matérn-1/2, at the tolerances the kernel is held to on the card (1e-5 and
1e-4 of the largest output). Inputs are numpy draws from fixed seeds."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.tiled import kernel_mvm_pallas  # noqa: E402
from repro_torch.kernels import tiled  # noqa: E402

SMOOTH = ("rbf", "matern32", "matern52")
TOL_VS_PLAIN = 1e-5
TOL_M12_VS_F64 = 1e-4


def _tiles(m):
    return -(-m // tiled.FWD_BN)


@pytest.mark.parametrize("m", [0, 1, 63, 64, 12150])
@pytest.mark.parametrize("n", [1, 16, 64, 500, 1000, 12150])
def test_split_plan_covers_every_column_tile_once(n, m):
    """On 1 and 132 SMs, the splits' tile ranges (the kernel's formula)
    partition the column tiles: each tile once, no split empty, and no more
    splits than tiles (one split when there is none)."""
    for sms in (1, 132):
        splits = tiled.split_plan(n, m, 65, sms)
        tiles = _tiles(m)
        assert 1 <= splits <= max(1, tiles)
        ranges = [tiled.split_tile_range(z, splits, tiles)
                  for z in range(splits)]
        covered = [jt for lo, hi in ranges for jt in range(lo, hi)]
        assert covered == list(range(tiles))
        if tiles:
            assert all(hi > lo for lo, hi in ranges)


@pytest.mark.parametrize("n,sms", [(12150, 1), (2 * 132 * 128, 132),
                                   (5000, 8)])
def test_split_plan_is_one_when_row_tiles_fill_two_waves(n, sms):
    """Row tiles alone make two waves of blocks: no split, no second pass."""
    assert -(-n // tiled.FWD_BM) >= 2 * sms
    assert tiled.split_plan(n, 12150, 65, sms) == 1


def test_split_plan_at_the_path_shapes():
    """On an H100's 132 SMs: one column tile per block at the prediction
    shape and the engine's buckets, a few splits at the CG shape (95 row
    tiles alone leave SMs idle), and at the SGD slab (4 row tiles) as many
    splits as it takes to walk 3 column tiles per block."""
    for n in (16, 64):
        assert tiled.split_plan(n, 12150, 65, 132) == _tiles(12150)
    cg = tiled.split_plan(12150, 12150, 65, 132)
    assert 2 <= cg <= 4
    slab = tiled.split_plan(500, 12150, 65, 132)
    assert -(-_tiles(12150) // slab) == 3


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1.0 + 2.0**-11, 1.0 + 2.0**-10),      # a tie rounds away from zero
    (-(1.0 + 2.0**-11), -(1.0 + 2.0**-10)),
    (1.0 + 3 * 2.0**-11, 1.0 + 2.0**-9),   # a tie rounds away from zero
    (1.0 + 2.0**-12, 1.0),                 # below the tie: down
    (1.0 + 2.0**-11 + 2.0**-20, 1.0 + 2.0**-10),
    (0.0, 0.0),
])
def test_tf32_round_is_round_to_nearest_ties_away(x, want):
    """``tf32_round`` keeps 10 mantissa bits, as ``cvt.rna.tf32.f32``."""
    got = tiled.tf32_round(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want
    assert got.view(torch.int32).item() & 0x1FFF == 0


def _draws(seed, n=64, m=4096, d=26, s=65, scale=0.3):
    """Inputs at the path's widths (d = 26, s = 65), scaled so that the
    kernel's values spread over (0, 1] rather than vanish at d = 26."""
    rng = np.random.default_rng(seed)
    u = (scale * rng.normal(size=(n, d))).astype(np.float32)
    w = (scale * rng.normal(size=(m, d))).astype(np.float32)
    v = rng.normal(size=(m, s)).astype(np.float32)
    return u, w, v


def _pallas(u, w, v, kind):
    return np.asarray(kernel_mvm_pallas(
        jnp.asarray(u), jnp.asarray(w), jnp.asarray(v), kind=kind,
        bm=64, bn=512, interpret=True))


def _m12_f64(u, w, v):
    r2 = ((u[:, None, :].astype(np.float64) - w[None, :, :]) ** 2).sum(-1)
    return np.exp(-np.sqrt(np.maximum(r2, 1e-12))) @ v.astype(np.float64)


@pytest.mark.parametrize("splits", [1, 4, 32])
@pytest.mark.parametrize("kind", SMOOTH)
def test_mirror_matches_pallas(kind, splits):
    """The kernel's arithmetic (3xTF32 products, the split sum in split
    order) vs the Pallas kernel in interpret mode at 64 x 4096, d = 26,
    s = 65: 1e-5 of the largest output, the card's tolerance."""
    u, w, v = _draws(3)
    ref = _pallas(u, w, v, kind)
    got = tiled.kernel_mvm_mirror(*map(torch.tensor, (u, w, v)), kind,
                                  splits=splits).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL_VS_PLAIN * np.abs(ref).max()


@pytest.mark.parametrize("splits", [1, 32])
def test_mirror_matern12_against_float64(splits):
    """Matérn-1/2 with coincident points (w holds u's rows): the kernel's
    arithmetic vs float64 at 1e-4 of the largest output."""
    u, w, v = _draws(4)
    w[:64] = u
    ref = _m12_f64(u, w, v)
    got = tiled.kernel_mvm_mirror(*map(torch.tensor, (u, w, v)), "matern12",
                                  splits=splits).numpy()
    assert np.abs(got - ref).max() <= TOL_M12_VS_F64 * np.abs(ref).max()


def test_mirror_plans_splits_like_the_kernel():
    """Without ``splits`` the mirror takes the planned count, and its split
    sum, in split order, agrees with one split to fp32 rounding."""
    u, w, v = map(torch.tensor, _draws(5, n=16, m=1000))
    assert tiled.split_plan(16, 1000, 65, 132) == _tiles(1000)
    planned = tiled.kernel_mvm_mirror(u, w, v, "matern32")
    one = tiled.kernel_mvm_mirror(u, w, v, "matern32", splits=1)
    assert torch.allclose(planned, one, rtol=0, atol=1e-6 * one.abs().max())


@pytest.mark.parametrize("kind", SMOOTH)
def test_single_tf32_product_is_not_enough(kind):
    """One TF32 product (big * big) misses the card's 1e-5 tolerance at the
    same shape by more than an order of magnitude: why the kernel splits
    both operands (3xTF32)."""
    u, w, v = _draws(3)
    ref = _pallas(u, w, v, kind)
    got = tiled.kernel_mvm_mirror(*map(torch.tensor, (u, w, v)), kind,
                                  passes=1).numpy()
    assert np.abs(got - ref).max() > 10 * TOL_VS_PLAIN * np.abs(ref).max()


def test_reset_clears_second_pass_counts():
    """``reset_launch_counts`` sets the second-pass count to 0 as well."""
    tiled.SECOND_PASSES[tiled.KERNEL_NAME] = 3
    tiled.reset_launch_counts()
    assert tiled.SECOND_PASSES[tiled.KERNEL_NAME] == 0
    assert set(tiled.LAUNCHES) == {tiled.KERNEL_NAME, tiled.WS_KERNEL_NAME,
                                   tiled.BWD_KERNEL_NAME}


def test_launch_counts_carry_the_warp_specialised_loop():
    """A forward call that took the warp-specialised loop counts under
    ``kernel_mvm_fwd`` (every forward call) and ``kernel_mvm_fwd_ws``, its
    second pass under both; a call of the first loop under the first
    alone. Both names match the trace's ``kernel_mvm_fwd`` pattern."""
    tiled.reset_launch_counts()
    tiled.count_launch(tiled.KERNEL_NAME, True, path=tiled.WS_KERNEL_NAME)
    tiled.count_launch(tiled.KERNEL_NAME)
    counts, passes = tiled.launch_counts(), tiled.second_pass_counts()
    assert counts[tiled.KERNEL_NAME] == 2 and counts[tiled.WS_KERNEL_NAME] == 1
    assert passes[tiled.KERNEL_NAME] == passes[tiled.WS_KERNEL_NAME] == 1
    assert counts[tiled.BWD_KERNEL_NAME] == 0
    assert tiled.WS_KERNEL_NAME.startswith(tiled.KERNEL_NAME)
    tiled.reset_launch_counts()
    assert not any(tiled.launch_counts().values())


# (d, s, whether the warp-specialised loop takes it): the paper's sets at
# their CG widths s = 33 and 65, and the edges of the shared-memory rule.
WS_PATHS = [(3, 33, True), (3, 65, True), (9, 65, True), (11, 65, True),
            (17, 65, True), (18, 65, True), (20, 65, True), (20, 130, True),
            (21, 65, False), (26, 33, True), (26, 40, True), (26, 65, False),
            (44, 40, True), (45, 40, False), (77, 33, False), (90, 65, False)]


@pytest.mark.parametrize("d,s,want", WS_PATHS)
def test_ws_path_follows_its_shared_memory(d, s, want):
    """The forward call takes the warp-specialised loop exactly where its
    rings (kappa big and small, V big and small, w), u's row tile and the
    barriers fit in a block's 232 448 bytes; the plan then walks 64-row
    column tiles, else the first loop's 128."""
    assert tiled.fwd_ws(d, s) is want
    assert (tiled._ws_smem_bytes(d, s) <= 232_448) is want
    ws, bn, _ = tiled.fwd_plan(41157, 41157, d, s, 132)
    assert ws is want and bn == (tiled.WS_BN if want else tiled.FWD_BN)


def test_ws_shared_memory_at_the_cells():
    """The loop's shared memory at the cells' (d, s), counted by hand:
    2 x (kappa 2 x 128 x 64 + V 2 x 8NT x 64) + 3 x w 64 x dp + 128 x dp
    floats and 14 barriers."""
    assert tiled._ws_smem_bytes(3, 33) == 4 * (2 * (16384 + 5120) + 3 * 256 + 512) + 112
    assert tiled._ws_smem_bytes(9, 65) == 4 * (2 * (16384 + 9216) + 3 * 768 + 1536) + 112
    assert tiled._ws_smem_bytes(9, 65) == 220_272


@pytest.mark.parametrize("m", [0, 1, 63, 64, 65, 12150])
@pytest.mark.parametrize("n", [1, 64, 500, 12150, 41157])
def test_ws_split_plan_covers_every_column_tile_once(n, m):
    """The warp-specialised loop's splits over its 64-row column tiles
    partition them, none empty, at most one split per tile."""
    for sms in (1, 132):
        splits = tiled.ws_split_plan(n, m, 65, sms)
        tiles = -(-m // tiled.WS_BN)
        assert 1 <= splits <= max(1, tiles)
        covered = [jt for z in range(splits)
                   for jt in range(*tiled.split_tile_range(z, splits, tiles))]
        assert covered == list(range(tiles))


@pytest.mark.parametrize("n,m,d,s,want", [
    (13500, 100, 18, 33, False),    # AP's slab at elevators: 2 tiles a block
    (13500, 256, 18, 33, False),    # 4 tiles a block
    (13500, 384, 18, 33, True),     # 6 tiles a block
    (1001, 777, 7, 9, False),       # 13 tiles over 13 splits
    (64, 41157, 9, 65, False),      # a prediction at protein: 1 row tile
    (64, 391387, 3, 33, False),     # one at 3droad: 46 tiles a block
    (384, 41157, 9, 65, False),     # 3 row tiles
    (512, 41157, 9, 65, True),      # 4 row tiles, 19 tiles a block
    (392000, 1000, 3, 33, True),    # AP's slab at 3droad: 16 tiles
    (13446, 13446, 18, 33, True),   # CG at elevators: 35 tiles a block
    (2048, 4096, 9, 65, True)])     # 8 tiles a block
def test_ws_path_needs_enough_tiles(n, m, d, s, want):
    """Where the rings fit, a call still takes the first loop when the
    warp-specialised plan would have its blocks walk fewer than six column
    tiles (the rings' fill and drain then cost more than the loop saves)
    or u has fewer than four row tiles (the pre-split pass over all of w
    and V then costs more than the pairs it serves)."""
    assert tiled.fwd_ws(d, s)
    ws, _, splits = tiled.fwd_plan(n, m, d, s, 132)
    assert ws is want
    if want:
        assert -(-m // tiled.WS_BN) // splits >= 6 and -(-n // 128) >= 4


def test_ws_split_plan_at_the_cells():
    """At the cells' shapes on 132 SMs: 3droad's 6116 column tiles in 24
    splits (no running sum over 256 tiles); protein's 644 in 4 alone (1288
    blocks, ten full waves, where 3 splits would leave an eighth wave 30 %
    full) and 3 at B = 4; AP's slab (16 tiles) in one."""
    assert tiled.ws_split_plan(391387, 391387, 33, 132) == 24
    assert tiled.ws_split_plan(392000, 1000, 33, 132) == 1
    assert tiled.ws_split_plan(41157, 41157, 65, 132) == 4
    assert tiled.ws_split_plan(41157, 41157, 65, 132, 4) == 3
    for n, m in ((391387, 391387), (41157, 41157), (16, 10 ** 6)):
        k = tiled.ws_split_plan(n, m, 33, 132)
        assert -(-(-(-m // tiled.WS_BN)) // k) <= 256


def _unpack(packed, m, d, s):
    """(w rows, V_big, V_small) of ``presplit_plain``'s layout, each padded
    to whole tiles and chunks."""
    width = 40 if s <= 40 else 72
    chunks, tiles, dp = -(-s // width), -(-m // 64), tiled._padded_d(d)
    tile = packed.reshape(tiles, -1)
    w_rows = tile[:, :64 * dp].reshape(tiles * 64, dp)
    vt = tile[:, 64 * dp:].reshape(tiles, chunks, 2, width // 8, 16, 8, 4)
    # (tile, chunk, part, nq, jq, nr, jr) -> (part, tile, jq, jr, chunk, nq, nr)
    v = vt.permute(2, 0, 4, 6, 1, 3, 5).reshape(2, tiles * 64, chunks * width)
    return w_rows, v[0], v[1]


@pytest.mark.parametrize("m,d,s", [(150, 5, 90), (64, 3, 33), (1, 9, 65),
                                   (200, 20, 130)])
def test_presplit_reconstructs_the_tf32_split(m, d, s):
    """The loop's pre-split workspace in plain form (``presplit_plain``,
    which the card's pass is held to bit for bit): w's rows at the padded
    stride, and V_big = tf32_round(v), V_small = tf32_round(v - V_big)
    bit for bit, the operands ``_tf32_product`` forms; zeros past m, d
    and s. V_big + V_small is v to TF32's two-term precision."""
    rng = np.random.default_rng(m + d + s)
    w = torch.tensor(rng.normal(size=(m, d)).astype(np.float32))
    v = torch.tensor(rng.normal(size=(m, s)).astype(np.float32))
    packed = tiled.presplit_plain(w, v)
    assert packed.numel() == -(-m // 64) * tiled.ws_tile_floats(d, s)
    w_rows, big, small = _unpack(packed, m, d, s)
    want_big = tiled.tf32_round(v)
    want_small = tiled.tf32_round(v - want_big)
    bits = lambda x: x.contiguous().view(torch.int32)  # noqa: E731
    assert torch.equal(bits(big[:m, :s]), bits(want_big))
    assert torch.equal(bits(small[:m, :s]), bits(want_small))
    assert torch.equal(w_rows[:m, :d], w)
    for pad in (big[m:], big[:, s:], small[m:], small[:, s:], w_rows[m:],
                w_rows[:, d:]):
        assert not pad.any()
    assert (big[:m, :s] + small[:m, :s] - v).abs().max() <= 2.0 ** -21 * v.abs().max()
    lanes = tiled.presplit_plain(torch.stack([w, 2 * w]), torch.stack([v, v]))
    assert torch.equal(lanes[0], packed)


@pytest.mark.parametrize("kind", SMOOTH + ("matern12",))
def test_ws_mirror_matches_float64(kind):
    """The warp-specialised loop's arithmetic (64-row column tiles, 3xTF32
    products, each half tile's sum added in fp32) vs a float64 evaluation at
    8576 x 512, d = 9, s = 65 (the smallest such shape that takes the loop:
    one split of 8 tiles), with coincident points: 1e-5 of the largest
    output (1e-4 for Matérn-1/2, as on the card). One torch thread, so
    that workers running side by side do not oversubscribe the cores."""
    u, w, v = map(torch.tensor, _draws(6, n=8576, m=512, d=9, scale=0.6))
    w[:] = u[:512]
    assert tiled.fwd_plan(8576, 512, 9, 65, 132) == (True, tiled.WS_BN, 1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = tiled.kernel_mvm_plain(u.double(), w.double(), v.double(), kind)
        got = tiled.kernel_mvm_mirror(u, w, v, kind).double()
    finally:
        torch.set_num_threads(threads)
    tol = TOL_M12_VS_F64 if kind == "matern12" else TOL_VS_PLAIN
    assert (got - ref).abs().max() <= tol * ref.abs().max()
