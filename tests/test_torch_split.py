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
    assert set(tiled.LAUNCHES) == {tiled.KERNEL_NAME, tiled.BWD_KERNEL_NAME}
