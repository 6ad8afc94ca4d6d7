"""Parity of the port's kernel layer (``repro_torch.kernels``) with the JAX
reference: registry profiles, the forward tile's plain version against the
Pallas kernel (interpret mode), the public ``kernel_mvm``/``h_mvm`` ops, and
the CUDA wrapper's input checks. Inputs are numpy draws from fixed seeds,
handed to both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.gp.hyperparams import HyperParams as JHyperParams  # noqa: E402
from repro.gp.kernels_math import regularised_kernel_matrix as j_hmat  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import registry as jreg  # noqa: E402
from repro.kernels.tiled import kernel_mvm_pallas  # noqa: E402
from repro_torch.gp.hyperparams import HyperParams  # noqa: E402
from repro_torch.gp.kernels_math import regularised_kernel_matrix  # noqa: E402
from repro_torch.kernels import ops, ref, registry, tiled  # noqa: E402

KINDS = ("rbf", "matern12", "matern32", "matern52")
SMOOTH = ("rbf", "matern32", "matern52")


def _pallas_padded(u, w, v, kind, bm=32, bn=32):
    """Reference Pallas forward on ragged shapes, padded as ops.py pads."""
    n, m = u.shape[0], w.shape[0]
    pu, pw = (-n) % bm, (-m) % bn
    up = np.pad(u, ((0, pu), (0, 0)))
    wp = np.pad(w, ((0, pw), (0, 0)))
    vp = np.pad(v, ((0, pw), (0, 0)))
    out = kernel_mvm_pallas(jnp.asarray(up), jnp.asarray(wp), jnp.asarray(vp),
                            kind=kind, bm=bm, bn=bn, interpret=True)
    return np.asarray(out)[:n]


def _params(d, rng, kernel):
    raw_ls = rng.uniform(-0.3, 0.8, size=d).astype(np.float32)
    raw_sig = np.float32(0.7)
    raw_noise = np.float32(-0.5)
    jp = JHyperParams(jnp.asarray(raw_ls), jnp.asarray(raw_sig),
                      jnp.asarray(raw_noise), kernel=kernel)
    tp = HyperParams(torch.tensor(raw_ls), torch.tensor(raw_sig),
                     torch.tensor(raw_noise), kernel=kernel)
    return jp, tp


@pytest.mark.parametrize("kind", SMOOTH)
@pytest.mark.parametrize("n,m,s", [(70, 45, 1), (33, 100, 8), (100, 75, 9)])
def test_plain_tile_matches_pallas(kind, n, m, s):
    """Plain tiled version vs ``kernel_mvm_pallas`` on ragged shapes.

    Tolerance 1e-5 * max|out|: both are fp32 with different summation
    orders and distance forms (direct differences vs the expanded form),
    which differ by a few ulps of the largest output for these profiles.
    """
    rng = np.random.default_rng(n * 1000 + m * 10 + s)
    u = rng.normal(size=(n, 3)).astype(np.float32)
    w = rng.normal(size=(m, 3)).astype(np.float32)
    v = rng.normal(size=(m, s)).astype(np.float32)
    ref = _pallas_padded(u, w, v, kind)
    got = tiled.kernel_mvm_plain(torch.tensor(u), torch.tensor(w),
                                 torch.tensor(v), kind, bm=32, bn=32).numpy()
    unit = tiled.kernel_mvm_unit(torch.tensor(u), torch.tensor(w),
                                 torch.tensor(v), kind).numpy()
    scale = np.abs(ref).max()
    assert got.shape == (n, s)
    assert np.abs(got - ref).max() <= 1e-5 * scale
    assert np.abs(unit - ref).max() <= 1e-5 * scale


def _m12_f64(u, w, v):
    r2 = ((u[:, None, :].astype(np.float64) - w[None, :, :]) ** 2).sum(-1)
    return np.exp(-np.sqrt(np.maximum(r2, 1e-12))) @ v.astype(np.float64)


def test_matern12_against_float64():
    """Matérn-1/2 (coincident points included) vs a float64 numpy evaluation
    of the registry profile, at the reference's 1e-4 absolute bound.

    The reference's fp32 expanded-form distance is printed beside it: its
    cancellation at coincident points costs ~1e-3 under the sqrt, which is
    why its own Matérn-1/2 tests fail; the bound is not widened for it.
    """
    rng = np.random.default_rng(12)
    u = rng.normal(size=(96, 3)).astype(np.float32)
    v = rng.normal(size=(96, 5)).astype(np.float32)
    ref = _m12_f64(u, u, v)
    got = tiled.kernel_mvm_plain(torch.tensor(u), torch.tensor(u),
                                 torch.tensor(v), "matern12", bm=32,
                                 bn=32).numpy()
    jax_fp32 = _pallas_padded(u, u, v, "matern12")
    port_err = np.abs(got - ref).max()
    print(f"matern12 vs float64: port {port_err:.3e}, "
          f"JAX fp32 Pallas {np.abs(jax_fp32 - ref).max():.3e}")
    assert port_err <= 1e-4


@pytest.mark.parametrize("kind", SMOOTH)
def test_ops_match_reference_ops(kind):
    """``kernel_mvm`` (rectangular, 1-D and 2-D v) and ``h_mvm`` vs the
    reference ops (Pallas in interpret mode). Tolerance 1e-5 * max|out| for
    the fp32 summation-order and distance-form differences."""
    rng = np.random.default_rng(7)
    d = 3
    x1 = rng.normal(size=(50, d)).astype(np.float32)
    x2 = rng.normal(size=(37, d)).astype(np.float32)
    v2 = rng.normal(size=(37, 9)).astype(np.float32)
    v1 = rng.normal(size=(37,)).astype(np.float32)
    hv = rng.normal(size=(50, 4)).astype(np.float32)
    jp, tp = _params(d, rng, kind)
    for ref, got in (
        (jops.kernel_mvm(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(v2), jp,
                         bm=16, bn=16),
         ops.kernel_mvm(torch.tensor(x1), torch.tensor(x2), torch.tensor(v2),
                        tp)),
        (jops.kernel_mvm(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(v1), jp,
                         bm=16, bn=16),
         ops.kernel_mvm(torch.tensor(x1), torch.tensor(x2), torch.tensor(v1),
                        tp)),
        (jops.h_mvm(jnp.asarray(x1), jnp.asarray(hv), jp, bm=16, bn=16),
         ops.h_mvm(torch.tensor(x1), torch.tensor(hv), tp)),
    ):
        ref, got = np.asarray(ref), got.numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("kind", SMOOTH)
def test_dense_oracle_matches_reference(kind):
    """Dense ``H`` and the dense oracle MVMs vs the reference's, to 1e-6 of
    the largest entry (both use the expanded fp32 distance form).

    Matérn-1/2 is left out on purpose: the expanded form leaves diagonal
    ``r2`` of ~1e-6 whose sqrt differs between any two fp32 evaluations by
    ~1e-3 (ROADMAP Queue 3), so the dense oracles cannot agree with each
    other there; test_matern12_against_float64 holds the port instead."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(40, 3)).astype(np.float32)
    x2 = rng.normal(size=(29, 3)).astype(np.float32)
    v = rng.normal(size=(29, 4)).astype(np.float32)
    hv = rng.normal(size=(40,)).astype(np.float32)
    jp, tp = _params(3, rng, kind)
    pairs = (
        (j_hmat(jnp.asarray(x), jp), regularised_kernel_matrix(torch.tensor(x), tp)),
        (jref.kernel_mvm_ref(jnp.asarray(x), jnp.asarray(x2), jnp.asarray(v), jp),
         ref.kernel_mvm_ref(torch.tensor(x), torch.tensor(x2), torch.tensor(v), tp)),
        (jref.h_mvm_ref(jnp.asarray(x), jnp.asarray(hv), jp),
         ref.h_mvm_ref(torch.tensor(x), torch.tensor(hv), tp)),
    )
    for want, got in pairs:
        want, got = np.asarray(want), got.numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_cuda_wrapper_rejects_grad_and_cpu_tensors():
    """The kernel path is forward-only and takes CUDA tensors only."""
    u = torch.randn(8, 2)
    v = torch.randn(8, 3)
    before = tiled.launch_counts()[tiled.KERNEL_NAME]
    with pytest.raises(RuntimeError, match="forward-only"):
        tiled.kernel_mvm_cuda(u.clone().requires_grad_(True), u, v)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tiled.kernel_mvm_cuda(u, u, v)
    assert tiled.launch_counts()[tiled.KERNEL_NAME] == before


@pytest.mark.parametrize("kind", KINDS)
def test_registry_profiles_match_reference(kind):
    """kappa, dkappa/dr2 and the mixture scale vs the reference registry, on
    a grid that straddles both floors. rtol 1e-6 (fp32 transcendental
    rounding); Matérn-1/2's slope is exactly zero at and below its floor."""
    r2 = np.array([0.0, 1e-31, 1e-30, 1e-13, 1e-12, 2e-12, 1e-6, 0.01, 0.5,
                   1.0, 4.0, 30.0], dtype=np.float32)
    u = np.array([0.05, 0.7, 1.0, 3.0, 9.0], dtype=np.float32)
    js, ts = jreg.get_kernel(kind), registry.get_kernel(kind)
    for jf, tf, arg in ((js.kappa_from_r2, ts.kappa_from_r2, r2),
                        (js.dkappa_dr2, ts.dkappa_dr2, r2),
                        (js.mixture_scale, ts.mixture_scale, u)):
        ref = np.asarray(jf(jnp.asarray(arg)))
        got = tf(torch.tensor(arg)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    if kind == "matern12":
        slope = ts.dkappa_dr2(torch.tensor(r2)).numpy()
        assert np.all(slope[r2 <= 1e-12] == 0.0)
        assert np.all(slope[r2 > 1e-12] < 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_kernel_matches_plain(kind):
    """On a card: the CUDA kernel vs its plain version (float64 for
    Matérn-1/2) at 1e-5 * max|out| on a ragged shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    u = torch.randn((300, 5), generator=gen, device="cuda")
    w = torch.randn((277, 5), generator=gen, device="cuda")
    v = torch.randn((277, 9), generator=gen, device="cuda")
    got = tiled.kernel_mvm_cuda(u, w, v, kind).double()
    ref = tiled.kernel_mvm_plain(u.double(), w.double(), v.double(), kind)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
