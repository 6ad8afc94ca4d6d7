"""Parity of the port's backward distance-tile kernel and its
``autograd.Function`` with the JAX reference: the backward tile's plain
version against ``kernel_mvm_bwd_pallas`` (interpret mode), Matérn-1/2
against float64, gradients of ``kernels.ops.kernel_mvm`` for every argument
against ``jax.grad`` through the reference's custom VJP, and the
hyper-gradient through the kernel pair against the reference's
``mll_grad_estimate``. Inputs are numpy draws from fixed seeds, handed to
both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.gradients import mll_grad_estimate as j_grad  # noqa: E402
from repro.gp.hyperparams import HyperParams as JHyperParams  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.tiled import kernel_mvm_bwd_pallas  # noqa: E402
from repro_torch.core.gradients import mll_grad_estimate  # noqa: E402
from repro_torch.gp.hyperparams import HyperParams  # noqa: E402
from repro_torch.kernels import ops, tiled  # noqa: E402

KINDS = ("rbf", "matern12", "matern32", "matern52")
SMOOTH = ("rbf", "matern32", "matern52")


def _draws(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _pallas_bwd_padded(u, w, g, v, kind, bm=32, bn=32):
    """Reference Pallas backward on shapes padded to its block multiples
    (zero rows of w and v give D = 0, so padding adds nothing)."""
    n, m = u.shape[0], w.shape[0]
    pu, pw = (-n) % bm, (-m) % bn

    def pad(a, r):
        return jnp.asarray(np.pad(a, ((0, r), (0, 0))))

    out = kernel_mvm_bwd_pallas(pad(u, pu), pad(w, pw), pad(g, pu), pad(v, pw),
                                kind=kind, bm=bm, bn=bn, interpret=True)
    return np.asarray(out)[:n]


def _params(d, seed, kernel):
    rng = np.random.default_rng(seed)
    leaves = (rng.uniform(-0.3, 0.8, size=d).astype(np.float32),
              np.float32(0.6), np.float32(-0.4))
    return (JHyperParams(*map(jnp.asarray, leaves), kernel=kernel),
            HyperParams(*map(torch.tensor, leaves), kernel=kernel))


def _rel(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(
        np.asarray(ref)).max()


@pytest.mark.parametrize("kind", SMOOTH)
@pytest.mark.parametrize("n,m,d,s", [(64, 96, 5, 7), (70, 45, 3, 9)])
def test_bwd_plain_matches_pallas(kind, n, m, d, s):
    """``kernel_mvm_bwd_plain`` (and the unit dispatcher on CPU tensors) vs
    ``kernel_mvm_bwd_pallas``, exact multiples and a ragged shape padded to
    the block multiples. Tolerance 1e-5 of the largest output: both are
    fp32, with different summation orders and distance forms (direct
    differences vs the expanded form), a few ulps of the largest entry."""
    u, w, g, v = _draws(n + m + d + s, (n, d), (m, d), (n, s), (m, s))
    ref = _pallas_bwd_padded(u, w, g, v, kind)
    got = tiled.kernel_mvm_bwd_plain(*map(torch.tensor, (u, w, g, v)), kind,
                                     bm=32, bn=32)
    unit = tiled.kernel_mvm_bwd_unit(*map(torch.tensor, (u, w, g, v)), kind)
    assert got.shape == (n, d)
    assert _rel(got.numpy(), ref) <= 1e-5
    assert _rel(unit.numpy(), ref) <= 1e-5


def _bwd_m12_f64(u, w, g, v):
    diff = u[:, None, :].astype(np.float64) - w[None, :, :]
    r2 = np.sum(diff * diff, axis=-1)
    r = np.sqrt(np.maximum(r2, 1e-12))
    slope = np.where(r2 > 1e-12, -np.exp(-r) / (2.0 * r), 0.0)
    dt = (g.astype(np.float64) @ v.astype(np.float64).T) * slope
    return 2.0 * np.einsum("ij,ijk->ik", dt, diff)


def test_bwd_matern12_against_float64():
    """Matérn-1/2 backward with coincident points (w = u, g = v, the
    pathwise roles) vs a float64 evaluation of the registry slope, at 1e-4
    of the largest output. The reference's fp32 Pallas deviation is printed
    beside it: its expanded-form diagonal r2 of ~1e-6 turns into slopes of
    hundreds; the bound is not widened for it."""
    u, g = _draws(31, (96, 3), (96, 5))
    ref = _bwd_m12_f64(u, u, g, g)
    got = tiled.kernel_mvm_bwd_plain(torch.tensor(u), torch.tensor(u),
                                     torch.tensor(g), torch.tensor(g),
                                     "matern12", bm=32, bn=32).numpy()
    jax_fp32 = _pallas_bwd_padded(u, u, g, g, "matern12")
    port_err = _rel(got, ref)
    print(f"matern12 bwd vs float64 (relative to max): port {port_err:.3e}, "
          f"JAX fp32 Pallas {_rel(jax_fp32, ref):.3e}")
    assert port_err <= 1e-4


def _grads_both(loss_j, loss_t, jargs, targs):
    """jax.grad of every argument and hyperparameter leaf vs torch.autograd;
    returns [(port, reference)] per leaf."""
    jg = jax.grad(loss_j, argnums=tuple(range(len(jargs))))(*jargs)
    *tensors, tp = targs
    tleaves = [t.clone().requires_grad_(True) for t in tensors]
    pleaves = [p.clone().requires_grad_(True) for p in tp.leaves]
    loss = loss_t(*tleaves, tp.with_leaves(pleaves))
    tg = torch.autograd.grad(loss, tleaves + pleaves, allow_unused=True)
    return [(np.zeros(np.shape(r), np.float32) if t is None else t.numpy(), r)
            for t, r in zip(tg, jax.tree.leaves(jg))]


@pytest.mark.parametrize("kind", SMOOTH)
def test_unit_mvm_grads_match_jax_all_args(kind):
    """Gradients of sum(sin(K(x1, x2) v)) for x1, x2, v and every
    hyperparameter leaf vs ``jax.grad`` through the reference's
    ``kernel_mvm`` (Pallas custom VJP in interpret mode). Tolerance 1e-4 of
    each gradient's largest entry (fp32 sums over n*m products in different
    orders and distance forms)."""
    x1, x2, v = _draws(5, (48, 3), (40, 3), (40, 4))
    jp, tp = _params(3, 6, kind)

    def loss_j(a, b, c, p):
        return jnp.sum(jnp.sin(jops.kernel_mvm(a, b, c, p, bm=16, bn=16)))

    def loss_t(a, b, c, p):
        return torch.sum(torch.sin(ops.kernel_mvm(a, b, c, p)))

    pairs = _grads_both(loss_j, loss_t, tuple(map(jnp.asarray, (x1, x2, v)))
                        + (jp,), tuple(map(torch.tensor, (x1, x2, v))) + (tp,))
    assert len(pairs) == 3 + 3
    for got, ref in pairs[:5]:
        assert got.shape == np.shape(ref)
        assert _rel(got, ref) <= 1e-4
    assert float(pairs[5][0]) == 0.0 == float(pairs[5][1])  # noise: unused


@pytest.mark.parametrize("kind", SMOOTH)
def test_unit_mvm_grads_symmetric_inputs(kind):
    """x1 is x2 (the GP case): gradients of sum(K(x, x) v ** 2) flow through
    both roles (du + dw) into x and the lengthscales; 1e-4 of the largest
    entry as above."""
    x, v = _draws(7, (40, 2), (40, 3))
    jp, tp = _params(2, 8, kind)

    def loss_j(a, c, p):
        return jnp.sum(jops.kernel_mvm(a, a, c, p, bm=8, bn=8) ** 2)

    def loss_t(a, c, p):
        return torch.sum(ops.kernel_mvm(a, a, c, p) ** 2)

    pairs = _grads_both(loss_j, loss_t, (jnp.asarray(x), jnp.asarray(v), jp),
                        (torch.tensor(x), torch.tensor(v), tp))
    assert len(pairs) == 2 + 3
    for got, ref in pairs[:4]:
        assert got.shape == np.shape(ref)
        assert _rel(got, ref) <= 1e-4


def test_unit_mvm_backward_computes_only_what_is_needed(monkeypatch):
    """With v detached (the hyper-gradient), the backward runs the backward
    tile twice (du, dw) and the forward tile not again (no dv)."""
    calls = {"fwd": 0, "bwd": 0}

    def count(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(ops, "kernel_mvm_unit", count("fwd", ops.kernel_mvm_unit))
    monkeypatch.setattr(ops, "kernel_mvm_bwd_unit",
                        count("bwd", ops.kernel_mvm_bwd_unit))
    x, v = _draws(9, (30, 2), (30, 3))
    _, tp = _params(2, 10, "matern32")
    ell = tp.raw_lengthscales.clone().requires_grad_(True)
    out = ops.kernel_mvm(torch.tensor(x), torch.tensor(x), torch.tensor(v),
                         tp._replace(raw_lengthscales=ell))
    torch.autograd.grad(out.sum(), ell)
    assert calls == {"fwd": 1, "bwd": 2}


@pytest.mark.parametrize("estimator", ["pathwise", "standard"])
def test_mll_grad_cuda_backend_matches_reference(estimator):
    """``mll_grad_estimate(backend="cuda")`` runs the ``autograd.Function``
    (plain versions on CPU tensors) and agrees with the reference's
    ``mll_grad_estimate`` per leaf within 1e-4 of the largest gradient
    entry (fp32 sums of n^2 * s products with cancellation)."""
    x, y, v, tg = _draws(11, (90, 3), (90,), (90, 5), (90, 5))
    jp, tp = _params(3, 12, "matern32")
    jgrads, jaux = j_grad(jnp.asarray(x), jnp.asarray(y), jp, jnp.asarray(v),
                          jnp.asarray(tg), estimator, bm=32, bn=32)
    tgrads, taux = mll_grad_estimate(torch.tensor(x), torch.tensor(y), tp,
                                     torch.tensor(v), torch.tensor(tg),
                                     estimator, backend="cuda")
    ref = jax.tree.leaves(jgrads)
    scale = max(np.abs(np.asarray(r)).max() for r in ref)
    for r, g in zip(ref, tgrads.leaves):
        assert np.abs(g.numpy() - np.asarray(r)).max() <= 1e-4 * scale
    np.testing.assert_allclose(float(taux.quad_value), float(jaux.quad_value),
                               rtol=1e-4)


def test_bwd_cuda_wrapper_rejects_grad_and_cpu_tensors():
    """The raw backward kernel is not differentiable and takes CUDA tensors
    only; nothing is counted for a refused call."""
    u, g = torch.randn(8, 2), torch.randn(8, 3)
    before = tiled.launch_counts()[tiled.BWD_KERNEL_NAME]
    with pytest.raises(RuntimeError, match="forward-only"):
        tiled.kernel_mvm_bwd_cuda(u.clone().requires_grad_(True), u, g, g)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tiled.kernel_mvm_bwd_cuda(u, u, g, g)
    assert tiled.launch_counts()[tiled.BWD_KERNEL_NAME] == before
