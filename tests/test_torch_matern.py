"""The port's Matérn-3/2 compatibility names against the reference's:
``kernels.ops.matern_mvm``, ``kernels.ref.matern_mvm_ref``,
``kernels.tiled.matern_mvm_pallas`` / ``matern_mvm_bwd_pallas`` and the
``kernels.matern`` shim. Inputs are numpy draws from fixed seeds, handed to
both packages; the reference's Pallas kernels run in interpret mode.

Bounds are the Matérn-3/2 ones of ``tests/test_torch_kernels.py`` and
``tests/test_torch_bwd.py``: the ops and both tile kernels within 1e-5 of
the largest output (fp32, different summation orders and distance forms),
the dense oracle within 1e-6 (both use the expanded fp32 form). Each alias
is also held bitwise to the ``kind="matern32"`` call it wraps."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.kernels as jkernels  # noqa: E402
import repro.kernels.matern as jshim  # noqa: E402
from repro.gp.hyperparams import HyperParams as JHyperParams  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import tiled as jtiled  # noqa: E402
import repro_torch.kernels as tkernels  # noqa: E402
import repro_torch.kernels.matern as tshim  # noqa: E402
from repro_torch.gp.hyperparams import HyperParams  # noqa: E402
from repro_torch.kernels import ops, ref, tiled  # noqa: E402

OPS_BOUND = 1e-5  # ops and tile kernels, of the largest output
ORACLE_BOUND = 1e-6  # dense oracle, of the largest entry
BM = BN = 16


def _draws(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _params(d, seed):
    rng = np.random.default_rng(seed)
    leaves = (rng.uniform(-0.3, 0.8, size=d).astype(np.float32),
              np.float32(0.7), np.float32(-0.5))
    return (JHyperParams(*map(jnp.asarray, leaves), kernel="matern32"),
            HyperParams(*map(torch.tensor, leaves), kernel="matern32"))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _same(a, b):
    return a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("vshape", [(37, 9), (37,)])
def test_matern_mvm_matches_reference(vshape):
    """``matern_mvm`` (rectangular, 2-D and 1-D v) vs the reference's, and
    bitwise equal to ``kernel_mvm(..., kind="matern32")``, with params whose
    own kernel is another one (the alias fixes the kind)."""
    x1, x2, v = _draws(5, (50, 3), (37, 3), vshape)
    jp, tp = _params(3, 6)
    want = jops.matern_mvm(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(v),
                           jp, bm=BM, bn=BN)
    got = ops.matern_mvm(torch.tensor(x1), torch.tensor(x2), torch.tensor(v),
                         tp)
    assert _rel(got.numpy(), want) <= OPS_BOUND
    rbf = tp._replace(kernel="rbf")
    assert _same(ops.matern_mvm(torch.tensor(x1), torch.tensor(x2),
                                torch.tensor(v), rbf),
                 ops.kernel_mvm(torch.tensor(x1), torch.tensor(x2),
                                torch.tensor(v), rbf, kind="matern32"))


def test_matern_mvm_gradient_is_kernel_mvms():
    """The alias is differentiable like the op it wraps: the gradients of
    ``sum(matern_mvm)`` in x1, x2, v and the raw lengthscales are bitwise
    those of ``kernel_mvm(..., kind="matern32")``."""
    x1, x2, v = _draws(8, (24, 3), (19, 3), (19, 4))
    _, tp = _params(3, 9)
    grads = []
    for fn in (ops.matern_mvm,
               lambda a, b, c, p: ops.kernel_mvm(a, b, c, p, kind="matern32")):
        leaves = [torch.tensor(a, requires_grad=True) for a in (x1, x2, v)]
        ls = tp.raw_lengthscales.clone().requires_grad_(True)
        fn(*leaves, tp._replace(raw_lengthscales=ls)).sum().backward()
        grads.append([t.grad for t in leaves] + [ls.grad])
    for a, b in zip(*grads):
        assert _same(a, b)


@pytest.mark.parametrize("vshape", [(29, 4), (29,)])
def test_matern_mvm_ref_matches_reference(vshape):
    """``matern_mvm_ref`` vs the reference's oracle (within 1e-6 of the
    largest entry), and bitwise ``kernel_mvm_ref(..., kind="matern32")``."""
    x1, x2, v = _draws(21, (40, 3), (29, 3), vshape)
    jp, tp = _params(3, 22)
    want = jref.matern_mvm_ref(jnp.asarray(x1), jnp.asarray(x2),
                               jnp.asarray(v), jp)
    args = (torch.tensor(x1), torch.tensor(x2), torch.tensor(v))
    got = ref.matern_mvm_ref(*args, tp)
    assert _rel(got.numpy(), want) <= ORACLE_BOUND
    assert _same(got, ref.kernel_mvm_ref(*args, tp, kind="matern32"))


@pytest.mark.parametrize("n,m,d,s", [(32, 48, 3, 5), (64, 32, 5, 1)])
def test_matern_mvm_pallas_matches_reference(n, m, d, s):
    """``tiled.matern_mvm_pallas`` on pre-scaled inputs vs the reference's
    alias (block multiples, interpret mode), within 1e-5 of the largest
    output; bitwise the port's ``kernel_mvm_unit(..., "matern32")``."""
    u, w, v = _draws(n + m + d + s, (n, d), (m, d), (m, s))
    want = jtiled.matern_mvm_pallas(jnp.asarray(u), jnp.asarray(w),
                                    jnp.asarray(v), bm=BM, bn=BN,
                                    interpret=True)
    args = tuple(map(torch.tensor, (u, w, v)))
    got = tiled.matern_mvm_pallas(*args)
    assert _rel(got.numpy(), want) <= OPS_BOUND
    assert _same(got, tiled.kernel_mvm_unit(*args, "matern32"))


@pytest.mark.parametrize("n,m,d,s", [(32, 48, 3, 5), (64, 32, 5, 9)])
def test_matern_mvm_bwd_pallas_matches_reference(n, m, d, s):
    """``tiled.matern_mvm_bwd_pallas`` vs the reference's alias, within 1e-5
    of the largest output; bitwise ``kernel_mvm_bwd_unit(..., "matern32")``."""
    u, w, g, v = _draws(7 * n + m + d + s, (n, d), (m, d), (n, s), (m, s))
    want = jtiled.matern_mvm_bwd_pallas(
        *map(jnp.asarray, (u, w, g, v)), bm=BM, bn=BN, interpret=True)
    args = tuple(map(torch.tensor, (u, w, g, v)))
    got = tiled.matern_mvm_bwd_pallas(*args)
    assert _rel(got.numpy(), want) <= OPS_BOUND
    assert _same(got, tiled.kernel_mvm_bwd_unit(*args, "matern32"))


def test_shim_and_package_exports_match_reference():
    """The shim's ``__all__`` is the reference shim's eight names, each
    bound to the port's own object; the package's ``__all__`` has the
    reference package's names, ``matern_mvm`` and ``matern_mvm_ref``
    among them, and resolves each."""
    assert tshim.__all__ == jshim.__all__
    assert len(tshim.__all__) == 8
    homes = {"matern_mvm": ops, "h_mvm": ops, "kernel_mvm": ops,
             "matern_mvm_ref": ref, "h_mvm_ref": ref, "kernel_mvm_ref": ref,
             "matern_mvm_pallas": tiled, "matern_mvm_bwd_pallas": tiled}
    for name in tshim.__all__:
        assert getattr(tshim, name) is getattr(homes[name], name), name
    assert sorted(tkernels.__all__) == sorted(jkernels.__all__)
    assert tkernels.matern_mvm is ops.matern_mvm
    assert tkernels.matern_mvm_ref is ref.matern_mvm_ref
