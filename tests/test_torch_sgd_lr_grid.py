"""The SGD learning-rate grid (paper Appendix B) on pol padded to the
batch, with the reference's data, probes and ``split``/``randint`` block
schedule handed over: per learning rate the final ``res_y + res_z`` of
the 3-epoch cold probe solve, the port's against the reference's, and
the picked learning rate.

The reference's per-lr residuals are read from its own
``pick_sgd_learning_rate`` (its ``solve`` calls recorded, the results
passed on unchanged), and its pick must be the largest lr of that table
below the threshold. The port runs ``pick_sgd_learning_rate(probes=,
batch_idx=, trials=)``. Both sides solve in fp32 with sums in other
orders (the reference's streamed tiles, the port's plain tiles of the
``cuda`` backend), and SGD carries the difference through every
iteration: each lr's residual sum, where both are finite and below the
divergence threshold, agrees to ``TOL_RES`` relative; at the lr where the
reference diverges the port must diverge too (at or above the
threshold, or not finite), which fixes the same pick. The cut case runs
in tier-1 and the ``slow`` cases at 4500 padded rows; full pol (12 150
training rows padded to 12 500, seeds 0 and 1) takes ~310 s a seed, so
its table comes from this file's own run, ``PYTHONPATH=src
JAX_PLATFORMS=cpu python tests/test_torch_sgd_lr_grid.py 0 0 1``
(``max_n``, then the seeds)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import OuterConfig as JOuterConfig  # noqa: E402
from repro.core import driver as j_driver  # noqa: E402
from repro.core.driver import SGD_LR_GRID as J_GRID  # noqa: E402
from repro.core.driver import pick_sgd_learning_rate as j_pick  # noqa: E402
from repro.core.estimators import init_probes as j_init_probes  # noqa: E402
from repro.data.synthetic import load_dataset as j_load  # noqa: E402
from repro.data.synthetic import pad_to_block_multiple as j_pad  # noqa: E402
from repro.gp.hyperparams import HyperParams as JHyperParams  # noqa: E402
from repro.solvers import SolverConfig as JSolverConfig  # noqa: E402
from repro.solvers import solve as j_solve  # noqa: E402
from repro_torch.core.driver import (  # noqa: E402
    SGD_DIVERGENCE_THRESHOLD,
    SGD_LR_GRID,
    pick_sgd_learning_rate,
)
from repro_torch.core.estimators import ProbeState  # noqa: E402
from repro_torch.core.outer import OuterConfig  # noqa: E402
from repro_torch.gp.hyperparams import HyperParams  # noqa: E402
from repro_torch.gp.rff import RFFState  # noqa: E402
from repro_torch.solvers import SolverConfig  # noqa: E402

BATCH = 500  # the train CLI's --batch-size
PROBE_EPOCHS = 3.0
TOL_RES = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread beside the other workers of a parallel run,
    restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _schedule(key, num_blocks, count):
    """The reference SGD's block indices: its loop body's
    ``key, sub = split(key); randint(sub, (), 0, nb)``, ``count`` times."""
    def body(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.randint(sub, (), 0, num_blocks)

    return np.asarray(jax.lax.scan(body, key, None, length=count)[1]).tolist()


def _port_probes(jp):
    def t(a):
        return None if a is None else torch.tensor(np.asarray(a))

    rff = None if jp.rff is None else RFFState(t(jp.rff.z), t(jp.rff.u),
                                               t(jp.rff.w), kind=jp.rff.kind)
    return ProbeState(jp.estimator, t(jp.z), rff, t(jp.w_eps))


def _grid_tables(max_n: int, seed: int) -> dict:
    """Both sides' per-lr residual sums and picks on pol (``max_n`` rows,
    0 for all) padded to the batch, as the train CLI runs the grid
    (``--solver sgd --pathwise --sgd-lr 0``: 64 probes, 1000 RFF pairs,
    the paper's initial hyperparameters, ``PRNGKey(seed)``). The
    reference's table is read from its own ``pick_sgd_learning_rate``,
    whose ``solve`` calls are recorded."""
    ds = j_load("pol", max_n=max_n)
    x, y, _ = j_pad(ds.x_train, ds.y_train, BATCH)
    n, d = x.shape
    jparams = JHyperParams.create(d)
    jcfg = JOuterConfig(estimator="pathwise", backend="streamed", bm=1024,
                        bn=1024, solver=JSolverConfig(name="sgd",
                                                      batch_size=BATCH))
    key = jax.random.PRNGKey(seed)
    ref = {}

    def recording(op, targets, v0, scfg, **kw):
        res = j_solve(op, targets, v0, scfg, **kw)
        ref[scfg.learning_rate] = float(res.res_y) + float(res.res_z)
        return res

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_driver, "solve", recording)
        ref_pick = j_pick(x, y, jparams, jcfg, key)
    probes = j_init_probes(key, jcfg.estimator, n, d, jcfg.num_probes,
                           jcfg.num_rff_pairs, kind=jparams.kernel,
                           dtype=x.dtype)

    tparams = HyperParams(*(torch.tensor(np.asarray(a)) for a in (
        jparams.raw_lengthscales, jparams.raw_signal, jparams.raw_noise)),
        kernel=jparams.kernel)
    tcfg = OuterConfig(estimator="pathwise", backend="cuda", bm=1024,
                       bn=1024, solver=SolverConfig(name="sgd",
                                                    batch_size=BATCH))
    iters = int(PROBE_EPOCHS * (n // BATCH))
    trials = []
    port_pick = pick_sgd_learning_rate(
        torch.tensor(np.asarray(x)), torch.tensor(np.asarray(y)), tparams,
        tcfg, probes=_port_probes(probes),
        batch_idx=_schedule(key, n // BATCH, iters), trials=trials)
    port = {lr: float(r.res_y) + float(r.res_z) for lr, r in trials}
    return {"n": n, "ref": ref, "ref_pick": ref_pick, "port": port,
            "port_pick": port_pick}


def _print_table(t: dict, seed: int) -> None:
    ref, port = t["ref"], t["port"]
    print(f"\npol n={t['n']} seed={seed}: lr, reference, port res_y + res_z"
          f" (picks {t['ref_pick']}, {t['port_pick']})")
    for lr in sorted(set(ref) | set(port)):
        print(f"  {lr:5.1f}  {ref.get(lr, float('nan')):.9g}  "
              f"{port.get(lr, float('nan')):.9g}")


# pol cut to 1200 rows (1080 training rows padded to 1500); the slow cases
# at 4723 rows (4250 padded to 4500), the largest that stays near 70 s on
# one worker: full pol takes ~310 s a seed, so its table is this file's
# one-off run (see __main__).
@pytest.mark.parametrize("max_n, seed", [
    (1200, 0),
    pytest.param(4723, 0, marks=pytest.mark.slow),
    pytest.param(4723, 1, marks=pytest.mark.slow),
])
def test_sgd_lr_grid_matches_reference_with_its_draws(max_n, seed):
    """Same draws, same per-lr residual sums (to ``TOL_RES``) and the
    same pick."""
    t = _grid_tables(max_n, seed)
    ref, port = t["ref"], t["port"]
    _print_table(t, seed)
    assert sorted(SGD_LR_GRID) == sorted(J_GRID)
    assert list(ref) == list(port), "the grids stopped at different lrs"
    below = [lr for lr, r in ref.items()
             if math.isfinite(r) and r < SGD_DIVERGENCE_THRESHOLD]
    assert t["ref_pick"] == (below[-1] if below else sorted(J_GRID)[0])
    for lr in below:
        assert abs(port[lr] - ref[lr]) <= TOL_RES * ref[lr], (lr, port[lr],
                                                              ref[lr])
    last = list(ref)[-1]
    if last not in below:
        assert not (math.isfinite(port[last])
                    and port[last] < SGD_DIVERGENCE_THRESHOLD), (last, port)
    assert t["port_pick"] == t["ref_pick"]


if __name__ == "__main__":
    import sys

    torch.set_num_threads(1)
    rows, *seeds = (int(a) for a in sys.argv[1:])
    for s in seeds or [0]:
        _print_table(_grid_tables(rows, s), s)
