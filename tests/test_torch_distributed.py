"""The port's distributed path against the JAX reference: the ring MVM
(two- and three-axis meshes, four kernels), its gradient, bf16 rotating
buffers, two distributed GP outer steps, distributed AP, lane-sharded
``fit_batch`` and the batch CLI's ``--shard-lanes``, the mesh helpers,
elastic re-sharding, bf16 error feedback, the streamed H-MVMs and an
operator whose full MVM is the ring.

The reference runs where its own distributed tests run it: in one
``python -c`` subprocess for this module, with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` set before JAX is
imported (``tests/test_distributed.py``'s pattern), writing its outputs to
an ``.npz``. Its inputs are made here from a seed with numpy and handed
over in another ``.npz``; for the lane sweep it builds the reference
test's own ``_grid_problem`` (``tests/test_sharded_lanes.py``) and hands
over the data, the initial lane states and each lane's SGD schedule. The
port runs in this process on virtual CPU meshes
(``make_mesh(..., devices=["cpu"] * 8)``), where every tile is the
forward kernel's plain version.

Tolerances, each relative to the largest entry of the compared quantity
unless stated: the ring against the reference's ring 1e-5 (both fp32; the
sums run in other orders and the reference takes ``r2`` in the expanded
form); Matérn-1/2 against float64 at 1e-4 instead (the reference's
expanded ``r2`` leaves ~3e-4 on the diagonal, ROADMAP Queue 3); the
gradient 1e-4 (fp32 sums over P^2 tiles of both); bf16 buffers against
the reference's bf16 ring at 2e-2 in relative Frobenius norm (its tiles
round r2, the profile and every entry to bf16, 2^-8 = 3.9e-3 each, and sit
~1.1e-2 from the exact product; the port's tiles are fp32), and against
float64 on the bf16-rounded buffers at 1e-5 (the port's own semantics);
the GP steps
and AP at the reference tests' bounds (hyperparameters rtol 1e-4 / atol
1e-6, solutions 1e-3, residual norms rtol 1e-2); lanes at
``tests/test_sharded_lanes.py``'s (iterations equal, hypers rtol 1e-4 /
atol 1e-6, ``res_y`` rtol 1e-2 / atol 1e-5); compression bitwise.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.gp.hyperparams import HyperParams as JHyperParams  # noqa: E402
from repro.gp.kernels_math import h_mvm_dense as j_h_mvm_dense  # noqa: E402
from repro.gp.kernels_math import h_mvm_streamed as j_h_mvm_streamed  # noqa: E402
from repro.gp.kernels_math import (  # noqa: E402
    kernel_mvm_streamed as j_kernel_mvm_streamed,
)
from repro.kernels.registry import available_kernels as j_available  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.core.driver import fit_batch  # noqa: E402
from repro_torch.core.outer import OuterConfig, init_outer_state  # noqa: E402
from repro_torch.distributed import (  # noqa: E402
    EFState,
    compress,
    decompress,
    ef_init,
    reshard,
    row_sharded_builder,
    shard_rows,
    unshard,
    valid_spec,
)
from repro_torch.distributed.ap import distributed_ap_sweeps  # noqa: E402
from repro_torch.distributed.gp_step import make_gp_outer_step  # noqa: E402
from repro_torch.distributed.ring import (  # noqa: E402
    global_col_norms,
    ring_h_mvm,
    ring_kernel_mvm,
    ring_moves,
)
from repro_torch.distributed.sharding import RowSharded, row_axes  # noqa: E402
from repro_torch.gp import (  # noqa: E402
    h_mvm_dense,
    h_mvm_streamed,
    kernel_mvm_streamed,
)
from repro_torch.gp.hyperparams import HyperParams  # noqa: E402
from repro_torch.gp.kernels_math import regularised_kernel_matrix  # noqa: E402
from repro_torch.gp.rff import RFFState  # noqa: E402
from repro_torch.kernels import available_kernels  # noqa: E402
from repro_torch.launch import batch  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_host_mesh,
    make_lane_mesh,
    make_mesh,
)
from repro_torch.solvers import HOperator, SolverConfig, solve  # noqa: E402
from repro_torch.solvers.base import strip_numerics  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("rbf", "matern12", "matern32", "matern52")
MESHES = {"m2": ((4, 2), ("data", "model")),
          "m3": ((2, 2, 2), ("pod", "data", "model"))}
RING_SHAPES = ((64, 3, 5), (240, 26, 9))
GRAD_SHAPE = (32, 2, 3)
STEP_SHAPE = (64, 2, 4)  # n, d, probes; 5 CG epochs a step
AP_SHAPE = (128, 2, 3, 8)  # n, d, probes, block: n_loc = 16, 2 blocks/shard
FB_LANES = 8

TOL_RING = 1e-5
TOL_F64 = 1e-4
TOL_GRAD = 1e-4
TOL_BF16_REF = 2e-2
HYP_RTOL, HYP_ATOL = 1e-4, 1e-6
V_REL = 1e-3
RES_RTOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops per ring step; one torch thread beside the
    other workers of a parallel run, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _raw_params(rng, d):
    return {"raw_ls": rng.uniform(-0.3, 0.8, size=d).astype(np.float32),
            "raw_signal": np.float32(0.6), "raw_noise": np.float32(-0.4)}


def _make_inputs() -> dict:
    rng = np.random.default_rng(20)
    inp = {}
    for n, d, s in RING_SHAPES:
        scale = 1.0 if d < 10 else 0.3  # kernel values spread over (0, 1]
        inp[f"ring/{n}/x"] = (scale * rng.normal(size=(n, d))).astype(np.float32)
        inp[f"ring/{n}/v"] = rng.normal(size=(n, s)).astype(np.float32)
        for k, val in _raw_params(rng, d).items():
            inp[f"ring/{n}/{k}"] = val
    n, d, s = GRAD_SHAPE
    inp["grad/x"] = rng.normal(size=(n, d)).astype(np.float32)
    inp["grad/v"] = rng.normal(size=(n, s)).astype(np.float32)
    for k, val in _raw_params(rng, d).items():
        inp[f"grad/{k}"] = val
    n, d, s = STEP_SHAPE
    x = rng.uniform(-1.5, 1.5, size=(n, d)).astype(np.float32)
    inp["step/x"] = x
    inp["step/y"] = (np.sin(2.0 * x[:, 0]) * np.cos(x[:, 1])
                     + 0.3 * rng.normal(size=n)).astype(np.float32)
    inp["step/w_eps"] = rng.normal(size=(n, s)).astype(np.float32)
    inp["step/rff_z"] = rng.normal(size=(64, d)).astype(np.float32)
    inp["step/rff_u"] = rng.chisquare(3.0, size=64).astype(np.float32)
    inp["step/rff_w"] = rng.normal(size=(128, s)).astype(np.float32)
    n, d, s, _ = AP_SHAPE
    inp["ap/x"] = rng.uniform(-1.5, 1.5, size=(n, d)).astype(np.float32)
    inp["ap/rhs"] = rng.normal(size=(n, 1 + s)).astype(np.float32)
    inp["ef/g_w"] = (1e-3 * rng.normal(size=(64, 64))).astype(np.float32)
    inp["ef/g_b"] = rng.normal(size=(7,)).astype(np.float32)
    inp["ef/r_w"] = (1e-6 * rng.normal(size=(64, 64))).astype(np.float32)
    inp["ef/r_b"] = (1e-3 * rng.normal(size=(7,))).astype(np.float32)
    return inp


# The reference's side, run once for the module with 8 forced host devices.
REF_SCRIPT = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import fit_batch, init_outer_state_lanes
from repro.distributed.ap import distributed_ap_sweeps
from repro.distributed.compression import EFState, compress
from repro.distributed.gp_step import GPStepState, make_gp_outer_step
from repro.distributed.ring import ring_h_mvm, ring_kernel_mvm
from repro.gp.hyperparams import HyperParams
from repro.gp.rff import RFFState
from repro.train.adam import adam_init

sys.path.insert(0, os.path.join(os.environ["REPRO_ROOT"], "tests"))
from test_sharded_lanes import _grid_problem

assert len(jax.devices()) == 8
inp = dict(np.load(sys.argv[1]))
cfg = json.loads(sys.argv[3])
out = {}


def flat(prefix, obj):
    if obj is None:
        return
    if isinstance(obj, dict):
        for k, v in obj.items():
            flat(f"{prefix}/{k}", v)
    else:
        out[prefix] = np.asarray(obj)


def params_of(tag, kind="matern32"):
    return HyperParams(jnp.asarray(inp[tag + "/raw_ls"]),
                       jnp.asarray(inp[tag + "/raw_signal"]),
                       jnp.asarray(inp[tag + "/raw_noise"]), kernel=kind)


def np_params(p):
    return {"raw_lengthscales": p.raw_lengthscales, "raw_signal": p.raw_signal,
            "raw_noise": p.raw_noise, "kernel": p.kernel}


meshes = {name: jax.make_mesh(tuple(shape), tuple(axes))
          for name, (shape, axes) in cfg["meshes"].items()}


def rows(mesh):
    axes = tuple(a for a in ("pod", "data", "model") if a in mesh.shape)
    return NamedSharding(mesh, P(axes, None)), NamedSharding(mesh, P(axes))


for mname, mesh in meshes.items():
    sh, _ = rows(mesh)
    for n, d, s in cfg["ring_shapes"]:
        x = jax.device_put(jnp.asarray(inp[f"ring/{n}/x"]), sh)
        v = jax.device_put(jnp.asarray(inp[f"ring/{n}/v"]), sh)
        for kind in cfg["kinds"]:
            p = params_of(f"ring/{n}", kind)
            f = jax.jit(lambda a, b: ring_kernel_mvm(a, b, p, mesh, kind=kind))
            out[f"ring/{mname}/{n}/{kind}"] = np.asarray(f(x, v))
            if mname == "m2" and n == 240 and kind in ("rbf", "matern32"):
                fb = jax.jit(lambda a, b: ring_kernel_mvm(
                    a, b, p, mesh, kind=kind, tile_dtype=jnp.bfloat16))
                out[f"bf16/{kind}"] = np.asarray(fb(x, v))

mesh = meshes["m2"]
sh, sh1 = rows(mesh)
xg = jax.device_put(jnp.asarray(inp["grad/x"]), sh)
vg = jax.device_put(jnp.asarray(inp["grad/v"]), sh)
for kind in cfg["kinds"]:
    p = params_of("grad", kind)
    g = jax.jit(jax.grad(lambda q: jnp.sum(
        vg * ring_h_mvm(xg, vg, q, mesh, kind=kind))))(p)
    flat(f"grad/{kind}", np_params(g))

n, d, s = cfg["step_shape"]
params = HyperParams.create(d)
state = GPStepState(params=params, adam=adam_init(params),
                    carry_v=jax.device_put(jnp.zeros((n, 1 + s)), sh),
                    res_y=jnp.zeros(()), res_z=jnp.zeros(()))
flat("step/init", np_params(params))
rff = RFFState(z=jnp.asarray(inp["step/rff_z"]), u=jnp.asarray(inp["step/rff_u"]),
               w=jnp.asarray(inp["step/rff_w"]), kind="matern32")
xs = jax.device_put(jnp.asarray(inp["step/x"]), sh)
ys = jax.device_put(jnp.asarray(inp["step/y"]), sh1)
ws = jax.device_put(jnp.asarray(inp["step/w_eps"]), sh)
step = jax.jit(make_gp_outer_step(mesh, s, solver_epochs=cfg["step_epochs"]))
for i in (1, 2):
    state = step(state, xs, ys, rff, ws)
    flat(f"step/{i}", {"params": np_params(state.params),
                       "adam": {"step": state.adam.step,
                                "mu": np_params(state.adam.mu),
                                "nu": np_params(state.adam.nu)},
                       "carry_v": state.carry_v, "res_y": state.res_y,
                       "res_z": state.res_z})

n, d, s, b = cfg["ap_shape"]
params = HyperParams.create(d, noise=0.5)
flat("ap/params", np_params(params))
xa = jax.device_put(jnp.asarray(inp["ap/x"]), sh)
ba = jax.device_put(jnp.asarray(inp["ap/rhs"]), sh)
ap = jax.jit(lambda xx, bb, vv: distributed_ap_sweeps(
    xx, bb, vv, params, mesh, block_size=b, num_iters=10, omega=0.3))
v1, r1 = ap(xa, ba, jax.device_put(jnp.zeros_like(ba), sh))
v2, r2 = ap(xa, ba, v1)
flat("ap", {"v1": v1, "r1": r1, "v2": v2, "r2": r2})

x, y, fcfg, cells, keys, nums = _grid_problem()
states = init_outer_state_lanes(keys, fcfg, x)
pr = states.probes
flat("fb", {"x": x, "y": y, "nums": nums._asdict()})
flat("fb/state", {
    "params": np_params(states.params),
    "adam": {"step": states.adam.step, "mu": np_params(states.adam.mu),
             "nu": np_params(states.adam.nu)},
    "probes": {"estimator": pr.estimator,
               "rff": {"z": pr.rff.z, "u": pr.rff.u, "w": pr.rff.w,
                       "kind": pr.rff.kind},
               "w_eps": pr.w_eps},
    "carry_v": states.carry_v, "step": states.step})


def schedule(key, num_blocks, count):
    def body(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.randint(sub, (), 0, num_blocks)
    return jax.lax.scan(body, key, None, length=count)[1]


nb = x.shape[0] // fcfg.solver.batch_size
count = cfg["fb_iters"]
scheds, lane_keys = [], states.key
for _ in range(fcfg.num_steps):
    split = jax.vmap(lambda k: jax.random.split(k, 3))(lane_keys)
    lane_keys = split[:, 0]
    scheds.append(np.stack([np.asarray(schedule(k, nb, count))
                            for k in split[:, 1]]))
out["fb/sched"] = np.stack(scheds)
res = fit_batch(x, y, fcfg, keys, numerics=nums)
for i, r in enumerate(res):
    for k in ("iters", "hypers", "res_y"):
        out[f"fb/hist/{i}/{k}"] = np.asarray(r.history[k])
out["fb/cfg"] = np.asarray(repr(fcfg))

q, st = compress({"w": jnp.asarray(inp["ef/g_w"]), "b": jnp.asarray(inp["ef/g_b"])},
                 EFState(residual={"w": jnp.asarray(inp["ef/r_w"]),
                                   "b": jnp.asarray(inp["ef/r_b"])}))
for k in ("w", "b"):
    out[f"ef/q_{k}"] = np.asarray(q[k].astype(jnp.float32))
    out[f"ef/r_{k}"] = np.asarray(st.residual[k])

np.savez(sys.argv[2], **out)
print("REF_OK")
'''


def _nested(res, prefix: str) -> dict:
    """The entries of ``res`` under ``prefix/`` as nested dicts (0-d
    unicode arrays back to strings)."""
    tree = {}
    for key in res:
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        val = res[key]
        node[parts[-1]] = val.item() if val.dtype.kind == "U" else val
    return tree


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs (one subprocess, 8 forced host devices) and
    the inputs handed to both."""
    tmp = tmp_path_factory.mktemp("dist_ref")
    inp = _make_inputs()
    np.savez(tmp / "in.npz", **inp)
    cfg = {"meshes": MESHES, "ring_shapes": RING_SHAPES, "kinds": KINDS,
           "step_shape": STEP_SHAPE, "step_epochs": 5, "ap_shape": AP_SHAPE,
           "fb_iters": 80}
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "REPRO_ROOT": REPO, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz"), json.dumps(cfg)],
        capture_output=True, text=True, env=env, timeout=900)
    assert r.returncode == 0 and "REF_OK" in r.stdout, (
        f"STDOUT:\n{r.stdout[-3000:]}\nSTDERR:\n{r.stderr[-3000:]}")
    with np.load(tmp / "out.npz") as f:
        out = {k: f[k] for k in f.files}
    return inp, out


# -- helpers ------------------------------------------------------------------


def _cpu_mesh(name: str):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def _params(inp, tag, kind="matern32") -> HyperParams:
    return HyperParams(torch.tensor(inp[f"{tag}/raw_ls"]),
                       torch.tensor(inp[f"{tag}/raw_signal"]),
                       torch.tensor(inp[f"{tag}/raw_noise"]), kernel=kind)


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _dense64(x, v, params: HyperParams, kind: str) -> np.ndarray:
    """K(x, x) @ v in float64 numpy, r2 by direct differences."""
    ell = params.lengthscales.double().numpy()
    u = np.asarray(x, np.float64) / ell
    r2 = ((u[:, None, :] - u[None, :, :]) ** 2).sum(-1)
    r = np.sqrt(r2)
    kappa = {"rbf": np.exp(-0.5 * r2), "matern12": np.exp(-r),
             "matern32": (1 + np.sqrt(3) * r) * np.exp(-np.sqrt(3) * r),
             "matern52": (1 + np.sqrt(5) * r + 5 / 3 * r2)
             * np.exp(-np.sqrt(5) * r)}[kind]
    return float(params.signal.double()) ** 2 * kappa @ np.asarray(v, np.float64)


# -- the ring -----------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("n", [s[0] for s in RING_SHAPES])
@pytest.mark.parametrize("kind", KINDS)
def test_ring_mvm_matches_reference_ring(ref, mesh_name, n, kind):
    """ring_kernel_mvm on 8 virtual CPU shards against the reference's
    ring on 8 forced host devices (Matérn-1/2 against float64)."""
    inp, out = ref
    mesh = _cpu_mesh(mesh_name)
    params = _params(inp, f"ring/{n}", kind)
    x, v = inp[f"ring/{n}/x"], inp[f"ring/{n}/v"]
    got = ring_kernel_mvm(shard_rows(torch.tensor(x), mesh),
                          shard_rows(torch.tensor(v), mesh), params, mesh,
                          kind=kind)
    assert isinstance(got, RowSharded) and got.shape == v.shape
    got = got.gather("cpu").numpy()
    if kind == "matern12":
        assert _max_rel(got, _dense64(x, v, params, kind)) < TOL_F64
    else:
        assert _max_rel(got, out[f"ring/{mesh_name}/{n}/{kind}"]) < TOL_RING


def test_ring_schedule_visits_every_shard_once():
    """Each position's tiles see every home position once, in the
    reference's order (innermost axis fastest); P - 1 moves for P tiles."""
    for name in MESHES:
        mesh = _cpu_mesh(name)
        moves = ring_moves(mesh, row_axes(mesh))
        assert len(moves) == mesh.size - 1
        home, seen = list(range(mesh.size)), [[p] for p in range(mesh.size)]
        for src in moves:
            home = [home[q] for q in src]
            for p in range(mesh.size):
                seen[p].append(home[p])
        for p in range(mesh.size):
            assert sorted(seen[p]) == list(range(mesh.size))
        # the first move is one step of the innermost axis
        inner = row_axes(mesh)[-1]
        c = mesh.coords(0)
        c[inner] = mesh.shape[inner] - 1
        assert moves[0][0] == mesh.position(c)


@pytest.mark.parametrize("kind", KINDS)
def test_ring_gradient_matches_reference_grad(ref, kind):
    """Autograd of sum(v * ring_h_mvm(x, v)) through the ring (the tiles'
    backward) against ``jax.grad`` of the reference's ring (Matérn-1/2
    against float64 autograd of the dense H)."""
    inp, out = ref
    mesh = _cpu_mesh("m2")
    params = _params(inp, "grad", kind)
    p = params.with_leaves([t.clone().requires_grad_(True)
                            for t in params.leaves])
    xs = shard_rows(torch.tensor(inp["grad/x"]), mesh)
    vs = shard_rows(torch.tensor(inp["grad/v"]), mesh)
    quad = (vs * ring_h_mvm(xs, vs, p, mesh, kind=kind)).col_sum().sum()
    got = torch.autograd.grad(quad, p.leaves)
    if kind == "matern12":
        p64 = params.with_leaves([t.double().requires_grad_(True)
                                  for t in params.leaves])
        x64, v64 = (torch.tensor(inp[k]).double() for k in ("grad/x",
                                                              "grad/v"))
        q64 = torch.sum(v64 * (regularised_kernel_matrix(x64, p64) @ v64))
        want = [g.numpy() for g in torch.autograd.grad(q64, p64.leaves)]
    else:
        g = out
        want = [g[f"grad/{kind}/{k}"] for k in ("raw_lengthscales",
                                               "raw_signal", "raw_noise")]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL_GRAD,
                                   atol=TOL_GRAD * np.max(np.abs(b)))


@pytest.mark.parametrize("kind", ["rbf", "matern32"])
def test_ring_bf16_buffers(ref, kind):
    """bf16 rotating buffers: against the reference's bf16 ring (bf16
    tiles there), and against float64 on the bf16-rounded buffers (the
    port's tiles stay fp32)."""
    inp, out = ref
    mesh = _cpu_mesh("m2")
    params = _params(inp, "ring/240", kind)
    x, v = inp["ring/240/x"], inp["ring/240/v"]
    got = ring_kernel_mvm(torch.tensor(x), torch.tensor(v), params, mesh,
                          kind=kind, tile_dtype=torch.bfloat16)
    got = got.gather("cpu").numpy()
    assert _rel(got, out[f"bf16/{kind}"]) < TOL_BF16_REF
    xb = torch.tensor(x).to(torch.bfloat16).float().numpy()
    vb = torch.tensor(v).to(torch.bfloat16).float().numpy()
    n_loc = x.shape[0] // mesh.size
    want = np.concatenate([
        _dense_cross64(x[i:i + n_loc], xb, vb, params, kind)
        for i in range(0, x.shape[0], n_loc)])
    assert _max_rel(got, want) < TOL_RING


def _dense_cross64(x1, x2, v, params, kind):
    """K(x1, x2) @ v in float64 numpy (direct differences)."""
    ell = params.lengthscales.double().numpy()
    u, w = np.asarray(x1, np.float64) / ell, np.asarray(x2, np.float64) / ell
    r2 = ((u[:, None, :] - w[None, :, :]) ** 2).sum(-1)
    r = np.sqrt(r2)
    kappa = {"rbf": np.exp(-0.5 * r2),
             "matern32": (1 + np.sqrt(3) * r) * np.exp(-np.sqrt(3) * r)}[kind]
    return float(params.signal.double()) ** 2 * kappa @ np.asarray(v, np.float64)


def test_ring_refuses_inputs_that_need_grad_and_nondividing_rows():
    mesh = _cpu_mesh("m2")
    params = HyperParams.create(2)
    x = torch.randn(16, 2, requires_grad=True)
    with pytest.raises(ValueError, match="hyperparameters only"):
        ring_kernel_mvm(x, torch.randn(16, 1), params, mesh)
    with pytest.raises(ValueError, match="divide"):
        shard_rows(torch.randn(12, 2), mesh)


# -- the distributed GP step and AP ------------------------------------------------


def test_gp_outer_steps_match_reference(ref):
    """Two warm-started distributed steps from the reference's initial
    state, with its RFF draws and w_eps: params and Adam moments within
    rtol 1e-4 / atol 1e-6, carry_v within 1e-3 relative, res_y and res_z
    within rtol 1e-2; res_z falls from step 1 to step 2."""
    inp, out = ref
    mesh = _cpu_mesh("m2")
    n, d, s = STEP_SHAPE
    init = _nested(out, "step/init")
    zeros = {k: np.zeros_like(v) if k != "kernel" else v
             for k, v in init.items()}
    state = interop.gp_step_state_from_numpy(
        {"params": init, "adam": {"step": np.asarray(0), "mu": zeros,
                                  "nu": zeros},
         "carry_v": np.zeros((n, 1 + s), np.float32),
         "res_y": np.float32(0), "res_z": np.float32(0)}, mesh)
    rff = RFFState(z=torch.tensor(inp["step/rff_z"]),
                   u=torch.tensor(inp["step/rff_u"]),
                   w=torch.tensor(inp["step/rff_w"]), kind="matern32")
    x = shard_rows(torch.tensor(inp["step/x"]), mesh)
    y = shard_rows(torch.tensor(inp["step/y"]), mesh)
    w_eps = shard_rows(torch.tensor(inp["step/w_eps"]), mesh)
    step = make_gp_outer_step(mesh, s, solver_epochs=5)
    res_z = []
    for i in (1, 2):
        state = step(state, x, y, rff, w_eps)
        got, want = interop.gp_step_state_to_numpy(state), _nested(out,
                                                                   f"step/{i}")
        for tree in ("params", "mu", "nu"):
            g = got[tree] if tree == "params" else got["adam"][tree]
            w = want[tree] if tree == "params" else want["adam"][tree]
            for k in ("raw_lengthscales", "raw_signal", "raw_noise"):
                np.testing.assert_allclose(g[k], w[k], rtol=HYP_RTOL,
                                           atol=HYP_ATOL, err_msg=f"{i} {tree}")
        assert int(got["adam"]["step"]) == int(want["adam"]["step"]) == i
        assert _rel(got["carry_v"], want["carry_v"]) < V_REL
        for k in ("res_y", "res_z"):
            np.testing.assert_allclose(got[k], want[k], rtol=RES_RTOL)
        res_z.append(float(got["res_z"]))
    assert np.isfinite(res_z).all() and res_z[1] < res_z[0]


def _small_pol_steps(positions: int) -> tuple:
    """Three 8-epoch distributed steps on 600 pol rows (16 probes, 256 RFF
    pairs) over ``positions`` CPU positions: the Adam first moment and
    the hyperparameters after each step."""
    from repro_torch.data.synthetic import load_dataset
    from repro_torch.distributed.gp_step import GPStepState
    from repro_torch.gp.rff import init_rff
    from repro_torch.train.adam import adam_init

    ds = load_dataset("pol", max_n=667, device="cpu")
    x, y = ds.x_train, ds.y_train
    n, d = x.shape
    g = torch.Generator().manual_seed(5)
    rff = init_rff(g, 256, d, 16, kind="matern32")
    w_eps = torch.randn((n, 16), generator=g)
    shape = (5, 2) if positions == 10 else (1, 1)
    mesh = make_mesh(shape, ("data", "model"), devices=["cpu"] * positions)
    params = HyperParams.create(d, lengthscale=4.0)
    state = GPStepState(params, adam_init(params),
                        shard_rows(torch.zeros((n, 17)), mesh),
                        torch.zeros(()), torch.zeros(()))
    xs, ys, ws = (shard_rows(t, mesh) for t in (x, y, w_eps))
    step = make_gp_outer_step(mesh, 16, solver_epochs=8)
    mu, hypers = [], []
    for _ in range(3):
        state = step(state, xs, ys, rff, ws)
        mu.append(torch.cat([m.reshape(-1) for m in state.adam.mu.leaves]))
        hypers.append(state.params.flat())
    return mu, hypers


# The small card-vs-CPU gate of chip_smoke.py's distributed phase. On the
# CPU alone, P = 10 against P = 1 (only the order of the sums differs) puts
# the gradients' components 2.4e-5 of the largest apart in absolute terms,
# all alike, so a near-zero component (|mu| 1.3e-3 against a largest 14)
# differs by 23 % of itself. Adam's update, lr * mu / sqrt(nu), is
# normalised per component, so that component's hyperparameter moves
# 4.1e-3 apart after 3 steps (1.0e-3 of the largest): the hyperparameters
# of sound runs are 1.0e-3 apart, the moments are held per component.
MU_ATOL, MU_RTOL = 5e-5, 1e-2  # atol: of the largest |mu|
HYPERS_SMALL_STEPS = 3e-3


def test_gp_steps_ten_positions_against_one_small_pol():
    """P = 10 against P = 1 at 600 rows for 3 steps: the Adam first
    moments per component within MU_RTOL of themselves plus MU_ATOL of the
    largest; the hyperparameters within HYPERS_SMALL_STEPS of the largest;
    and the hyperparameter that moves most apart is the one whose gradient
    is smallest (Adam's normalised update amplifying the rounding of a
    near-zero gradient)."""
    mu10, h10 = _small_pol_steps(10)
    mu1, h1 = _small_pol_steps(1)
    for a, b in zip(mu10, mu1):
        gap = (a - b).abs()
        assert bool(torch.all(gap <= MU_ATOL * b.abs().max()
                              + MU_RTOL * b.abs())), gap / b.abs().max()
    gap = (h10[-1] - h1[-1]).abs()
    assert float(gap.max() / h1[-1].abs().max()) <= HYPERS_SMALL_STEPS
    assert int(gap.argmax()) == int(mu1[0].abs().argmin())


def test_distributed_ap_matches_reference(ref):
    """The reference test's AP: v and r within 1e-3 relative of the
    reference's; the tracked residual equals b - H v (1e-3, the reference
    test's bound); a warm continuation decreases it."""
    inp, out = ref
    mesh = _cpu_mesh("m2")
    n, d, s, b = AP_SHAPE
    params = interop._params(_nested(out, "ap/params"), "cpu")
    x, rhs = torch.tensor(inp["ap/x"]), torch.tensor(inp["ap/rhs"])
    v1, r1 = distributed_ap_sweeps(x, rhs, torch.zeros_like(rhs), params, mesh,
                                   block_size=b, num_iters=10, omega=0.3)
    v2, r2 = distributed_ap_sweeps(x, rhs, v1, params, mesh, block_size=b,
                                   num_iters=10, omega=0.3)
    for name, got in (("v1", v1), ("r1", r1), ("v2", v2), ("r2", r2)):
        assert _rel(got.gather("cpu"), out[f"ap/{name}"]) < V_REL, name
    h = regularised_kernel_matrix(x, params)
    r_true = rhs - h @ v1.gather("cpu")
    np.testing.assert_allclose(r1.gather("cpu").numpy(), r_true.numpy(),
                               rtol=1e-3, atol=1e-3)

    def relres(r):
        return float(torch.max(global_col_norms(r) / rhs.norm(dim=0)))

    assert relres(r1) < 1.0 and relres(r2) < relres(r1)


def test_distributed_ap_refuses_nondividing_block():
    mesh = _cpu_mesh("m2")
    x, b = torch.randn(64, 2), torch.randn(64, 3)
    with pytest.raises(ValueError, match="block_size=3"):
        distributed_ap_sweeps(x, b, torch.zeros_like(b), HyperParams.create(2),
                              mesh, block_size=3, num_iters=1)


def test_operator_on_the_ring_matches_plain_cg():
    """CG on an HOperator whose full MVM is the ring over a virtual mesh
    equals CG on the ``cuda`` backend's plain version: iterations equal,
    solutions within 1e-3 relative (the lane tests' bound for two solves
    whose MVMs sum in other orders; 21 iterations amplify the fp32
    difference to ~1e-4)."""
    mesh = _cpu_mesh("m3")
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.uniform(-1, 1, size=(96, 3)).astype(np.float32))
    b = torch.tensor(rng.normal(size=(96, 4)).astype(np.float32))
    params = HyperParams.create(3, noise=0.5)
    cfg = SolverConfig(name="cg", tolerance=1e-3, max_epochs=50,
                       precond_rank=0)

    def ring(v):
        return ring_kernel_mvm(x, v, params, mesh).gather("cpu")

    plain = solve(HOperator(x=x, params=params, backend="cuda"), b, None, cfg)
    got = solve(HOperator(x=x, params=params, backend="cuda",
                          kernel_mvm_override=ring), b, None, cfg)
    assert int(got.iters) == int(plain.iters) > 1
    assert _rel(got.v, plain.v) < V_REL


# -- lanes over a mesh ---------------------------------------------------------------


def _fb_inputs(out):
    x, y = torch.tensor(out["fb/x"]), torch.tensor(out["fb/y"])
    states = interop.outer_state_from_numpy(_nested(out, "fb/state"))
    nums = interop.numerics_from_numpy(_nested(out, "fb/nums"))
    base = SolverConfig(name="sgd", tolerance=0.01, max_epochs=40,
                        batch_size=32, learning_rate=0.5)
    cfg = OuterConfig(estimator="pathwise", warm_start=True, num_steps=3,
                      num_probes=4, num_rff_pairs=64, bm=64, bn=64,
                      solver=strip_numerics(base), backend="cuda")
    return x, y, cfg, states, nums


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_fit_batch_matches_reference_unsharded(ref, k):
    """fit_batch(mesh=make_lane_mesh(devices=["cpu"] * k)) on the
    reference's 8-lane SGD grid, from its initial lane states with each
    lane's schedule handed over, against the reference's unsharded
    fit_batch: iterations equal, hypers rtol 1e-4 / atol 1e-6, res_y rtol
    1e-2 / atol 1e-5 (tests/test_sharded_lanes.py's bounds)."""
    _, out = ref
    x, y, cfg, states, nums = _fb_inputs(out)
    assert "batch_size=32" in str(out["fb/cfg"])
    got = fit_batch(x, y, cfg, list(range(FB_LANES)), states=states,
                    numerics=nums, batch_idx=list(out["fb/sched"]),
                    mesh=make_lane_mesh(devices=["cpu"] * k))
    assert len(got) == FB_LANES
    for i in range(FB_LANES):
        want = _nested(out, f"fb/hist/{i}")
        np.testing.assert_array_equal(got[i].history["iters"], want["iters"],
                                      err_msg=f"lane {i} iters")
        np.testing.assert_allclose(got[i].history["hypers"], want["hypers"],
                                   rtol=HYP_RTOL, atol=HYP_ATOL,
                                   err_msg=f"lane {i} hypers")
        np.testing.assert_allclose(got[i].history["res_y"], want["res_y"],
                                   rtol=RES_RTOL, atol=1e-5,
                                   err_msg=f"lane {i} res_y")


def test_fit_batch_lanes_must_divide_the_mesh(ref):
    _, out = ref
    x, y, cfg, states, nums = _fb_inputs(out)
    with pytest.raises(ValueError, match="multiple of the lane-mesh device "
                                         "count 3"):
        fit_batch(x, y, cfg, list(range(FB_LANES)), states=states,
                  numerics=nums, mesh=make_lane_mesh(devices=["cpu"] * 3))


def test_batch_cli_shard_lanes_on_the_cpu(tmp_path):
    """``--shard-lanes --device cpu`` runs every group on the one-CPU lane
    mesh and reports it; each cell is bitwise the unsharded run's (one
    group on one device is the same lane-stacked run)."""
    argv = ["--dataset", "pol", "--max-n", "128", "--kernels", "matern32",
            "--seeds", "2", "--steps", "2", "--smoke", "--bm", "64", "--bn",
            "64", "--tolerances", "0.05,0.01", "--device", "cpu",
            "--expect-one-compile-per-group"]
    assert batch.main(["--out", str(tmp_path / "s"), "--shard-lanes",
                       *argv]) == 0
    assert batch.main(["--out", str(tmp_path / "u"), *argv]) == 0
    status = json.loads((tmp_path / "s" / "_sweep_status.json").read_text())
    assert status["shard_devices"] == 1 and status["sharded_groups"] == 1
    assert status["cells"] == 4 and not status["failures"]
    plain = json.loads((tmp_path / "u" / "_sweep_status.json").read_text())
    assert plain["shard_devices"] == 0 and plain["sharded_groups"] == 0
    cells = sorted((tmp_path / "u").glob("gp-iterative-*.json"))
    assert len(cells) == 4
    for f in cells:
        a = json.loads(f.read_text())
        b = json.loads((tmp_path / "s" / f.name).read_text())
        assert a["final_hypers"] == b["final_hypers"]
        assert a["history"]["iters"] == b["history"]["iters"]
        assert a["history"]["res_y"] == b["history"]["res_y"]


# -- meshes, specs, elastic, compression ---------------------------------------------------


def test_mesh_builders_raise_without_the_cards():
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="visible"):
        make_mesh((visible + 1,), ("lanes",))
    with pytest.raises(RuntimeError, match="visible"):
        make_lane_mesh(num_devices=visible + 1)
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh((4, 2), ("data", "model"), devices=["cpu"] * 7)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), devices=["cpu"] * 8)
    assert mesh.shape == {"pod": 2, "data": 2, "model": 2} and mesh.size == 8
    assert [mesh.position(mesh.coords(p)) for p in range(8)] == list(range(8))
    host = make_host_mesh("cpu")
    assert host.shape == {"data": 1, "model": 1}
    assert host.devices == [torch.device("cpu")]


def test_valid_spec_drops_nondividing_axes():
    """Twin of tests/test_distributed.py's: 'pod' is dropped (absent),
    the tuple structure kept."""
    mesh = make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    assert valid_spec(mesh, (10, 7), (("pod", "data"), "model")) == (
        ("data",), "model")
    mesh = make_mesh((4, 2), ("data", "model"), devices=["cpu"] * 8)
    assert valid_spec(mesh, (10, 7), (("data", "model"), "model")) == (
        None, None)


@pytest.fixture(scope="module")
def small_state():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(128, 2)).astype(np.float32))
    cfg = OuterConfig(num_probes=4, num_rff_pairs=64,
                      solver=SolverConfig(name="cg", max_epochs=50,
                                          precond_rank=0),
                      num_steps=4, bm=64, bn=64)
    return init_outer_state(cfg, x, generator=torch.Generator().manual_seed(1))


def _leaves_equal(a, b) -> None:
    la, lb = _tensor_leaves(a), _tensor_leaves(b)
    assert la and len(la) == len(lb)
    for ta, tb in zip(la, lb):
        assert torch.equal(ta, tb)


def _tensor_leaves(tree) -> list:
    out = []

    def visit(t):
        if isinstance(t, torch.Tensor):
            out.append(t)
        elif isinstance(t, (tuple, list)):
            for v in t:
                visit(v)

    visit(tree)
    return out


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_elastic_reshard_roundtrip(small_state, shape):
    """Twin of tests/test_checkpoint.py's: reshard onto a mesh with rows
    over "data" (replicated over "model" on the 2 x 2 mesh), then gather:
    every leaf bitwise unchanged; vector leaves are RowSharded."""
    mesh = make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * int(np.prod(shape)))
    st2 = reshard(small_state, mesh, row_sharded_builder(axes=("data",)))
    assert isinstance(st2.carry_v, RowSharded)
    assert st2.carry_v.num_shards == shape[0]
    assert st2.step == small_state.step and st2.params.kernel == "matern32"
    _leaves_equal(small_state, unshard(st2, "cpu"))


def test_restore_reshard_gather_equals_saved(small_state, tmp_path):
    """save_checkpoint -> restore_checkpoint -> reshard onto 8 virtual
    shards -> gather: every leaf bitwise equal to the saved state."""
    save_checkpoint(str(tmp_path), 3, small_state)
    restored, step = restore_checkpoint(str(tmp_path), small_state)
    assert step == 3
    mesh = _cpu_mesh("m3")
    placed = reshard(restored, mesh, row_sharded_builder())
    assert placed.carry_v.num_shards == 8
    _leaves_equal(small_state, unshard(placed, "cpu"))


def test_compress_matches_reference_bitwise(ref):
    inp, out = ref
    grads = {"w": torch.tensor(inp["ef/g_w"]), "b": torch.tensor(inp["ef/g_b"])}
    state = EFState(residual={"w": torch.tensor(inp["ef/r_w"]),
                              "b": torch.tensor(inp["ef/r_b"])})
    q, st = compress(grads, state)
    for k in ("w", "b"):
        assert q[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(decompress(q)[k].numpy(), out[f"ef/q_{k}"])
        np.testing.assert_array_equal(st.residual[k].numpy(), out[f"ef/r_{k}"])


def test_compression_error_feedback_unbiased_over_time():
    """Twin of tests/test_steps.py:62: sum of compressed grads + final
    residual == sum of true grads."""
    rng = np.random.default_rng(0)
    state = ef_init({"w": torch.zeros((64, 64))})
    total_true = torch.zeros((64, 64))
    total_sent = torch.zeros((64, 64))
    for _ in range(20):
        g = {"w": torch.tensor(rng.normal(size=(64, 64)).astype(np.float32))
             * 1e-3}
        gq, state = compress(g, state)
        total_true += g["w"]
        total_sent += decompress(gq)["w"]
    drift = total_true - (total_sent + state.residual["w"])
    assert float(torch.max(torch.abs(drift))) < 1e-5


def test_compression_residual_bounded():
    """Twin of tests/test_steps.py:78."""
    rng = np.random.default_rng(1)
    state = ef_init({"w": torch.zeros((128,))})
    for _ in range(50):
        g = {"w": torch.tensor(rng.normal(size=(128,)).astype(np.float32))}
        _, state = compress(g, state)
    assert float(torch.max(torch.abs(state.residual["w"]))) < 0.1


# -- the streamed H-MVMs and available_kernels --------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_streamed_mvms_match_reference(kind):
    """kernel_mvm_streamed (ragged last block), h_mvm_streamed and
    h_mvm_dense against the reference's at 1e-5 relative (both fp32,
    expanded r2); Matérn-1/2's coincident points leave both at the
    expanded form's sqrt of fp32 cancellation, so it is held at 2e-3."""
    rng = np.random.default_rng(7)
    x1 = rng.normal(size=(150, 4)).astype(np.float32)
    x2 = rng.normal(size=(60, 4)).astype(np.float32)
    v = rng.normal(size=(60, 3)).astype(np.float32)
    vx = rng.normal(size=(150,)).astype(np.float32)
    raw = _raw_params(rng, 4)
    jp = JHyperParams(jnp.asarray(raw["raw_ls"]), jnp.asarray(raw["raw_signal"]),
                      jnp.asarray(raw["raw_noise"]), kernel=kind)
    tp = HyperParams(torch.tensor(raw["raw_ls"]), torch.tensor(raw["raw_signal"]),
                     torch.tensor(raw["raw_noise"]), kernel=kind)
    tol = 2e-3 if kind == "matern12" else 1e-5
    got = kernel_mvm_streamed(torch.tensor(x1), torch.tensor(x2),
                              torch.tensor(v), tp, block_rows=64)
    want = j_kernel_mvm_streamed(jnp.asarray(x1), jnp.asarray(x2),
                                 jnp.asarray(v), jp, block_rows=64)
    assert got.shape == (150, 3) and _max_rel(got, want) < 1e-5
    got = h_mvm_streamed(torch.tensor(x1), torch.tensor(vx), tp, block_rows=64)
    want = j_h_mvm_streamed(jnp.asarray(x1), jnp.asarray(vx), jp,
                            block_rows=64)
    assert got.shape == (150,) and _max_rel(got, want) < tol
    got = h_mvm_dense(torch.tensor(x1), torch.tensor(vx), tp)
    want = j_h_mvm_dense(jnp.asarray(x1), jnp.asarray(vx), jp)
    assert _max_rel(got, want) < tol


def test_available_kernels_matches_reference():
    assert available_kernels() == j_available() == tuple(sorted(KINDS))
