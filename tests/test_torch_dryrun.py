"""The port's dry-run accounting (``repro_torch.launch.{dryrun,analysis,
hlo_analysis,sweep}``, the LM sharding policy, ``abstract_params``,
``input_specs``, ``lower_gp_outer_step``) against the reference.

(a) In process, exact: every parameter's spec and placement for the ten
    architectures on both production meshes, serving or not; the
    abstract params' shapes and dtypes; for every runnable LM cell the
    abstract inputs (cache trees included) and their placements, the
    microbatch count, the model-flop token count and ``apply_opts``; the
    layout of ``concrete_batch`` (its values are torch's draws, not the
    reference's); ``RooflineReport.finalise`` on equal inputs with both
    modules' peaks set equal; the GP cell's multipliers, rotation bytes,
    collective bytes and counts. The reference's ``valid_spec`` reads only
    ``mesh.shape``, so its placements are taken on a JAX ``AbstractMesh``;
    ``PartitionSpec`` stores a one-axis tuple as the axis name, so both
    sides' specs are compared in that form.

(b) One subprocess against XLA: the reference's ``make_production_mesh``
    fails under the installed JAX (``jax.make_mesh`` makes Explicit axes,
    which ``constrain`` rejects), so the subprocess builds Auto-axes meshes
    over 512 forced host devices and calls the reference's
    ``lower_lm_cell`` / ``lower_gp_cell``, ``analysis_*_cell`` and
    ``lower_gp_outer_step`` directly. Argument (and output) bytes per chip
    must equal ``memory_analysis``'s to the byte. Flops are held like for
    like: FlopCounterMode counts products only, so the port's composition
    without the remat recompute (the reference's period piece has none)
    is held within ``FLOPS_RTOL`` of XLA's ``dot`` flops, parsed from the
    same pieces' compiled HLO and composed with the same multipliers; the
    ratio to XLA's whole count (which adds elementwise ops, converts and
    selects) is printed. Collective bytes per chip within
    ``COLL_FACTOR`` on llama3-8b's two cells.

(c) The composition equals a direct count: at SMOKE configs with 2
    periods (2 microbatches for train) on a one-position mesh, the composed
    flops equal ``FlopCounterMode`` over the whole step under fake tensors
    to ``COMPOSE_RTOL``.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import LM_SHAPES as J_LM_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import runnable_cells as j_runnable_cells
from repro.launch import hlo_analysis as j_hlo
from repro.models import abstract_params as j_abstract_params
from repro.models import batch_pspec as j_batch_pspec
from repro.models import cache_shardings as j_cache_shardings
from repro.models import concrete_batch as j_concrete_batch
from repro.models import input_specs as j_input_specs
from repro.models import param_pspec_tree as j_param_pspec_tree
from repro.models import param_shardings as j_param_shardings
from repro.models.steps import opt_shardings as j_opt_shardings
from repro_torch.configs import GP_SHAPES, LM_SHAPES, get_config, runnable_cells
from repro_torch.distributed import sharding
from repro_torch.launch import analysis, dryrun, hlo_analysis, sweep
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import (abstract_params, batch_pspec, cache_shardings,
                                concrete_batch, input_specs, make_prefill_step,
                                make_serve_step, make_train_step,
                                param_pspec_tree, param_shardings)
from repro_torch.models.steps import opt_shardings
from repro_torch.models.transformer import fake_mode
from repro_torch.train.adam import adam_init

def _reference_dryrun():
    """The reference's ``repro.launch.dryrun``. Its first lines set
    ``XLA_FLAGS`` to 512 forced host devices; the flag is put back at once,
    so no JAX backend of this process (other tests share the worker)
    starts with it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as module
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return module


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = (False, True)  # multi_pod
LM_CELLS = [(a, s) for a, s, st in runnable_cells() if a != "gp-iterative"]
FLOPS_RTOL = 0.15  # port products vs XLA dots, per chip
COLL_FACTOR = 2.0  # collective bytes per chip, either way
COMPOSE_RTOL = 1e-9


def _canon(entry):
    """A spec entry as ``PartitionSpec`` stores it."""
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _spec(spec) -> tuple:
    return tuple(_canon(e) for e in spec)


def _flat(tree, pre="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = v
    return out


def _j_flat(tree) -> dict:
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _meshes(multi: bool):
    return (AbstractMesh((2, 16, 16) if multi else (16, 16),
                         ("pod", "data", "model") if multi
                         else ("data", "model")),
            make_production_mesh(multi_pod=multi))


@functools.lru_cache(maxsize=None)
def _j_params(arch):
    return j_abstract_params(j_get_config(arch))


@functools.lru_cache(maxsize=None)
def _params(arch):
    return abstract_params(get_config(arch))


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _same_leaves(port: dict, ref: dict) -> None:
    p, r = _flat(port), _j_flat(ref)
    assert set(p) == set(r)
    for k in r:
        assert tuple(p[k].shape) == tuple(r[k].shape), k
        assert _dtype(p[k]) == _dtype(r[k]), k


def _same_placements(port: dict, ref: dict) -> None:
    p, r = _flat(port), _j_flat(ref)
    assert set(p) == set(r)
    for k in r:
        assert _spec(p[k].spec) == tuple(r[k].spec), k


# --------------------------------------------------------------------------
# (a) exact, in process
# --------------------------------------------------------------------------
def test_production_mesh_shapes():
    for multi, shape in ((False, {"data": 16, "model": 16}),
                         (True, {"pod": 2, "data": 16, "model": 16})):
        mesh = make_production_mesh(multi_pod=multi)
        assert mesh.shape == shape
        assert mesh.size == 256 * (1 + multi)
        assert all(d.type == "meta" for d in mesh.devices)


@pytest.mark.parametrize("arch", sorted({a for a, _ in LM_CELLS}))
def test_param_specs_and_placements_match_reference(arch):
    cfg, j_cfg = get_config(arch), j_get_config(arch)
    params, j_params = _params(arch), _j_params(arch)
    _same_leaves(params, j_params)
    for serving in (False, True):
        specs = _flat(param_pspec_tree(cfg, params, serving=serving))
        j_tree = j_param_pspec_tree(j_cfg, j_params, serving=serving)
        j_specs = dict(zip(_j_flat(j_params), jax.tree_util.tree_leaves(
            j_tree, is_leaf=lambda x: isinstance(x, tuple))))
        assert set(specs) == set(j_specs)
        for k in j_specs:
            assert specs[k] == tuple(j_specs[k]), k
        for multi in MESHES:
            j_mesh, mesh = _meshes(multi)
            _same_placements(
                param_shardings(cfg, mesh, params, serving=serving),
                j_param_shardings(j_cfg, j_mesh, j_params, serving=serving))


@pytest.mark.parametrize("cell", LM_CELLS, ids="{0[0]}-{0[1]}".format)
def test_cell_inputs_and_placements_match_reference(cell):
    j_dryrun = _reference_dryrun()
    arch, shape_name = cell
    cfg, j_cfg = get_config(arch), j_get_config(arch)
    shape, j_shape = LM_SHAPES[shape_name], J_LM_SHAPES[shape_name]
    specs, j_specs = input_specs(cfg, shape), j_input_specs(j_cfg, j_shape)
    _same_leaves(specs, j_specs)
    n_active = cfg.active_params_per_token_layers()
    assert n_active == j_cfg.active_params_per_token_layers()
    assert dryrun._model_flop_tokens(cfg, shape, n_active) == \
        j_dryrun._model_flop_tokens(j_cfg, j_shape, n_active)
    opts = {"param_dtype": "bfloat16", "remat": False,
            "moe_per_expert_scatter": True, "remat_policy": "dots",
            "microbatch_rows": 4}
    got = dryrun.apply_opts(cfg, shape, opts)
    want = j_dryrun.apply_opts(j_cfg, j_shape, opts)
    assert dataclasses.asdict(got[1]) == dataclasses.asdict(want[1])
    for f in ("param_dtype", "remat", "moe_single_scatter", "remat_policy"):
        assert getattr(got[0], f) == getattr(want[0], f)
    for multi in MESHES:
        j_mesh, mesh = _meshes(multi)
        assert dryrun._num_microbatches(shape, mesh) == \
            j_dryrun._num_microbatches(j_shape, j_mesh)
        if shape.step == "decode":
            _same_placements(cache_shardings(cfg, mesh, specs["cache"]),
                             j_cache_shardings(j_cfg, j_mesh,
                                               j_specs["cache"]))
        else:
            _same_placements(batch_pspec(specs["batch"], mesh),
                             j_batch_pspec(j_specs["batch"], j_mesh))
        if shape.step == "train":
            with fake_mode():
                opt = adam_init(_params(arch))
            p_sh = param_shardings(cfg, mesh, _params(arch))
            o_sh = opt_shardings(mesh, p_sh, opt)
            j_o_sh = j_opt_shardings(
                j_mesh, j_param_shardings(j_cfg, j_mesh, _j_params(arch)),
                None)
            assert _spec(o_sh.step.spec) == tuple(j_o_sh.step.spec)
            _same_placements(o_sh.mu, j_o_sh.mu)
            _same_placements(o_sh.nu, j_o_sh.nu)


def test_reference_dryrun_import_leaves_xla_flags():
    before = os.environ.get("XLA_FLAGS")
    sys.modules.pop("repro.launch.dryrun", None)
    _reference_dryrun()
    assert os.environ.get("XLA_FLAGS") == before


def test_runnable_cells_match_reference():
    assert runnable_cells(include_skips=True) == \
        j_runnable_cells(include_skips=True)
    assert len([c for c in runnable_cells() if c[2] == "run"]) == 38


@pytest.mark.parametrize("arch,shape_name", [
    ("llama3-8b", "train_4k"), ("internvl2-2b", "prefill_32k"),
    ("whisper-large-v3", "decode_32k"), ("mamba2-780m", "decode_32k")])
def test_concrete_batch_layout_matches_reference(arch, shape_name):
    """Shapes, dtypes, the mask and pos as the reference's; the values are
    torch's draws (ids in [0, vocab))."""
    cfg = get_config(arch, smoke=True)
    shape = dataclasses.replace(LM_SHAPES[shape_name], seq_len=64,
                                global_batch=2)
    j_cfg = j_get_config(arch, smoke=True)
    j_shape = dataclasses.replace(J_LM_SHAPES[shape_name], seq_len=64,
                                  global_batch=2)
    got = concrete_batch(cfg, shape, torch.Generator().manual_seed(0))
    want = jax.tree.map(np.asarray, j_concrete_batch(
        j_cfg, j_shape, jax.random.PRNGKey(0)))
    _same_leaves(got, want)
    flat, j_flat = _flat(got), _j_flat(want)
    for k, v in flat.items():
        if k.endswith("mask"):
            assert torch.equal(v, torch.ones_like(v))
        elif k == "pos":
            assert int(v) == int(j_flat[k]) == shape.seq_len // 2
        elif v.dtype == torch.int32:
            assert int(v.min()) >= 0 and int(v.max()) < cfg.vocab_size


def test_roofline_report_finalise_matches_reference(monkeypatch):
    for name, value in (("PEAK_BF16_FLOPS", 197e12), ("HBM_BW", 819e9),
                        ("ICI_BW", 50e9)):
        monkeypatch.setattr(hlo_analysis, name, value)
        monkeypatch.setattr(j_hlo, name, value)
    kw = dict(arch="a", shape="s", mesh="single", chips=256,
              flops_per_chip=2.1e14, bytes_per_chip=5.5e12,
              collective_bytes_per_chip=2.2e11,
              collective_counts={"all-gather": 3}, collective_by_op={},
              model_flops=5.05e16, argument_bytes=7, output_bytes=8,
              temp_bytes=9, peak_bytes=24)
    for over in ({}, {"bytes_per_chip": 1.0}, {"flops_per_chip": 0.0}):
        got = hlo_analysis.RooflineReport(**{**kw, **over}).finalise()
        want = j_hlo.RooflineReport(**{**kw, **over}).finalise()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_collective_byte_model_matches_reference_parse():
    """Each op's bytes as the reference's parser prices one HLO line."""
    for op in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute"):
        line = (f"  %x = f32[4,256]{{1,0}} {op}(%y), "
                f"replica_groups=[16,16]<=[256]")
        want = j_hlo.parse_collectives(line, 256).bytes_per_chip
        assert hlo_analysis.collective_bytes(op, 4 * 4 * 256, 16) == want


@pytest.mark.parametrize("shape_name", sorted(GP_SHAPES))
def test_gp_analysis_arithmetic_matches_reference(shape_name):
    from repro.launch.analysis import analysis_gp_cell as j_analysis_gp

    for multi in MESHES:
        mesh = make_production_mesh(multi_pod=multi)
        j_mesh = types.SimpleNamespace(devices=np.empty(mesh.size),
                                       shape=mesh.shape)
        total, pieces = analysis.analysis_gp_cell(shape_name, mesh)
        j_total, j_pieces = j_analysis_gp(shape_name, j_mesh)
        assert pieces["multipliers"] == j_pieces["multipliers"]
        assert total.coll_bytes == j_total.coll_bytes
        assert total.coll_counts == j_total.coll_counts
        # the tiles' flops are the CUDA kernels' own counts
        n = GP_SHAPES[shape_name].n // mesh.size
        fwd, _ = analysis.tile_costs(n, n, GP_SHAPES[shape_name].d,
                                     1 + GP_SHAPES[shape_name].num_probes)
        assert pieces["tile_fwd"]["flops"] == fwd.flops


def test_constrain_is_a_checked_no_op():
    x = torch.ones(4, 8)
    sharding.set_global_mesh(None)
    assert sharding.constrain(x, sharding.DP, None) is x
    sharding.set_global_mesh(make_production_mesh())
    try:
        assert sharding.constrain(x, sharding.DP, sharding.TP) is x
        ns = sharding.named_sharding(make_production_mesh(), (256, 8),
                                     sharding.batch_spec(2))
        assert ns.spec == (("data",), None) and ns.num_shards == 16
    finally:
        sharding.set_global_mesh(None)


def test_dryrun_cli_and_resumable_sweep(tmp_path, capsys):
    out = str(tmp_path)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "gp-iterative", "--shape", "gp_392k",
                     "--mesh", "single", "--out", out])
    assert e.value.code == 0
    assert "[dryrun] gp-iterative x gp_392k x single: OK" in \
        capsys.readouterr().out
    report = json.load(open(tmp_path / "gp-iterative__gp_392k__single.json"))
    assert report["argument_bytes"] == 1340960
    assert sweep.cell_done(out, "gp-iterative", "gp_392k", "single")
    for name in ("gp_525k", "gp_1m8"):  # stand-ins of finished cells
        (tmp_path / f"gp-iterative__{name}__single.json").write_text("{}")
    with pytest.raises(SystemExit) as e:  # every cell is done: skipped
        sweep.main(["--out", out, "--meshes", "single", "--only-arch",
                    "gp-iterative"])
    assert e.value.code == 0
    assert "skip (done)" in capsys.readouterr().out
    assert json.load(open(tmp_path / "_sweep_status.json")) == \
        {"failures": []}


def test_host_mesh_needs_a_card_unless_cpu():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            dryrun.run_cell("gp-iterative", "gp_392k", "host", "/nonexistent")
    assert make_host_mesh("cpu").size == 1


# --------------------------------------------------------------------------
# (c) the composition equals a direct count
# --------------------------------------------------------------------------
def _two_periods(arch):
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, num_layers=2 * len(cfg.pattern))
    if cfg.is_encdec:
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, num_layers=2))
    return cfg


def _direct_flops(cfg, shape, m) -> int:
    specs = input_specs(cfg, shape)
    params = abstract_params(cfg)
    with fake_mode(), FlopCounterMode(display=False) as counter:
        if shape.step == "train":
            make_train_step(cfg, num_microbatches=m)(
                params, adam_init(params), specs["batch"])
        elif shape.step == "prefill":
            make_prefill_step(cfg)(params, specs["batch"])
        else:
            make_serve_step(cfg)(params, specs["cache"], specs["tokens"],
                                 specs["pos"])
    return counter.get_total_flops()


# gemma3-4b's 17-layer period makes its train case the slowest; its SWA
# rings are in prefill and decode
@pytest.mark.parametrize("arch,step", [
    (a, s) for a in ("llama3-8b", "mixtral-8x22b", "mamba2-780m",
                     "whisper-large-v3", "internvl2-2b", "gemma3-4b")
    for s in ("train", "prefill", "decode")
    if (a, s) != ("gemma3-4b", "train")])
def test_composition_equals_direct_count(arch, step):
    cfg = _two_periods(arch)
    name = {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k"}[step]
    shape = dataclasses.replace(LM_SHAPES[name], seq_len=64,
                                global_batch=4, microbatch_rows=2)
    if cfg.frontend.kind == "vision":
        shape = dataclasses.replace(shape, seq_len=64 + cfg.frontend.num_prefix)
    mesh = make_host_mesh("cpu")
    total, pieces = analysis.analysis_lm_cell(arch, name, mesh, cfg=cfg,
                                              shape=shape)
    m = dryrun._num_microbatches(shape, mesh) if step == "train" else 1
    assert pieces["multipliers"]["periods"] == 2
    assert pieces["multipliers"].get("microbatches", 2) == 2
    direct = _direct_flops(cfg, shape, m)
    assert direct > 0
    assert abs(total.flops - direct) <= COMPOSE_RTOL * direct


# --------------------------------------------------------------------------
# (b) against XLA, in one subprocess
# --------------------------------------------------------------------------
_REFERENCE = textwrap.dedent(r'''
    import json, os, re, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    import repro.launch.analysis as A
    from repro.configs import GP_SHAPES
    from repro.distributed.gp_step import lower_gp_outer_step
    from repro.launch.dryrun import lower_gp_cell, lower_lm_cell
    from repro.launch.hlo_analysis import extract_memory

    def mesh(multi):
        shape = (2, 16, 16) if multi else (16, 16)
        axes = ("pod", "data", "model") if multi else ("data", "model")
        n = 512 if multi else 256
        return jax.make_mesh(shape, axes, devices=jax.devices()[:n],
                             axis_types=(AxisType.Auto,) * len(shape))

    def dot_flops(text):
        dims = {}
        for line in text.splitlines():
            m = re.match(r"\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*\(?[a-z0-9]+"
                         r"\[([0-9,]*)\]", line)
            if m:
                dims[m.group(1)] = [int(x) for x in m.group(2).split(",") if x]
        total = 0
        for line in text.splitlines():
            m = re.match(r"\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*[a-z0-9]+"
                         r"\[([0-9,]*)\][^ ]*\s+dot\(%?([\w.\-]+),", line)
            if not m:
                continue
            out = 1
            for x in m.group(1).split(","):
                out *= int(x) if x else 1
            k = 1
            c = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", line)
            for i in c.group(1).split(","):
                k *= dims[m.group(2)][int(i)] if i else 1
            total += 2 * out * k
        return total

    dots = []
    orig = A._cost_of
    def spy(lowered, chips):
        dots.append(dot_flops(lowered.compile().as_text()))
        return orig(lowered, chips)
    A._cost_of = spy

    out = {"cells": {}, "gp_lower": {}}
    single = mesh(False)
    for arch, shape in (("llama3-8b", "train_4k"), ("llama3-8b", "decode_32k"),
                        ("mixtral-8x22b", "decode_32k"),
                        ("gp-iterative", "gp_392k")):
        dots.clear()
        if arch == "gp-iterative":
            lowered, _, _ = lower_gp_cell(shape, single)
            total, pieces = A.analysis_gp_cell(shape, single)
        else:
            lowered, _, _ = lower_lm_cell(arch, shape, single)
            total, pieces = A.analysis_lm_cell(arch, shape, single)
        mult = pieces["multipliers"]
        if "microbatches" in mult:  # A, B, C
            a, b, c = dots
            dot_total = mult["microbatches"] * (a + (mult["periods"] - 1) * b) + c
        elif "periods" in mult:
            a, b = dots
            dot_total = a + (mult["periods"] - 1) * b
        else:
            dot_total = None
        out["cells"][f"{arch}/{shape}"] = {
            "memory": extract_memory(lowered.compile()), "flops": total.flops,
            "dot_flops": dot_total, "coll_bytes": total.coll_bytes}
    for multi in (False, True):
        for name, shape in GP_SHAPES.items():
            _, model_flops, notes = lower_gp_outer_step(shape, mesh(multi))
            out["gp_lower"][f"{name}/{multi}"] = [model_flops, notes]
    print("RESULT" + json.dumps(out))
''')


@pytest.fixture(scope="module")
def xla():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", _REFERENCE], capture_output=True,
                       text=True, env=env, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):])


def _port_cell(arch, shape_name):
    mesh = make_production_mesh()
    if arch == "gp-iterative":
        lowered, _, _ = dryrun.lower_gp_cell(shape_name, mesh)
        total, pieces = analysis.analysis_gp_cell(shape_name, mesh)
        temp = 0
    else:
        lowered, _, _ = dryrun.lower_lm_cell(arch, shape_name, mesh)
        total, pieces = analysis.analysis_lm_cell(arch, shape_name, mesh)
        temp = pieces["memory"]["temp_bytes"]
    memory = hlo_analysis.extract_memory(lowered.args, lowered.outputs,
                                         lowered.donated, temp)
    return memory, total, pieces


@pytest.mark.parametrize("cell", ["llama3-8b/train_4k", "llama3-8b/decode_32k",
                                  "mixtral-8x22b/decode_32k",
                                  "gp-iterative/gp_392k"])
def test_argument_and_output_bytes_equal_xla(xla, cell):
    memory, _, _ = _port_cell(*cell.split("/"))
    want = xla["cells"][cell]["memory"]
    assert memory["argument_bytes"] == want["argument_bytes"]
    assert memory["output_bytes"] == want["output_bytes"]


def _like_for_like_flops(total, pieces) -> float:
    """The port's composition without the remat recompute of the periods
    past the first (the reference's period piece has none)."""
    mult = pieces["multipliers"]
    if "microbatches" not in mult:
        return total.flops
    r = pieces["remat_body"]["flops"]
    return total.flops - mult["microbatches"] * (mult["periods"] - 1) * r


@pytest.mark.parametrize("cell", ["llama3-8b/train_4k", "llama3-8b/decode_32k",
                                  "mixtral-8x22b/decode_32k"])
def test_flops_and_collectives_against_xla(xla, cell):
    memory, total, pieces = _port_cell(*cell.split("/"))
    want = xla["cells"][cell]
    flops = _like_for_like_flops(total, pieces)
    ratios = {"flops_vs_dots": flops / want["dot_flops"],
              "flops_vs_xla_total": flops / want["flops"],
              "composed_with_remat_vs_xla_total": total.flops / want["flops"],
              "coll_bytes": total.coll_bytes / want["coll_bytes"],
              "temp_bytes_estimate": memory["temp_bytes"]
              / want["memory"]["temp_bytes"]}
    print(cell, json.dumps(ratios))
    if cell.startswith("llama3-8b"):
        assert abs(ratios["flops_vs_dots"] - 1) <= FLOPS_RTOL
        assert 1 / COLL_FACTOR <= ratios["coll_bytes"] <= COLL_FACTOR


@pytest.mark.parametrize("multi", MESHES)
def test_lower_gp_outer_step_matches_reference(xla, multi):
    from repro_torch.distributed.gp_step import lower_gp_outer_step

    mesh = make_production_mesh(multi_pod=multi)
    for name, shape in GP_SHAPES.items():
        low = lower_gp_outer_step(shape, mesh)
        assert [low.model_flops, low.notes] == xla["gp_lower"][f"{name}/{multi}"]
        assert low.state.carry_v.shape == (shape.n, 1 + shape.num_probes)
        assert low.state_shardings.carry_v.spec == (
            ("pod", "data", "model") if multi else ("data", "model"), None)
