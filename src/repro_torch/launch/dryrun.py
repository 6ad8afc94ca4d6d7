"""Multi-pod dry-run: account for every (arch x shape x mesh) cell; port of
``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k --mesh single

The reference lowers and compiles each cell for 256 or 512 placeholder
host devices. The port has no compiler; for every cell it shows, without
hardware:
  * the placement is coherent: every argument's per-dimension axis tuple
    on the production mesh (``valid_spec``), with argument and output
    bytes per chip exact;
  * what it needs (argument, output, temp and peak bytes per chip; temp
    is an estimate from the pieces' fake runs);
  * the roofline terms (:mod:`repro_torch.launch.analysis`: per-chip
    flops and bytes from fake runs of the pieces, collectives from the
    policy).
``--mesh host`` accounts on ``make_host_mesh()``: the visible cards
(raises without one unless ``--device cpu``).

Results are written to artifacts/dryrun/<arch>__<shape>__<mesh>.json with
the reference's fields.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import NamedTuple

import torch

from repro_torch.configs import GP_SHAPES, LM_SHAPES, get_config
from repro_torch.launch.hlo_analysis import RooflineReport, extract_memory
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh


def _model_flop_tokens(cfg, shape, n_active) -> float:
    """N_active-weighted token count. For enc-dec archs the encoder and
    decoder process DIFFERENT sequence lengths, so weight the two stacks'
    parameter counts by their own token counts (whisper: 4096 frames vs 448
    text tokens)."""
    b = shape.global_batch
    if not cfg.is_encdec:
        return n_active * b * shape.seq_len
    mults = 3 if cfg.mlp_activation == "swiglu" else 2
    enc_per_layer = (
        cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim)
        + cfg.q_dim * cfg.d_model
        + mults * cfg.d_model * cfg.d_ff
    )
    n_enc = enc_per_layer * cfg.encoder.num_layers
    n_dec = n_active - n_enc
    # cross-attention K/V projections run over the ENCODER length
    cross_kv = cfg.num_layers * 2 * cfg.d_model * cfg.kv_dim
    n_dec = n_dec - cross_kv
    return b * (
        n_enc * shape.seq_len
        + n_dec * cfg.decoder_len
        + cross_kv * shape.seq_len
    )


def _num_microbatches(shape, mesh) -> int:
    dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    per_dev = max(1, shape.global_batch // dp)
    m = max(1, per_dev // shape.microbatch_rows)
    while shape.global_batch % m != 0:  # equal row slices
        m -= 1
    return m


def apply_opts(cfg, shape, opts):
    """Apply hillclimb variant options to (cfg, shape)."""
    opts = opts or {}
    if opts.get("param_dtype"):
        cfg = dataclasses.replace(cfg, param_dtype=opts["param_dtype"])
    if opts.get("remat") is not None:
        cfg = dataclasses.replace(cfg, remat=opts["remat"])
    if opts.get("moe_per_expert_scatter"):
        cfg = dataclasses.replace(cfg, moe_single_scatter=False)
    if opts.get("remat_policy"):
        cfg = dataclasses.replace(cfg, remat_policy=opts["remat_policy"])
    if shape is not None and opts.get("microbatch_rows"):
        shape = dataclasses.replace(shape,
                                    microbatch_rows=opts["microbatch_rows"])
    return cfg, shape


class LoweredCell(NamedTuple):
    """A cell's step and its placement: ``args`` (what the step reads),
    ``outputs`` and ``donated`` (the arguments whose buffers the outputs
    reuse) as lists of (fake tensor, placement)."""

    step: object
    args: list
    outputs: list
    donated: list


def _pairs(tree, shardings) -> list:
    """(leaf, placement) pairs of a tree of tensors and its placements."""
    from repro_torch.train.adam import AdamState, tree_leaves

    if isinstance(tree, AdamState):
        return ([(tree.step, shardings.step)] + _pairs(tree.mu, shardings.mu)
                + _pairs(tree.nu, shardings.nu))
    if isinstance(tree, dict):
        return list(zip(tree_leaves(tree), tree_leaves(shardings)))
    if hasattr(tree, "leaves"):  # HyperParams
        return list(zip(tree.leaves, shardings.leaves))
    return [(tree, shardings)]


def lower_lm_cell(arch: str, shape_name: str, mesh, opts=None, *, cfg=None,
                  shape=None) -> tuple:
    """Returns (lowered, model_flops, notes). ``cfg`` / ``shape`` replace
    the arch's config and the named shape (a cut cell)."""
    from repro_torch.distributed.sharding import (DP, TP, NamedSharding,
                                                  set_global_mesh, valid_spec)
    from repro_torch.models import (abstract_params, batch_pspec,
                                    cache_shardings, input_specs,
                                    make_prefill_step, make_serve_step,
                                    make_train_step, param_shardings)
    from repro_torch.models.steps import opt_shardings
    from repro_torch.models.transformer import fake_mode
    from repro_torch.train.adam import adam_init

    opts = opts or {}
    cfg = cfg or get_config(arch)
    shape = shape or LM_SHAPES[shape_name]
    cfg, shape = apply_opts(cfg, shape, opts)
    serving = bool(opts.get("serving_resident")) and shape.step != "train"
    set_global_mesh(mesh)
    params_abs = abstract_params(cfg)
    p_sh = param_shardings(cfg, mesh, params_abs, serving=serving)
    specs = input_specs(cfg, shape)
    repl = NamedSharding(mesh, ())
    params = _pairs(params_abs, p_sh)

    n_active = cfg.active_params_per_token_layers()
    notes = ""

    if shape.step == "train":
        m = _num_microbatches(shape, mesh)
        notes = f"microbatches={m}"
        step = make_train_step(cfg, num_microbatches=m)
        with fake_mode():
            # the reference's step counter is a device int32
            opt_abs = adam_init(params_abs)._replace(
                step=torch.zeros((), dtype=torch.int32))
            loss = torch.empty((), dtype=torch.float32)
        o_sh = opt_shardings(mesh, p_sh, opt_abs)
        b_sh = batch_pspec(specs["batch"], mesh)
        state = params + _pairs(opt_abs, o_sh)
        lowered = LoweredCell(step, state + _pairs(specs["batch"], b_sh),
                              state + [(loss, repl)], state)
        model_flops = 6.0 * _model_flop_tokens(cfg, shape, n_active)
    elif shape.step == "prefill":
        from repro_torch.launch.analysis import _one_period

        step = make_prefill_step(cfg)
        b_sh = batch_pspec(specs["batch"], mesh)
        cfg1 = _one_period(cfg)  # the logits' shape does not depend on depth
        with fake_mode():
            logits = make_prefill_step(cfg1)(abstract_params(cfg1),
                                             specs["batch"])
        out_sh = NamedSharding(mesh, valid_spec(mesh, logits.shape,
                                                (DP, None, TP)))
        lowered = LoweredCell(step, params + _pairs(specs["batch"], b_sh),
                              [(logits, out_sh)], [])
        model_flops = 2.0 * _model_flop_tokens(cfg, shape, n_active)
    else:  # decode
        step = make_serve_step(cfg)
        c_sh = cache_shardings(cfg, mesh, specs["cache"])
        tok_sh = NamedSharding(mesh, valid_spec(
            mesh, (shape.global_batch,), (DP,)))
        with fake_mode():
            logits = torch.empty((shape.global_batch, cfg.padded_vocab),
                                 dtype=torch.float32)
        log_sh = NamedSharding(mesh, valid_spec(mesh, logits.shape, (DP, TP)))
        cache = _pairs(specs["cache"], c_sh)
        lowered = LoweredCell(
            step,
            params + cache + [(specs["tokens"], tok_sh), (specs["pos"], repl)],
            [(logits, log_sh)] + cache, cache)
        tokens = shape.global_batch  # one token per sequence
        model_flops = 2.0 * n_active * tokens
    return lowered, model_flops, notes


def lower_gp_cell(shape_name: str, mesh, opts=None) -> tuple:
    from repro_torch.distributed.gp_step import lower_gp_outer_step

    opts = opts or {}
    tile_dtype = (torch.bfloat16 if opts.get("gp_tile_dtype") == "bfloat16"
                  else torch.float32)
    shape = GP_SHAPES[shape_name]
    low = lower_gp_outer_step(shape, mesh, tile_dtype=tile_dtype)
    st, sh = low.state, low.state_shardings
    # the step never reads the previous residuals; jit drops unread
    # arguments, so they are not argument bytes
    read = (_pairs(st.params, sh.params) + _pairs(st.adam, sh.adam)
            + [(st.carry_v, sh.carry_v)])
    state = read + [(st.res_y, sh.res_y), (st.res_z, sh.res_z)]
    x, y, rff, w_eps = low.inputs
    x_sh, y_sh, rff_sh, w_sh = low.input_shardings
    inputs = [(x, x_sh), (y, y_sh), (rff.z, rff_sh.z), (rff.u, rff_sh.u),
              (rff.w, rff_sh.w), (w_eps, w_sh)]
    lowered = LoweredCell(low.step, read + inputs, state, read)
    return lowered, low.model_flops, low.notes


def _gp_temp(shape_name: str, mesh) -> int:
    """Temp estimate of a GP step per position: the ring's two rotating
    buffers (x and v) and CG's five (n_loc, 1 + s) fp32 vectors (v, r, d,
    H d and the targets)."""
    shape = GP_SHAPES[shape_name]
    n_loc = shape.n // mesh.size
    cols = 1 + shape.num_probes
    return 4 * n_loc * (2 * (shape.d + cols) + 5 * cols)


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             analyze: bool = True, opts=None, variant: str = "", *,
             cfg=None, shape=None, device: str = "cuda") -> dict:
    """Account for one cell and write its report. ``mesh_kind`` is single,
    multi or host (``make_host_mesh(device)``); ``cfg`` / ``shape`` cut
    an LM cell."""
    if mesh_kind == "host":
        mesh = make_host_mesh(device)
    else:
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    chips = mesh.size
    t0 = time.time()
    if arch == "gp-iterative":
        lowered, model_flops, notes = lower_gp_cell(shape_name, mesh, opts)
    else:
        lowered, model_flops, notes = lower_lm_cell(
            arch, shape_name, mesh, opts, cfg=cfg, shape=shape)
    t_lower = time.time() - t0

    from repro_torch.launch.analysis import analysis_gp_cell, analysis_lm_cell

    t0 = time.time()
    if arch == "gp-iterative":
        total, pieces = analysis_gp_cell(shape_name, mesh, opts)
        temp = _gp_temp(shape_name, mesh)
    else:
        total, pieces = analysis_lm_cell(arch, shape_name, mesh, opts,
                                         cfg=cfg, shape=shape)
        temp = pieces["memory"]["temp_bytes"]
    t_analysis = time.time() - t0
    memory = extract_memory(lowered.args, lowered.outputs, lowered.donated,
                            temp)
    raw = pieces["raw_production"]
    if analyze:  # trip-count-corrected composition
        flops, byts = total.flops, total.bytes
        coll_bytes, coll_counts = total.coll_bytes, total.coll_counts
    else:  # the one-period program, as the reference's scanned one
        flops, byts = raw["flops"], raw["bytes"]
        coll_bytes, coll_counts = raw["coll_bytes"], raw["coll_counts"]
    notes += f"; analysis={t_analysis:.1f}s"

    report = RooflineReport(
        arch=arch,
        shape=shape_name,
        mesh=mesh_kind,
        chips=chips,
        flops_per_chip=flops,
        bytes_per_chip=byts,
        collective_bytes_per_chip=coll_bytes,
        collective_counts=coll_counts,
        collective_by_op=raw["by_op"],
        model_flops=model_flops,
        notes=f"{notes}; lower={t_lower:.1f}s",
        **memory,
    ).finalise()
    report_dict = dataclasses.asdict(report)
    report_dict["pieces"] = pieces
    report_dict["variant"] = variant
    report_dict["opts"] = opts or {}

    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{variant}" if variant else ""
    path = os.path.join(
        out_dir, f"{arch}__{shape_name}__{mesh_kind}{suffix}.json"
    )
    with open(path, "w") as f:
        json.dump(report_dict, f, indent=2)
    print(
        f"[dryrun] {arch} x {shape_name} x {mesh_kind}: OK "
        f"(chips={chips} peak={report.peak_bytes/2**30:.2f}GiB/chip "
        f"t_comp={report.t_compute*1e3:.2f}ms t_mem={report.t_memory*1e3:.2f}ms "
        f"t_coll={report.t_collective*1e3:.2f}ms bottleneck={report.bottleneck} "
        f"useful={report.useful_fraction:.2f} roofline={report.roofline_fraction:.2f})"
    )
    print("memory_analysis:", json.dumps(memory))
    print("cost_analysis: flops/chip=%.3e bytes/chip=%.3e" % (flops, byts))
    print("collectives:", json.dumps(coll_counts))
    return dataclasses.asdict(report)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both", "host"])
    ap.add_argument("--device", default="cuda",
                    help="--mesh host: the cards (cuda) or the CPU")
    ap.add_argument("--out", default="artifacts/dryrun")
    # Hillclimb variant knobs:
    ap.add_argument("--variant", default="", help="suffix for the report file")
    ap.add_argument("--param-dtype", default=None, choices=[None, "bfloat16"])
    ap.add_argument("--serving-resident", action="store_true",
                    help="decode/prefill: TP-resident weights (no FSDP)")
    ap.add_argument("--microbatch-rows", type=int, default=None)
    ap.add_argument("--gp-tile-dtype", default=None, choices=[None, "bfloat16"])
    ap.add_argument("--moe-per-expert-scatter", action="store_true",
                    help="naive per-expert MoE combine (A/B baseline)")
    ap.add_argument("--remat-policy", default=None, choices=[None, "full", "dots"])
    args = ap.parse_args(argv)
    opts = {
        "param_dtype": args.param_dtype,
        "serving_resident": args.serving_resident,
        "microbatch_rows": args.microbatch_rows,
        "gp_tile_dtype": args.gp_tile_dtype,
        "moe_per_expert_scatter": args.moe_per_expert_scatter,
        "remat_policy": args.remat_policy,
    }
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    ok = True
    for mk in meshes:
        try:
            # The composed analysis is the single-pod (and host) roofline;
            # multi-pod shows the "pod" axis places.
            run_cell(args.arch, args.shape, mk, args.out,
                     analyze=(mk != "multi"), opts=opts,
                     variant=args.variant, device=args.device)
        except Exception:
            ok = False
            print(f"[dryrun] {args.arch} x {args.shape} x {mk}: FAILED",
                  file=sys.stderr)
            traceback.print_exc()
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
