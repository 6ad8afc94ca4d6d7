"""Where the CUDA kernels' time goes: variants with one part cut.

    python3 tools/torch_kernel_ablation.py        # on a machine with a card

Builds ``src/repro_torch/csrc/kernel_mvm.cu`` and
``src/repro_torch/csrc/kernel_mvm_bwd.cu`` several times (Matérn-3/2 only,
the forward's s-chunks of s = 33 and s = 65, the backward's d <= 32
registers, so each build takes seconds), each variant with one part of the
kernel's work cut, and times them on the card in turns, two rounds. The
forward runs at the benchmark cells' shapes: the 3droad full product
(391 387 x 391 387, d = 3, s = 33), AP's column slab there (392 000 x 1000),
the protein full product (41 157 x 41 157, d = 9, s = 65) and the same at
B = 4 lanes in one launch; the backward at the CG shape (12150 x 12150,
d = 26) as the fused call (u = w, s' = 130 padded to 136) and in the
standard roles (s = 65); each with the split count the port plans. Only
``full`` computes the right answer (its error against the plain version,
over the first 2048 rows, is printed); the others exist to be timed.
Forward variants of the first loop (``kernel_mvm_fwd``):

* ``no_copy``: both tile buffers are filled once and never copied again;
* ``one_buffer``: the path for large d: one tile buffer, each tile copied
  after the previous one's compute;
* ``r2_one_chunk``: r2 over the first 4 coordinates only;
* ``one_product``: big*big alone, without the two 3xTF32 correction
  products.

Variants of the warp-specialised loop (``kernel_mvm_fwd_ws``, where the
source has it; each includes the pre-split pass, which ``ws_full`` also
times alone, with two launches compared bit for bit):

* ``ws_full``: the loop as it runs;
* ``ws_no_products``: the product warpgroups issue no wgmma;
* ``ws_no_kappa``: the kappa warps compute and store nothing;
* ``ws_no_copy``: the rings are filled once, for the first tiles, and
  never copied again.

Backward variants (``bwd_`` in the output):

* ``no_copy``: both tile buffers are filled once and never copied again;
* ``one_product``: big*big alone;
* ``r2_one_chunk``: r2 over the first 4 coordinates only;
* ``no_contraction``: D is summed into one register instead of contracted
  with the differences;
* ``no_split``: the operands go to the tensor cores unsplit (big = x,
  small = x), so the three products remain but the split instructions go.

``--source PATH`` times another copy of ``kernel_mvm.cu`` (an older
commit's, say) in place of the tree's. Prints one JSON line per variant
and round, and the card's name and power limit; the lines also go to
``build/torch_kernel_ablation.jsonl``.

``--crossover`` times instead the tree's two forward loops, as the port
builds them (all kinds), against each other on column slabs of 64 T rows
at the cells' (n, d, s), 3droad's and protein's, for T = 2 .. 24 (the
column tiles each block of the warp-specialised loop walks under its own
split plan, the rule of ``kernels/tiled.py::fwd_plan``), and at short
shapes where few row tiles leave the grid to the column splits:
predictions at protein and 3droad, AP's slabs at elevators. Each line
holds both loops' times (the warp-specialised one with its pre-split
pass), three rounds in turn; the lines go to
``build/torch_fwd_crossover.jsonl``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (label, lanes, n, m, d, s) of the forward's cases.
SHAPES = (("3droad", 1, 391387, 391387, 3, 33),
          ("ap_slab", 1, 392000, 1000, 3, 33),
          ("protein", 1, 41157, 41157, 9, 65),
          ("protein_b4", 4, 41157, 41157, 9, 65))
# --crossover's (label, n, m, d, s): slabs of 64 T columns at the cells'
# (n, d, s), then short shapes.
CROSSOVER_SHAPES = tuple(
    (label, n, 64 * tiles, d, s)
    for label, n, d, s in (("3droad", 392000, 3, 33), ("protein", 41157, 9, 65))
    for tiles in (2, 4, 6, 8, 10, 12, 16, 24)) + (
    ("protein_predict64", 64, 41157, 9, 65),
    ("protein_predict16", 16, 41157, 9, 65),
    ("3droad_predict64", 64, 391387, 3, 33),
    *(("protein_rows", n, 41157, 9, 65) for n in (256, 512, 1024)),
    ("3droad_rows", 512, 391387, 3, 33),
    *(("elevators_slab", 13500, m, 18, 33) for m in (100, 256, 384, 512)))
# Rows of the output checked against the plain version.
CHECK_ROWS = 2048
BWD_SHAPE = (12150, 26, 65)  # n = m, d, s
MATERN32 = 2


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise ValueError(f"variant anchor not found: {old[:60]!r}")
    return text.replace(old, new)


def variants(src: str) -> dict:
    """The kernel's source restricted to Matérn-3/2 and NT = 5 or 9 (the
    cells' s = 33 and 65), and the variants made from it."""
    base = re.sub(r"  switch \(num_nt\(s\)\) \{.*?#undef REPRO_NT_CASE",
                  "  if (num_nt(s) == 5)\n"
                  "    return launch<KIND, 5>(u, w, v, out, workspace, n, m, "
                  "d, s, splits, lanes, stream);\n"
                  "  return launch<KIND, MAX_NT>(u, w, v, out, workspace, n, m, "
                  "d, s, splits, lanes, stream);\n", src, flags=re.S)
    base = re.sub(r"  switch \(kind\) \{.*?default:\n      return -1;\n  \}",
                  "  return launch_kind<kMatern32>(u, w, v, out, workspace, n, "
                  "m, d, s, splits, lanes, st);", base, count=1, flags=re.S)
    base = re.sub(r"(repro_kernel_mvm_fwd_ws\(.*?)  switch \(kind\) \{.*?"
                  r"default:\n      return -1;\n  \}",
                  r"\1  return launch_ws_kind<kMatern32>(u, w, v, out, "
                  r"workspace, packed, n, m, d, s, splits, lanes, st);",
                  base, flags=re.S)
    no_copy = _sub(base, "    if (stages == 2 && jt + 1 < t_hi) {",
                   "    if (false) {")
    no_copy = _sub(no_copy, "  if (t_lo < t_hi) load(buf0, t_lo);",
                   "  if (t_lo < t_hi) {\n    load(buf0, t_lo);\n"
                   "    load(buf0 + geo.stage_len, t_lo);\n  }")
    one_product = base
    for operands in ("asmall[mt], bbig[nt]", "abig[mt], bsmall[nt]"):
        one_product = _sub(
            one_product,
            "#pragma unroll\n    for (int nt = 0; nt < NT; ++nt)\n#pragma unroll\n"
            f"      for (int mt = 0; mt < 2; ++mt) mma_tf32(part[mt][nt], "
            f"{operands});\n", "")
    return {
        "full": base,
        "no_copy": no_copy,
        "one_buffer": _sub(
            base, "const int stages = smem_bytes(d, NT, 2) <= kMaxSmem ? 2 : 1;",
            "const int stages = 1;"),
        "r2_one_chunk": _sub(base, "  for (int k = 0; k < dk; k += 4) {",
                             "  for (int k = 0; k < 4; k += 4) {"),
        "one_product": one_product,
    }


def ws_variants(src: str) -> dict:
    """The warp-specialised loop's variants (Matérn-3/2), from the same
    restricted source; none where the source has no such loop."""
    if "kernel_mvm_fwd_ws" not in src:
        return {}
    base = variants(src)["full"]
    no_products = _sub(
        base,
        "      wgmma_tf32<NT>(part, ksm + o, vb + o, kk % WS_SUMK > 0);\n"
        "      wgmma_tf32<NT>(part, kb + o, vsm + o, 1);\n"
        "      wgmma_tf32<NT>(part, kb + o, vb + o, 1);\n", "")
    no_kappa = _sub(base, "      for (int k = 0; k < d4; k += 4) ws_r2_chunk<4>(kt, "
                          "urow, wrow, dp, k);\n      switch (d - d4) {",
                    "      for (int k = 0; k < 0; k += 4) ws_r2_chunk<4>(kt, "
                    "urow, wrow, dp, k);\n      switch (0) {")
    no_kappa = _sub(no_kappa, "      for (int a = 0; a < WS_KROWS; ++a) {\n"
                              "        uint32_t big[4], small[4];",
                    "      for (int a = 0; a < 0; ++a) {\n"
                    "        uint32_t big[4], small[4];")
    no_copy = _sub(base, "        load_v(i + WS_STAGES);",
                   "        mbar_arrive(&full_v[st]);")
    no_copy = _sub(no_copy, "        load_w(i + WS_WSTAGES);",
                   "        mbar_arrive(&full_w[i % WS_WSTAGES]);")
    return {"ws_full": base, "ws_no_products": no_products,
            "ws_no_kappa": no_kappa, "ws_no_copy": no_copy}


def bwd_variants(src: str) -> dict:
    """The backward kernel's source restricted to Matérn-3/2 and KQ = 2
    (d <= 32), and the variants made from it."""
    base = re.sub(r"  switch \(\(d \+ 15\) / 16\) \{.*?\n  \}\n",
                  "  return launch<KIND, 2>(u, w, g, v, du, workspace, n, m, d, "
                  "s, splits, lanes, stream);\n", src, flags=re.S)
    base = re.sub(r"  switch \(kind\) \{.*?default:\n      return -1;\n  \}",
                  "  return launch_kind<kMatern32>(u, w, g, v, du, workspace, n, "
                  "m, d, s, splits, lanes, st);", base, flags=re.S)
    no_copy = _sub(base, "    if (stages == 2 && jt + 1 < t_hi) {",
                   "    if (false) {")
    no_copy = _sub(no_copy, "  if (t_lo < t_hi) load(buf0, t_lo);",
                   "  if (t_lo < t_hi) {\n    load(buf0, t_lo);\n"
                   "    load(buf0 + stage_len, t_lo);\n  }")
    one_product = base
    for operands in ("asmall[mt], bbig[nt]", "abig[mt], bsmall[nt]"):
        one_product = _sub(
            one_product,
            "#pragma unroll\n    for (int nt = 0; nt < 4; ++nt)\n#pragma unroll\n"
            f"      for (int mt = 0; mt < 2; ++mt) mma_tf32(c[mt][nt], "
            f"{operands});\n", "")
    sink = ("    for (int x = 0; x < 32; ++x) acc[0][x & 3] += "
            "c[x >> 4][(x >> 2) & 3][x & 3];\n")
    return {
        "full": base,
        "no_copy": no_copy,
        "one_product": one_product,
        "r2_one_chunk": _sub(base, "  for (int k = 0; k < dk; k += 4) {",
                             "  for (int k = 0; k < 4; k += 4) {"),
        "no_contraction": _sub(
            base, "    tile_contract<NC>(acc, c, urow, cur + wofs, dp, dk, t);\n",
            sink),
        "no_split": _sub(
            base, "  big = tf32_rna(x);\n  small = tf32_rna(x - __uint_as_float(big));",
            "  big = __float_as_uint(x);\n  small = big;"),
    }


def _build(tiled, tmp: str, prefix: str, sources: dict, symbol: str,
            nargs: tuple) -> dict:
    """Compile each variant into its own library, all at once; the entry
    point of each, with ``nargs`` = (pointers, ints) before the stream."""
    procs = {}
    for name, text in sources.items():
        cu, so = Path(tmp, f"{prefix}{name}.cu"), Path(tmp, f"{prefix}{name}.so")
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [tiled._nvcc(), *tiled.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{prefix}{name}: nvcc failed\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), symbol)
        fn.argtypes = [ctypes.c_void_p] * nargs[0] + [ctypes.c_int] * nargs[1] \
            + [ctypes.c_void_p]
        fns[name] = fn
    return fns


def _timed(torch, call, reps):
    call()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        call()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _fwd_cases(torch, tiled, gen, sms) -> list:
    """The forward's operands at SHAPES (u scaled to r2 ~ 6 on average, w
    is u for a full product and u's first rows for the slab), the planned
    split count, and the plain version of the first CHECK_ROWS rows in
    fp32 and in fp64."""
    cases = []
    for label, lanes, n, m, d, s in SHAPES:
        u = torch.randn((lanes, n, d), generator=gen, device="cuda")
        u *= (3.0 / d) ** 0.5
        w = u[:, :m].contiguous()
        v = torch.randn((lanes, m, s), generator=gen, device="cuda")
        splits = tiled.split_plan(n, m, s, sms, lanes)
        ws = (torch.empty((splits, lanes, n, s), device="cuda")
              if splits > 1 else None)
        ref = tuple(torch.stack([tiled.kernel_mvm_plain(
            u[i, :CHECK_ROWS].to(dtype), w[i].to(dtype), v[i].to(dtype),
            "matern32") for i in range(lanes)])
            for dtype in (torch.float32, torch.float64))
        cases.append((label, lanes, u, w, v,
                      torch.empty((lanes, n, s), device="cuda"), ws, splits,
                      ref))
    return cases


def _errors(label, out, ref) -> dict:
    """The first CHECK_ROWS rows' largest error over the largest output,
    against the fp32 plain version (``rel_err``) and the fp64 one."""
    got = out[:, :CHECK_ROWS]
    ref32, ref64 = ref
    return {f"{label}_rel_err": ((got - ref32).abs().max()
                                 / ref32.abs().max()).item(),
            f"{label}_rel_err_f64": ((got.double() - ref64).abs().max()
                                     / ref64.abs().max()).item()}


def _ws_case(torch, tiled, case, sms) -> tuple:
    """The warp-specialised loop's split count, split workspace and
    pre-split workspace for a case of :func:`_fwd_cases`."""
    _, lanes, u, w, v = case[:5]
    (n, d), (m, s) = u.shape[1:], v.shape[1:]
    splits = tiled.ws_split_plan(n, m, s, sms, lanes)
    ws = (torch.empty((splits, lanes, n, s), device="cuda")
          if splits > 1 else None)
    packed = torch.empty(lanes * -(-m // tiled.WS_BN)
                         * tiled.ws_tile_floats(d, s), device="cuda")
    return splits, ws, packed


def crossover(torch, tiled, smi) -> list:
    """The first and the warp-specialised loop of the tree's library timed
    in turn at :data:`CROSSOVER_SHAPES`, each under its own split plan,
    three rounds; one record per shape and round."""
    lib = tiled._library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    calls = []
    for label, n, m, d, s in CROSSOVER_SHAPES:
        u, w = (torch.randn((rows, d), generator=gen, device="cuda")
                * (3.0 / d) ** 0.5 for rows in (n, m))
        v = torch.randn((m, s), generator=gen, device="cuda")
        tiles = -(-m // tiled.WS_BN)
        out = torch.empty((n, s), device="cuda")
        first_splits = tiled.split_plan(n, m, s, sms)
        ws_splits = tiled.ws_split_plan(n, m, s, sms)
        first_ws, ws_ws = (torch.empty((k, 1, n, s), device="cuda")
                           if k > 1 else None
                           for k in (first_splits, ws_splits))
        packed = torch.empty(tiles * tiled.ws_tile_floats(d, s),
                             device="cuda")

        def first(u=u, w=w, v=v, out=out, ws=first_ws, k=first_splits,
                  n=n, m=m, d=d, s=s):
            rc = lib.repro_kernel_mvm_fwd(
                u.data_ptr(), w.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), n, m, d, s,
                MATERN32, k, 1, stream)
            if rc != 0:
                raise RuntimeError(f"first loop: launch failed ({rc})")

        def warp_spec(u=u, w=w, v=v, out=out, ws=ws_ws, k=ws_splits,
                      packed=packed, n=n, m=m, d=d, s=s):
            rc = lib.repro_kernel_mvm_fwd_ws(
                u.data_ptr(), w.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), packed.data_ptr(),
                n, m, d, s, MATERN32, k, 1, stream)
            if rc != 0:
                raise RuntimeError(f"ws loop: launch failed ({rc})")

        calls.append(({"case": label, "n": n, "m": m, "d": d, "s": s,
                       "first_splits": first_splits,
                       "ws_splits": ws_splits,
                       "ws_tiles_per_block": tiles // ws_splits,
                       "planned_ws": tiled.fwd_plan(n, m, d, s, sms)[0]},
                      first, warp_spec))
    lines = []
    for rnd in range(3):
        for rec, first, warp_spec in calls:
            first_ms = _timed(torch, first, 50)
            ws_ms = _timed(torch, warp_spec, 50)
            line = json.dumps({**rec, "round": rnd, "first_ms": first_ms,
                               "ws_ms": ws_ms, "ws_over_first": ws_ms / first_ms,
                               "nvidia_smi": smi})
            print(line, flush=True)
            lines.append(line)
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--source", type=Path,
                        default=ROOT / "src/repro_torch/csrc/kernel_mvm.cu",
                        help="the forward kernel's source to time")
    parser.add_argument("--crossover", action="store_true",
                        help="time the tree's two forward loops on slabs")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import tiled

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    csrc = ROOT / "src/repro_torch/csrc"
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    if args.crossover:
        lines = crossover(torch, tiled, smi)
        (out_dir / "torch_fwd_crossover.jsonl").write_text("\n".join(lines)
                                                           + "\n")
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        try:
            src = args.source.read_text()
            fns = _build(tiled, tmp, "", variants(src),
                         "repro_kernel_mvm_fwd", (5, 7))
            ws_fns = _build(tiled, tmp, "", ws_variants(src),
                            "repro_kernel_mvm_fwd_ws", (6, 7))
            presplit = None
            if ws_fns:  # the pre-split pass alone, from ws_full's library
                presplit = ctypes.CDLL(str(Path(tmp, "ws_full.so"))) \
                    .repro_kernel_mvm_fwd_presplit
                presplit.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
                    + [ctypes.c_void_p]
            bwd_fns = _build(tiled, tmp, "bwd_", bwd_variants(
                (csrc / "kernel_mvm_bwd.cu").read_text()),
                "repro_kernel_mvm_bwd", (6, 7))
        except RuntimeError as err:
            print(err, file=sys.stderr)
            return 1

    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = _fwd_cases(torch, tiled, gen, sms)
    ws_cases = [_ws_case(torch, tiled, case, sms) for case in cases] \
        if ws_fns else []

    n, d, s = BWD_SHAPE
    u, g, v = (torch.randn(shape, generator=gen, device="cuda")
               for shape in ((n, d), (n, s), (n, s)))
    gv, vg = tiled.fused_operands(g, v)
    splits = tiled.bwd_split_plan(n, n, sms)
    bwd_cases = {}
    for label, (a, b) in (("bwd_fused", (gv, vg)), ("bwd_standard", (g, v))):
        ws = torch.empty((splits, n, d), device="cuda") if splits > 1 else None
        bwd_cases[label] = (u, u, a, b, torch.empty((n, d), device="cuda"), ws,
                            splits, tiled.kernel_mvm_bwd_plain(u, u, a, b,
                                                               "matern32"))

    lines = []
    for rnd in range(2):
        for name, fn in fns.items():
            rec = {"variant": name, "round": rnd, "nvidia_smi": smi}
            for label, lanes, u, w, v, out, ws, splits, ref in cases:
                (n, d), (m, s) = u.shape[1:], v.shape[1:]
                stream = torch.cuda.current_stream().cuda_stream

                def call():
                    rc = fn(u.data_ptr(), w.data_ptr(), v.data_ptr(),
                            out.data_ptr(), None if ws is None else ws.data_ptr(),
                            n, m, d, s, MATERN32, splits, lanes, stream)
                    if rc != 0:
                        raise RuntimeError(f"{name}: launch failed ({rc})")

                big = n * m * lanes > 10 ** 10
                rec[f"{label}_ms"] = _timed(torch, call, 3 if big else 20)
                rec[f"{label}_splits"] = splits
                if name == "full":
                    call()
                    torch.cuda.synchronize()
                    rec.update(_errors(label, out, ref))
            print(json.dumps(rec), flush=True)
            lines.append(json.dumps(rec))
        for name, fn in ws_fns.items():
            rec = {"variant": name, "round": rnd, "nvidia_smi": smi}
            for case, (splits, ws, packed) in zip(cases, ws_cases):
                label, lanes, u, w, v, out, _, _, ref = case
                (n, d), (m, s) = u.shape[1:], v.shape[1:]
                stream = torch.cuda.current_stream().cuda_stream

                def call():
                    rc = fn(u.data_ptr(), w.data_ptr(), v.data_ptr(),
                            out.data_ptr(), None if ws is None else ws.data_ptr(),
                            packed.data_ptr(), n, m, d, s, MATERN32, splits,
                            lanes, stream)
                    if rc != 0:
                        raise RuntimeError(f"{name}: launch failed ({rc})")

                big = n * m * lanes > 10 ** 10
                rec[f"{label}_ms"] = _timed(torch, call, 3 if big else 20)
                rec[f"{label}_splits"] = splits
                if name == "ws_full":
                    out.fill_(float("nan"))
                    call()
                    again = out.clone()
                    call()
                    torch.cuda.synchronize()
                    rec.update(_errors(label, out, ref))
                    rec[f"{label}_bitwise"] = bool(torch.equal(out, again))

                    def pre():
                        rc = presplit(w.data_ptr(), v.data_ptr(),
                                      packed.data_ptr(), m, d, s, lanes,
                                      stream)
                        if rc != 0:
                            raise RuntimeError(f"presplit failed ({rc})")

                    rec[f"{label}_presplit_ms"] = _timed(torch, pre, 20)
            print(json.dumps(rec), flush=True)
            lines.append(json.dumps(rec))
        for name, fn in bwd_fns.items():
            rec = {"variant": f"bwd_{name}", "round": rnd, "nvidia_smi": smi}
            for label, (u, w, g, v, du, ws, splits, ref) in bwd_cases.items():
                (n, d), m, s = u.shape, w.shape[0], g.shape[1]
                stream = torch.cuda.current_stream().cuda_stream

                def call():
                    rc = fn(u.data_ptr(), w.data_ptr(), g.data_ptr(),
                            v.data_ptr(), du.data_ptr(),
                            None if ws is None else ws.data_ptr(),
                            n, m, d, s, MATERN32, splits, 1, stream)
                    if rc != 0:
                        raise RuntimeError(f"bwd_{name}: launch failed ({rc})")

                rec[f"{label}_ms"] = _timed(torch, call, 20)
                rec[f"{label}_splits"] = splits
                if name == "full":
                    call()
                    torch.cuda.synchronize()
                    rec[f"{label}_rel_err"] = ((du - ref).abs().max()
                                               / ref.abs().max()).item()
            print(json.dumps(rec), flush=True)
            lines.append(json.dumps(rec))
    (out_dir / "torch_kernel_ablation.jsonl").write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
