"""Where the CUDA kernels' time goes: variants with one part cut.

    python3 tools/torch_kernel_ablation.py        # on a machine with a card

Builds ``src/repro_torch/csrc/kernel_mvm.cu`` and
``src/repro_torch/csrc/kernel_mvm_bwd.cu`` several times (Matérn-3/2 only,
and the forward's s-chunk of s = 65, the backward's d <= 32 registers, so
each build takes seconds), each variant with one part of the kernel's work
cut, and times them on the card in turns, two rounds. The forward runs at
the CG shape (12150 x 12150, d = 26, s = 65), the prediction shape
(64 x 12150) and the SGD slab (500 x 12150); the backward at the CG shape as
the fused call (u = w, s' = 130 padded to 136) and in the standard roles
(s = 65); each with the split count the port plans. Only ``full`` computes
the right answer (its error against the plain version is printed); the
others exist to be timed. Forward variants:

* ``no_copy``: both tile buffers are filled once and never copied again;
* ``one_buffer``: the path for large d: one tile buffer, each tile copied
  after the previous one's compute;
* ``r2_one_chunk``: r2 over the first 4 coordinates only;
* ``one_product``: big*big alone, without the two 3xTF32 correction
  products.

Backward variants (``bwd_`` in the output):

* ``no_copy``: both tile buffers are filled once and never copied again;
* ``one_product``: big*big alone;
* ``r2_one_chunk``: r2 over the first 4 coordinates only;
* ``no_contraction``: D is summed into one register instead of contracted
  with the differences;
* ``no_split``: the operands go to the tensor cores unsplit (big = x,
  small = x), so the three products remain but the split instructions go.

Prints one JSON line per variant and round, and the card's name and power
limit; the lines also go to ``build/torch_kernel_ablation.jsonl``.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((12150, 12150, 26, 65), (64, 12150, 26, 65), (500, 12150, 26, 65))
BWD_SHAPE = (12150, 26, 65)  # n = m, d, s
MATERN32 = 2


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise ValueError(f"variant anchor not found: {old[:60]!r}")
    return text.replace(old, new)


def variants(src: str) -> dict:
    """The kernel's source restricted to Matérn-3/2 and NT = 9, and the
    variants made from it."""
    base = re.sub(r"  switch \(num_nt\(s\)\) \{.*?#undef REPRO_NT_CASE",
                  "  return launch<KIND, MAX_NT>(u, w, v, out, workspace, n, m, "
                  "d, s, splits, lanes, stream);\n", src, flags=re.S)
    base = re.sub(r"  switch \(kind\) \{.*?default:\n      return -1;\n  \}",
                  "  return launch_kind<kMatern32>(u, w, v, out, workspace, n, "
                  "m, d, s, splits, lanes, st);", base, flags=re.S)
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


def main() -> int:
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
    with tempfile.TemporaryDirectory() as tmp:
        try:
            fns = _build(tiled, tmp, "", variants(
                (csrc / "kernel_mvm.cu").read_text()), "repro_kernel_mvm_fwd",
                (5, 7))
            bwd_fns = _build(tiled, tmp, "bwd_", bwd_variants(
                (csrc / "kernel_mvm_bwd.cu").read_text()),
                "repro_kernel_mvm_bwd", (6, 7))
        except RuntimeError as err:
            print(err, file=sys.stderr)
            return 1

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, m, d, s in SHAPES:
        u = torch.randn((n, d), generator=gen, device="cuda")
        w = u if n == m else torch.randn((m, d), generator=gen, device="cuda")
        v = torch.randn((m, s), generator=gen, device="cuda")
        splits = tiled.split_plan(n, m, s, sms)
        ws = torch.empty((splits, n, s), device="cuda") if splits > 1 else None
        cases.append((u, w, v, torch.empty((n, s), device="cuda"), ws, splits,
                      tiled.kernel_mvm_plain(u, w, v, "matern32")))

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

    def timed(call, reps):
        call()
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            call()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    lines = []
    for rnd in range(2):
        for name, fn in fns.items():
            rec = {"variant": name, "round": rnd, "nvidia_smi": smi}
            for u, w, v, out, ws, splits, ref in cases:
                (n, d), (m, s) = u.shape, v.shape
                stream = torch.cuda.current_stream().cuda_stream

                def call():
                    rc = fn(u.data_ptr(), w.data_ptr(), v.data_ptr(),
                            out.data_ptr(), None if ws is None else ws.data_ptr(),
                            n, m, d, s, MATERN32, splits, 1, stream)
                    if rc != 0:
                        raise RuntimeError(f"{name}: launch failed ({rc})")

                key = f"{n}x{m}"
                rec[f"{key}_ms"] = timed(call, 20 if n > 5000 else 200)
                rec[f"{key}_splits"] = splits
                if name == "full":
                    call()
                    torch.cuda.synchronize()
                    rec[f"{key}_rel_err"] = ((out - ref).abs().max()
                                             / ref.abs().max()).item()
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

                rec[f"{label}_ms"] = timed(call, 20)
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
