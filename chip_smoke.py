"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, serve.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device: the card (``nvidia-smi`` name and power limit) and the build of
   every CUDA kernel of the port from ``src/repro_torch/csrc``.
2. kernels: every kernel against its plain PyTorch version, for all four
   registered profiles, at the serve path's shapes (CG: 12150 x 12150,
   d=26, s=65; prediction: 64 x 12150) and one ragged shape, with times
   (CUDA events), the plain version's time, one PyTorch library yardstick,
   and the least time the card could take (``bound_ms``).
3. serve: the port's serve entry point (``repro_torch.launch.serve``) at the
   paper's full pol size, gp-iterative widths (64 probes, 1000 RFF pairs,
   Matérn-3/2), CG to 0.01 within 100 epochs, 10 outer steps, then 20
   requests of 64 rows through the bucketed engine; the launch counts must
   equal the CG MVMs plus the engine's dispatches.
4. profile: one more outer step split into CG solve and gradient time, and
   one step plus 5 requests under ``torch.profiler`` (device busy share,
   top kernels).

The line before the last lists every kernel; the last line is
``{"ok": true, "device": {...}}``. The script exits non-zero, without that
line, when there is no CUDA device, when run outside the repository, or when
any phase fails.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# Tolerances. fp32 kernel vs fp32 plain: the two sum in different orders,
# so agreement is to a few ulps of the largest output. Matérn-1/2 is held
# against a float64 evaluation at the reference's 1e-4 bound (relative to
# the largest output, as outputs sum ~10^4 terms).
TOL_VS_PLAIN = 1e-5
TOL_M12_VS_F64 = 1e-4
TOL_SERVE_VS_CPU = 1e-4

CG_SHAPE = (12150, 12150, 26, 65)
PREDICT_SHAPE = (64, 12150, 26, 65)
RAGGED_SHAPE = (1001, 777, 7, 9)
KINDS = ("rbf", "matern12", "matern32", "matern52")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str, code: int = 2) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call, from CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(n: int, m: int, d: int, s: int) -> dict:
    """Least time for one call: 2nm(d+s) flops + nm profile evaluations
    (one op each) at the fp32 CUDA-core peak, vs each input read once and
    the output written once at the HBM rate."""
    ops = 2 * n * m * (d + s) + n * m
    nbytes = 4 * (n * d + m * d + m * s + n * s)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return {"ops": ops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase_kernels(torch, tiled, registry) -> dict:
    """Kernel vs plain for every kind and shape; times at the path shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    results, main_entry = [], None
    for label, (n, m, d, s) in (("cg", CG_SHAPE), ("predict", PREDICT_SHAPE),
                                ("ragged", RAGGED_SHAPE)):
        if label == "cg":
            u = torch.randn((n, d), generator=gen, device="cuda")
            w = u  # H @ V: coincident points on the diagonal
        else:
            u = torch.randn((n, d), generator=gen, device="cuda")
            w = torch.randn((m, d), generator=gen, device="cuda")
        v = torch.randn((m, s), generator=gen, device="cuda")
        for kind in KINDS:
            out = tiled.kernel_mvm_cuda(u, w, v, kind)
            torch.cuda.synchronize()
            if kind == "matern12":
                ref = tiled.kernel_mvm_plain(u.double(), w.double(), v.double(),
                                             kind)
                tol = TOL_M12_VS_F64
            else:
                ref = tiled.kernel_mvm_plain(u, w, v, kind)
                tol = TOL_VS_PLAIN
            err = (out.double() - ref.double()).abs().max().item()
            scale = ref.abs().max().item()
            rec = {"phase": "kernels", "shape": label, "n": n, "m": m, "d": d,
                   "s": s, "kind": kind,
                   "reference": "plain_f64" if kind == "matern12" else "plain_f32",
                   "max_abs_err": err, "max_abs_out": scale,
                   "rel_err": err / scale, "tol_rel": tol,
                   "ok": bool(math.isfinite(err) and err <= tol * scale)}
            if label in ("cg", "predict"):
                kappa = registry.get_kernel(kind).kappa_from_r2

                def library(u=u, w=w, v=v, kappa=kappa):
                    return kappa(torch.cdist(u, w) ** 2) @ v

                reps = 20 if label == "cg" else 50
                rec["ms"] = time_ms(lambda: tiled.kernel_mvm_cuda(u, w, v, kind),
                                    reps)
                rec["plain_ms"] = time_ms(
                    lambda: tiled.kernel_mvm_plain(u, w, v, kind), 3)
                rec["library_ms"] = time_ms(library, 5)
                rec.update(bound(n, m, d, s))
            emit(rec)
            results.append(rec)
            if label == "cg" and kind == "matern32":
                main_entry = rec
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} kernel checks failed: {bad}")
    return main_entry


def phase_serve(torch, tiled) -> tuple:
    """The port's serve path at full pol size through the kernel."""
    from repro_torch.core.predict import predictive_metrics
    from repro_torch.launch.serve import serve_gp
    from repro_torch.serve.artifact import servable_predict

    args = SimpleNamespace(
        dataset="pol", max_n=0, train_steps=10, requests=20, seed=0,
        buckets="16,64,256", num_probes=64, device="cuda", backend="cuda",
        verbose=True)
    torch.cuda.reset_peak_memory_stats()
    tiled.reset_launch_counts()
    run = serve_gp(args)
    report, engine = run.report, run.engine
    launches = tiled.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    expected = report["cg_mvms"] + report["engine_dispatches"]
    got = launches[tiled.KERNEL_NAME]
    for st in report["steps"]:
        emit({"phase": "serve", **st})
    # Right answers: the served model on the card vs its plain version on
    # the CPU, and the whole test set's RMSE/LLH (after the counts were read).
    model, ds = engine.model, run.dataset
    xq = ds.x_test[:64]
    on_card = engine.submit(xq)
    cpu_model = model._replace(
        x=model.x.cpu(), correction=model.correction.cpu(),
        rff=model.rff._replace(z=model.rff.z.cpu(), u=model.rff.u.cpu(),
                               w=model.rff.w.cpu()),
        params=model.params.with_leaves([t.cpu() for t in model.params.leaves]))
    on_cpu = servable_predict(cpu_model, xq.cpu())
    serve_err = {}
    for field in ("mean", "var", "samples"):
        a = getattr(on_card, field).cpu().double()
        b = getattr(on_cpu, field).double()
        serve_err[field] = (a - b).abs().max().item() / b.abs().max().item()
    full = predictive_metrics(ds.y_test, engine.submit(ds.x_test), model.params)
    summary = {
        "phase": "serve", "dataset": report["dataset"],
        "n_train": report["n_train"], "n_test": report["n_test"],
        "d": report["d"], "num_probes": report["num_probes"],
        "train_steps": len(report["steps"]), "fit_seconds": report["fit_seconds"],
        "cg_mvms": report["cg_mvms"],
        "engine_dispatches": report["engine_dispatches"],
        "kernel_launches": got, "expected_launches": expected,
        "host_syncs": sum(st["host_syncs"] for st in report["steps"]),
        "peak_mem_bytes": peak,
        "latency_ms_p50": report["latency_ms_p50"],
        "latency_ms_p99": report["latency_ms_p99"],
        "queries_per_s": report["queries_per_s"],
        "rmse_first_request": report["rmse"], "llh_first_request": report["llh"],
        "rmse_test": float(full["rmse"]), "llh_test": float(full["llh"]),
        "card_vs_cpu_rel_err": serve_err, "tol_rel": TOL_SERVE_VS_CPU,
    }
    emit(summary)
    finite = all(math.isfinite(st["res_y"]) and math.isfinite(st["res_z"])
                 for st in report["steps"])
    problems = []
    if not finite:
        problems.append("non-finite solver residual")
    if got == 0 or got != expected:
        problems.append(f"kernel launches {got} != expected {expected}")
    if not all(math.isfinite(summary[k]) for k in ("rmse_test", "llh_test")):
        problems.append("non-finite test metrics")
    if not all(e <= TOL_SERVE_VS_CPU for e in serve_err.values()):
        problems.append(f"served predictions disagree with CPU: {serve_err}")
    if problems:
        raise AssertionError("; ".join(problems))
    return summary, launches, run


def phase_profile(torch, run) -> dict:
    """Where one outer step's time goes, after the serve run: the CG solve
    and the autograd gradient timed apart (host clock + synchronise), then
    one outer step and 5 requests under ``torch.profiler`` for the device's
    busy share and its top kernels."""
    from repro_torch.core.estimators import build_system_targets
    from repro_torch.core.gradients import mll_grad_estimate
    from repro_torch.core.outer import outer_step
    from repro_torch.solvers import HOperator, solve

    state, cfg, ds = run.fit.state, run.cfg, run.dataset
    x, y = ds.x_train, ds.y_train

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with torch.no_grad():
        targets = build_system_targets(state.probes, x, y, state.params)
        op = HOperator(x=x, params=state.params, backend=cfg.backend,
                       bm=cfg.bm, bn=cfg.bn)
        res, solve_s = timed(lambda: solve(op, targets, state.carry_v,
                                           cfg.solver))
    _, grad_s = timed(lambda: mll_grad_estimate(
        x, y, state.params, res.v, targets, cfg.estimator, bm=cfg.bm,
        bn=cfg.bn))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        outer_step(state, x, y, cfg)
        for i in range(5):
            run.engine.submit(ds.x_test[64 * i:64 * (i + 1)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    rec = {"phase": "profile", "cg_iters": res.iters, "cg_solve_s": solve_s,
           "grad_s": grad_s, "window": "1 outer step + 5 requests",
           "window_wall_s": wall,
           "device_busy_s": busy_us / 1e6 if busy_us else "not measured",
           "device_idle_share": 1.0 - busy_us / 1e6 / wall if busy_us
           else "not measured",
           "top_kernels": [{"name": e.key[:80], "calls": e.count,
                            "device_ms": e.self_device_time_total / 1e3}
                           for e in top]}
    emit(rec)
    return rec


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch not found next to chip_smoke.py; run it from "
             "the repository root")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import registry, tiled

    smi = nvidia_smi()
    t0 = time.perf_counter()
    lib = tiled.build_kernels()
    build_s = time.perf_counter() - t0
    ptxas = Path(f"{lib}.ptxas.txt")
    regs = sorted({int(tok) for line in ptxas.read_text().splitlines()
                   if "registers" in line
                   for tok in [line.split("Used ")[1].split(" ")[0]]}) \
        if ptxas.exists() else []
    spills = ptxas.read_text().count(" 0 bytes spill stores") if ptxas.exists() else 0
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "library": str(lib),
          "registers_per_thread": regs, "instantiations_without_spills": spills})

    failures = []
    main_entry, launches = None, {tiled.KERNEL_NAME: 0}
    try:
        main_entry = phase_kernels(torch, tiled, registry)
    except Exception:  # every phase runs; any failure fails the smoke
        traceback.print_exc()
        failures.append("kernels")
    try:
        _, launches, run = phase_serve(torch, tiled)
        phase_profile(torch, run)
    except Exception:
        traceback.print_exc()
        failures.append("serve")

    entry = {"name": tiled.KERNEL_NAME, "route": "cuda",
             "source": "src/repro_torch/csrc/kernel_mvm.cu",
             "replaces": "src/repro/kernels/tiled.py:98",
             "launches": launches[tiled.KERNEL_NAME]}
    if main_entry is not None:
        entry.update({k: main_entry[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")})
    if failures:
        fail(f"phases failed: {failures}", code=1)
    print(smi, flush=True)
    emit({"kernels": [entry]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
