"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, serve, train,
refresh, serve over HTTP, train the LM substrate, decode from it and
account for the dry-run's cells.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device: the card (``nvidia-smi`` name and power limit) and the build of
   every CUDA kernel of the port from ``src/repro_torch/csrc``.
2. kernels: every kernel against its plain PyTorch version, for all four
   registered profiles, with times (CUDA events), the plain version's time,
   one PyTorch library yardstick, and the least time the card could take
   (``bound_ms``). Forward: at the paths' shapes (CG: 12150 x 12150,
   d=26, s=65; prediction: 64 x 12150; the engine's 16-row bucket; a
   500-row slab of unpadded pol; AP's column slab 13000 x 1000 and SGD's
   row slab 500 x 12500 of padded pol), each with its column split count,
   the bound as the kernel splits the work between CUDA cores and tensor
   cores and the all-fp32 bound of the earlier design, and two launches
   bitwise equal; one ragged shape, checked only; and, timed for
   Matérn-3/2, AP's column slabs at full 3droad (353000 x 1000, d=3, s=33)
   and full song (418000 x 1000, d=90, s=65) and the wide path for large
   d (8192 x 8192 at d=120 and 200). The build fails the smoke if any
   instantiation of either kernel spills registers. Backward: the fused
   call of the GP gradient (u = w, operands [g | v] and [v | g], s' = 130)
   at the CG shape, timed, with two launches bitwise equal; the CG shape
   with g != v (the standard estimator's roles, timed) and with u = w,
   g = v (pathwise); the ragged shape; and, timed for Matérn-3/2, the
   fused call at s' = 272 (two launches over column chunks), on 16 384
   rows of song (d=90) and buzz (d=77), and on the wide path (d=120, 200);
   each with its column split count and the bound split as for the
   forward kernel. Then the gradient of ``mll_grad_estimate`` through the
   kernel pair against autograd through the plain tiled MVM at n = 2000,
   for both estimators. Then (since the Matérn compat slice) the reference's
   Matérn-3/2 names at the CG shape: ``kernels.ops.matern_mvm``,
   ``kernels.tiled.matern_mvm_pallas`` and ``matern_mvm_bwd_pallas``, each
   launching its CUDA kernel (launch counts), bitwise equal to the
   ``kind="matern32"`` call it aliases, within the kernels' tolerance of
   the plain version, and timed beside that call (CUDA events). They are
   aliases, not kernels: the kernels line keeps its two entries.
3. serve: the port's serve entry point (``repro_torch.launch.serve``) at the
   paper's full pol size, gp-iterative widths (64 probes, 1000 RFF pairs,
   Matérn-3/2), CG to 0.01 within 100 epochs, 10 outer steps, then 20
   requests of 64 rows through the bucketed engine. Forward launches must
   equal the CG MVMs + 1 per outer step (the gradient) + the engine's
   dispatches; backward launches 1 per outer step (the fused call).
4. train: the port's train entry point (``repro_torch.launch.train``) at the
   full pol size: (a) CG to 0.01 with the rank-100 pivoted-Cholesky
   preconditioner, pathwise, warm start, 20 steps, eval and checkpoint every
   10; (b) the CLI's defaults (CG, standard estimator, cold start), 3 steps,
   eval at step 3; (c) AP, pathwise, warm start, 10 epochs per step,
   1000-row blocks (pol padded to 13000 rows), 10 steps, eval at step 10;
   (d) SGD likewise with 500-row batches (padded to 12500) and the paper's
   learning-rate grid. Launch counts are held to the solver's work (CG's
   MVMs; AP's initial residual and one column slab per iteration; SGD's row
   slab per iteration and the grid's solves), 1 + 1 per outer step for the
   gradient and the evaluations; then 3 steps on a small input on the card
   against the same steps on the CPU from the same state, for CG, AP and
   SGD (one block schedule handed to both).
5. profile: one more outer step of runs (a), (c) and (d) split into the
   solve's setup (preconditioner or block Cholesky), the solve (and its time
   per iteration) and the gradient, and one outer step of each under
   ``torch.profiler`` (device busy share, top kernels).
6. large: run (e), ``examples/torch_budget_large_scale.py`` at full 3droad
   (352 248 rows padded to 353 000, d = 3): the initialisation heuristic at
   the paper's defaults, then AP (1000-row blocks, 3 epochs per step, 32
   probes, pathwise) cold and warm, 5 steps each, eval at the last; per
   step iterations, epochs, residuals and time, launch counts, peak
   memory, and a profiled step of the warm run.
7. large_steps: one AP step through the train CLI at full song, buzz and
   houseelectric (1 659 916 rows), budget 1 epoch, 64 probes: setup and
   step seconds, the step split into targets, block Cholesky, the initial
   residual's full MVM, the column slabs, the rest of the solve and the
   gradient (host clock between device synchronises), launch counts and
   peak memory; then the peak memory of the row-chunked RFF prior sample
   against the unchunked one at pol and houseelectric.
8. lanes (since the lanes slice): (f) ``python -m repro_torch.launch.batch
   --dataset pol --max-n 0 --kernels matern12,matern32,matern52,rbf
   --seeds 2 --tolerances 0.01,0.05 --steps 10``, in this process: 4
   groups x 4 lanes of CG (64 probes, the config's 10-epoch budget, no
   preconditioner) at full pol; (g) AP (``--solver ap --block-size 1000
   --epoch-budgets 5,10``) and SGD (``--solver sgd --batch-size 500
   --sgd-lrs 30,70``) over 2 seeds at padded pol, Matérn-3/2; (h)
   ``fit_batch(budget_policy=...)``, AP at padded pol, a 32-slot ring, 2
   lanes, 10 steps. Per group: the launch counts (set to 0 just before the
   group and read just after: one forward launch per lane-stacked MVM,
   slab and gradient forward and one fused backward per step, whatever B
   is), every lane against the single ``fit`` of its cell (steps whose
   iteration count differs, hyperparameters held to
   ``TOL_LANE_VS_SINGLE``), the batched step time beside the sum of the
   single fits', and one lane-stacked step under ``torch.profiler``. The
   kernels phase also holds both kernels at B = 4 lane by lane to their
   plain versions (CG shape, AP and SGD slabs, the fused call at s' = 130
   and 272) and times the CG shapes at B = 1 and 4.

9. refresh (since the online-refresh slice), on the model phase 3 fitted
   at full pol, with the launch counts set to 0 just before and read just
   after (i)-(vi): (i) 256 test rows appended, ``refresh_into(mode=
   "solve", budget_epochs=10)`` warm, and the same cold from a fresh
   ``OnlineGP`` (warm epochs <= cold); (ii) 64 more rows, ``mode="auto",
   correction="damped"`` (residual <= 5 x tolerance or escalated), against
   a warm full re-solve of the same system; (iii) geometric growth with
   ``reserve=32`` and 32 rounds of a one-row append + auto/damped refresh
   into a second engine (capacity and growth events constant); (iv) one
   ``refine(mode="step")`` (one fused backward per column chunk); (v) a
   background ``refresh_into`` while 20 queued 64-row requests run on the
   engine's worker (every Future resolves; after the swap the engine
   agrees with the exported model on the CPU); (vi) ``save_servable`` /
   ``load_servable`` on the card (bitwise-equal predictions). Forward
   launches must equal every refine's kernel products
   (``RefreshReport.mvms``) plus the engines' dispatches. (viii) the
   ``refresh`` events equal the refines and the ``gp_engine_*`` /
   ``gp_refresh_*`` families' deltas equal the engines' and refreshers'
   stats. Then checks outside the counted path: every ghost row's kernel
   diagonal is kappa(0) and its cross terms exactly 0 on the card, and
   (vii) the forward kernel at the block refresh's shapes (k x n, n x k,
   k x k for k = 1, 7, 64) against its plain version, timed with its bound,
   plain and library times.
10. bo: ``run_bo`` at ``benchmarks/online_bo.py``'s ``--full`` setting (d = 2,
   n0 = 512, 2048 candidates, 8 probes, 128 RFF pairs, CG to 0.01, 5 fit
   steps, Matérn-3/2), rounds cut from 400 to 100, warm (auto + damped)
   and cold arms; warm cumulative epochs <= 0.5 x cold, launches held to
   the fit's MVMs and every round's dispatch and refresh products.

11. http (since the HTTP/cluster slice), on the model phase 3 fitted at full
   pol: (a) ``serve_gp_http`` with ``--http 127.0.0.1:0 --http-smoke
   --metrics`` (rate 1/s, burst 2: health, predict, the 429 flood with
   Retry-After, the trace echo, the /metrics families; forward launches =
   warm-up + dispatches), then 200 sequential 64-row and 200 16-row
   ``/predict`` requests to an in-process replica without a rate limit:
   p50/p99 over HTTP beside ``engine.submit``'s, every reply bitwise equal
   to ``engine.submit`` on its rows, one launch per dispatch; (b) the model
   published to a temporary store, ``--replicas 2 --monitor 127.0.0.1:0
   --fleet-smoke`` worker processes on the card (start-up seconds, device
   memory per worker, replies bitwise equal to this process's engine, then
   ``_fleet_smoke_probe``: aggregate == per-replica counters, health ==
   /stats, a kill to ``replica_up = 0`` and to PAGE in seconds), the killed
   replica respawned, and the model phase 9 refreshed published as v2:
   both replicas on v2 within 10 poll intervals, replies bitwise equal to
   an engine on v2; (c) ``POST /append`` of 64 rows into a
   ``--refresh-every`` replica (``/stats``'s refresh block shows them),
   then the refine into the replica, its forward launches =
   ``RefreshReport.mvms``.

12. distributed (since the distributed slice), on meshes of virtual
   shards of one card (``make_mesh(..., devices=[cuda:0] * P)``: every
   rotation is a device-to-device copy on the mesh's copy stream, as on a
   multi-card host), gp-iterative widths (64 probes, 1000 RFF pairs): (a)
   ``ring_h_mvm`` at full pol over (5, 2) ("data", "model") = 10 shards
   of 1215 rows against the one-launch ``h_mvm``, all four kernels, 100
   forward launches a ring MVM, both timed; over the real cards too when
   there is more than one; (b) 3 ``make_gp_outer_step`` steps (10 epochs,
   Matérn-3/2) on that mesh and on a (1, 1) mesh: hyperparameters within
   ``TOL_TRAIN_VS_CPU``, res_z falling, (10 + 2) P^2 forward and P + 2P(P
   - 1) backward launches a step, seconds and peak memory; then 3 steps
   on 600 rows, card against CPU, held on the Adam moments; (c)
   ``distributed_ap_sweeps`` at pol (block 405, ``[y | 64 probes]``,
   omega 0.3, 20 iterations, then 20 warm): the tracked residual against
   b - H v through the one-launch MVM, the relative residual falling,
   21 P^2 launches a call; (d) full 3droad (353 000 padded rows) over
   (2, 2, 2) ("pod", "data", "model"): one ring MVM against the one
   launch, one 3-epoch step (seconds, peak memory, launches); (e)
   ``fit_batch(mesh=...)`` over 2 lane positions, 4 CG lanes at full pol,
   against the unsharded run (iterations equal step for step, hypers
   within ``TOL_LANE_VS_SINGLE``), then the batch CLI with
   ``--shard-lanes`` over the cards it finds.

13. lm (since the LM substrate's training slice), after the other phases
   (it leaves the GP path's launch totals as they were: the LM path reaches
   neither kernel, and its launch counts, set to 0 before it, stay 0): (a)
   ``llama3-8b`` at its published widths (d_model 4096, 32/8 heads, d_ff
   14 336, vocab 128 256, bf16 compute, remat) cut to 2 of its 32 layers,
   3 Adam steps of ``make_train_step`` at train_4k's sequence of 4096 and a
   global batch of 2 (of 256) as 2 microbatches of one row; (b)
   ``mamba2-780m`` whole (48 layers, d_state 128, SSD chunk 256), 3 steps at
   2 x 4096 in one batch; per step the loss (the first within
   ``LM_LOSS0_WINDOW`` of ln(padded vocab) + s2 / 2, the loss of random
   logits of the head's scale), seconds after a synchronise, tokens/s,
   peak device memory and the model FLOP/s (6 N_active D over the step's
   seconds) against ``PEAK_BF16_FLOPS``; each run's cuts on a ``reduced``
   line; (c) every LM architecture's SMOKE config, 3 steps on the card and
   on the CPU from the same params and batches, at fp32 and bf16 compute
   (``TOL_LM``); (d) the train CLI's LM path, ``--arch llama3-8b --steps
   2``, on the card.

14. lm_decode (since the LM decoding slice), after lm, its launch counts
   set to 0 before it and held at 0: greedy decoding through
   ``make_serve_step`` against a bf16 cache updated in place, (a)
   ``llama3-8b`` at its published widths cut to 2 of 32 layers at
   decode_32k (128 rows, 32 768 slots); (b) ``mamba2-780m`` whole at
   decode_32k; (c) ``gemma3-4b`` at its published widths cut to one of its
   two 17-layer periods (14 SWA layers whose caches are 1024-slot ring
   buffers, 3 global) at long_500k (1 row, 524 288 slots). Each: 16 timed
   steps after 2 warm-up steps (step seconds, tokens/s, peak device
   memory), the bound (parameters as stored plus the whole cache, read
   once, over 3.35 TB/s; every step attends to all slots, so it does not
   depend on the position) and bound / measured, one profiled step; then,
   at fp32 compute and cache, decode equals ``forward_lm`` within
   ``TOL_DECODE_INVARIANT`` at full width ((a) 2 x 64 tokens, (b) 1 x 512,
   two SSD chunks, (c) 1 x 1040 with 1040 slots, so the rings wrap). (d)
   The ten SMOKE configs, 24 teacher-forced steps on the card and on the
   CPU from the same params, at fp32 (each its own cache) and bf16 (each
   step from the CPU's cache), held to the CPU tests' bounds
   (``TOL_DECODE``). (e) The serve CLI once: ``--arch llama3-8b --tokens
   8``.

15. dryrun (since the dry-run slice), after lm_decode, its launch counts
   set to 0 before it: (a) ``python -m repro_torch.launch.sweep --meshes
   single`` over all 38 runnable cells (one subprocess each, one per
   core at once),
   then ``--meshes multi --only-arch llama3-8b``; every cell must account,
   and each prints its peak GiB per chip, the three roofline terms, the
   bottleneck and ``roofline_fraction``. (b) ``run_cell`` on
   ``make_host_mesh()`` (the one card) at phase lm's and lm_decode's cuts
   (llama3-8b, 2 of 32 layers: train_4k with 2 rows as 2 microbatches,
   decode_32k whole), then the real step on the card: argument bytes equal
   the real tensors' (the reference's int32 Adam step counted), flops equal
   ``FlopCounterMode`` of the real step to ``DRYRUN_FLOPS_RTOL``, the
   estimated peak within ``DRYRUN_PEAK_FACTOR`` of
   ``torch.cuda.max_memory_allocated``, seconds beside the roofline terms.
   (c) ``lower_gp_outer_step`` at gp_392k (391 168 rows, d = 3, 64 probes,
   10 epochs) on (2, 2, 2) ("pod", "data", "model") virtual shards of the
   card, inputs from a seed, one step: (10 + 2) P^2 forward and P + 2P(P -
   1) backward launches, res_z finite, step seconds, peak memory, the
   accounting's rotation bytes per position beside the bytes the ring's
   moves copied. The 256-position production mesh is accounted only.

The line before the last lists every kernel; the last line is
``{"ok": true, "device": {...}}``. The script exits non-zero, without that
line, when there is no CUDA device, when run outside the repository, or when
any phase fails.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12

# Tolerances. fp32 kernel vs fp32 plain: the two sum in different orders,
# so agreement is to a few ulps of the largest output. Matérn-1/2 is held
# against a float64 evaluation at the reference's 1e-4 bound (relative to
# the largest output, as outputs sum ~10^4 terms).
TOL_VS_PLAIN = 1e-5
TOL_M12_VS_F64 = 1e-4
TOL_SERVE_VS_CPU = 1e-4
# Backward kernel vs its plain version, relative to the largest output:
# each entry sums m * (s + d) fp32 products with cancellation, in another
# order than the plain version's tiles.
TOL_BWD_VS_PLAIN = 2e-5
# Gradient through the kernel pair vs autograd through the plain tiled MVM,
# per leaf, relative to the largest entry (the parity tests' bound).
TOL_GRAD = 1e-4
# Three outer steps on the card vs the CPU from one state: hyperparameters
# relative to the largest (the parity tests' bound for trajectories).
TOL_TRAIN_VS_CPU = 1e-4

CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
# Run (e)'s outer steps per start mode, and the datasets of the single
# large-dataset steps.
LARGE_RUN_STEPS = 5
LARGE_STEP_DATASETS = ("song", "buzz", "houseelectric")
CG_SHAPE = (12150, 12150, 26, 65)
PREDICT_SHAPE = (64, 12150, 26, 65)
BUCKET16_SHAPE = (16, 12150, 26, 65)  # the engine's smallest bucket
SGD_SLAB_SHAPE = (500, 12150, 26, 65)  # an SGD batch's row slab
# The slabs of train runs (c) and (d): pol padded to 13000 rows for AP's
# 1000-row blocks (a column slab K(x, x_blk) @ delta) and to 12500 for SGD's
# 500-row batches (a row slab K(x_blk, x) @ v).
AP_COL_SLAB_SHAPE = (13000, 1000, 26, 65)
SGD_SLAB_PADDED_SHAPE = (500, 12500, 26, 65)
RAGGED_SHAPE = (1001, 777, 7, 9)
# The large-dataset path: AP's column slab at full 3droad (352 248 rows
# padded to 353 000, 32 probes) and at full song (417 429 padded to
# 418 000, 64 probes), and the forward kernel's wide path (d = 120, 200).
AP_SLAB_3DROAD_SHAPE = (353000, 1000, 3, 33)
AP_SLAB_SONG_SHAPE = (418000, 1000, 90, 65)
WIDE_SHAPES = ((8192, 8192, 120, 65), (8192, 8192, 200, 65))
KINDS = ("rbf", "matern12", "matern32", "matern52")
# Forward kernel: (label, shape, kinds timed). The shapes of earlier PRs
# are timed for every kind, the large-dataset ones for Matérn-3/2 only
# (their plain versions take seconds); every shape is checked for all.
FWD_SHAPES = (("cg", CG_SHAPE, KINDS), ("predict", PREDICT_SHAPE, KINDS),
              ("bucket16", BUCKET16_SHAPE, KINDS),
              ("sgd_slab", SGD_SLAB_SHAPE, KINDS),
              ("ap_col_slab", AP_COL_SLAB_SHAPE, KINDS),
              ("sgd_slab_padded", SGD_SLAB_PADDED_SHAPE, KINDS),
              ("ragged", RAGGED_SHAPE, ()),
              ("ap_col_slab_3droad", AP_SLAB_3DROAD_SHAPE, ("matern32",)),
              ("ap_col_slab_song", AP_SLAB_SONG_SHAPE, ("matern32",)),
              ("wide_d120", WIDE_SHAPES[0], ("matern32",)),
              ("wide_d200", WIDE_SHAPES[1], ("matern32",)))
# Backward kernel, the fused call on 16 384 training rows of song (d = 90)
# and buzz (d = 77), pre-scaled by the generator's lengthscale 1.6 sqrt(d)
# so the kernel's values spread over (0, 1].
FUSED_SUBSET_ROWS = 16384


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
    """Least time for one forward call, as the kernel splits the work:
    2nmd + nm operations (r2 and the profile) at the fp32 CUDA-core peak,
    3 * 2nms (kappa @ V in 3xTF32) at the TF32 tensor-core peak, and each
    input read once and the output written once at the HBM rate; the
    largest of the three. ``bound_fp32_ms`` is the all-fp32 bound of the
    earlier design (2nm(d+s) + nm operations on the CUDA cores), kept so
    shares stay comparable."""
    cuda_ops = 2 * n * m * d + n * m
    tc_ops = 3 * 2 * n * m * s
    nbytes = 4 * (n * d + m * d + m * s + n * s)
    times = {"cuda_cores": cuda_ops / PEAK_FP32_FLOPS * 1e3,
             "tensor_cores": tc_ops / PEAK_TF32_FLOPS * 1e3,
             "bytes": nbytes / PEAK_HBM_BYTES * 1e3}
    unit = max(times, key=times.get)
    fp32_ops = 2 * n * m * (d + s) + n * m
    return {"ops_cuda_cores": cuda_ops, "ops_tensor_cores": tc_ops,
            "bytes": nbytes, "bound_ms": times[unit],
            "bound_by": "bytes" if unit == "bytes" else "operations",
            "bound_unit": unit,
            "bound_fp32_ms": max(fp32_ops / PEAK_FP32_FLOPS * 1e3,
                                 times["bytes"])}


def bound_bwd(n: int, m: int, d: int, s: int, nbytes: int) -> dict:
    """Least time for one backward call at Gram width s, as the kernel
    splits the work: 2nmd (r2) + 2nmd (contraction with the differences)
    + 3nm (slope, product, row sum) operations at the fp32 CUDA-core peak,
    3 * 2nms (g v^T in 3xTF32) at the TF32 tensor-core peak, and ``nbytes``
    (each input read once, du written once) at the HBM rate; the largest
    of the three. ``bound_fp32_ms`` is the all-fp32 bound of the earlier
    design (4nmd + 2nms + 3nm operations on the CUDA cores)."""
    cuda_ops = 4 * n * m * d + 3 * n * m
    tc_ops = 3 * 2 * n * m * s
    times = {"cuda_cores": cuda_ops / PEAK_FP32_FLOPS * 1e3,
             "tensor_cores": tc_ops / PEAK_TF32_FLOPS * 1e3,
             "bytes": nbytes / PEAK_HBM_BYTES * 1e3}
    unit = max(times, key=times.get)
    fp32_ops = cuda_ops + 2 * n * m * s
    return {"ops_cuda_cores": cuda_ops, "ops_tensor_cores": tc_ops,
            "bytes": nbytes, "bound_ms": times[unit],
            "bound_by": "bytes" if unit == "bytes" else "operations",
            "bound_unit": unit,
            "bound_fp32_ms": max(fp32_ops / PEAK_FP32_FLOPS * 1e3,
                                 times["bytes"])}


def phase_kernels(torch, tiled, registry) -> dict:
    """Kernel vs plain for every kind and shape; times, split counts and
    bounds at the path shapes; two launches on the split path bitwise
    equal. The large-dataset shapes draw u with r2 ~ 6 on average (scaled
    by sqrt(3 / d)); their w is u (wide) or u's first block of rows (AP's
    slab), so coincident points meet as on the path."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results, main_entry, by_shape = [], None, {}
    for label, (n, m, d, s), timed in FWD_SHAPES:
        large = label.startswith(("ap_col_slab_", "wide_"))
        u = torch.randn((n, d), generator=gen, device="cuda")
        if large:
            u *= math.sqrt(3.0 / d)
        if label == "cg" or label.startswith("wide_"):
            w = u  # H @ V: coincident points on the diagonal
        elif large:
            w = u[:m]
        else:
            w = torch.randn((m, d), generator=gen, device="cuda")
        v = torch.randn((m, s), generator=gen, device="cuda")
        splits = tiled.split_plan(n, m, s, sms)
        for kind in KINDS:
            out = tiled.kernel_mvm_cuda(u, w, v, kind)
            again = tiled.kernel_mvm_cuda(u, w, v, kind)
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
            bitwise = bool(torch.equal(out, again))
            rec = {"phase": "kernels", "shape": label, "n": n, "m": m, "d": d,
                   "s": s, "kind": kind, "splits": splits,
                   "path": "wide" if tiled.fwd_wide(d, s) else "first",
                   "reference": "plain_f64" if kind == "matern12" else "plain_f32",
                   "max_abs_err": err, "max_abs_out": scale,
                   "rel_err": err / scale, "tol_rel": tol,
                   "two_launches_bitwise_equal": bitwise,
                   "ok": bool(math.isfinite(err) and err <= tol * scale
                              and bitwise)}
            if kind in timed:
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
                rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
                rec["share_of_bound_fp32"] = rec["bound_fp32_ms"] / rec["ms"]
                if kind == "matern32":
                    by_shape[label] = {k: rec[k] for k in (
                        "ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_unit", "bound_fp32_ms", "splits", "path")}
            emit(rec)
            results.append(rec)
            if label == "cg" and kind == "matern32":
                main_entry = rec
    main_entry["by_shape"] = by_shape
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} kernel checks failed: {bad}")
    return main_entry


def phase_kernels_bwd(torch, tiled, registry) -> dict:
    """Backward kernel vs plain for every kind: the fused call of the GP
    gradient at the CG shape (u = w, [g | v] and [v | g], s' = 130), the CG
    shape in the standard estimator's roles (w = u, g != v) and the
    pathwise ones (w = u, g = v), and the ragged shape; times at cg_fused
    and cg_standard, two launches bitwise equal at cg_fused. Then the
    large-dataset and range shapes, timed for Matérn-3/2: the fused call at
    s' = 272 (two launches), on 16 384 rows of song (d = 90) and buzz
    (d = 77), and on the wide path (d = 120, 200)."""
    from repro_torch.data.synthetic import load_dataset

    gen = torch.Generator(device="cuda").manual_seed(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def fused(label, u, g, v, timed):
        """The fused call on (u, g, v); its plain operands; the bytes it
        must move (u, g and v read once, du written once)."""
        return (label,
                lambda kind: tiled.kernel_mvm_bwd_fused_cuda(u, g, v, kind),
                (u, u, torch.cat([g, v], dim=1), torch.cat([v, g], dim=1)),
                timed, 4 * (2 * u.numel() + 2 * g.numel()),
                len(tiled.bwd_s_chunks(u.shape[1], g.shape[1], fused=True)))

    def rows(name):
        """16 384 training rows of ``name``, pre-scaled by the generator's
        lengthscale 1.6 sqrt(d)."""
        x = load_dataset(name, max_n=18205, device="cuda").x_train
        return (x[:FUSED_SUBSET_ROWS] / (1.6 * math.sqrt(x.shape[1]))).contiguous()

    n, m, d, s = CG_SHAPE
    u, g, v = rnd(n, d), rnd(n, s), rnd(m, s)
    rn, rm, rd, rs = RAGGED_SHAPE
    ragged = (rnd(rn, rd), rnd(rm, rd), rnd(rn, rs), rnd(rm, rs))
    standard_bytes = 4 * (n * d + n * s + m * s + n * d)
    k = FUSED_SUBSET_ROWS
    # label: (kernel call, plain operands (u, w, g, v), kinds timed, bytes,
    # launches per call)
    cases = [
        fused("cg_fused", u, g, v, KINDS),
        ("cg_standard", lambda kind: tiled.kernel_mvm_bwd_cuda(u, u, g, v, kind),
         (u, u, g, v), KINDS, standard_bytes, 1),
        ("cg_pathwise", lambda kind: tiled.kernel_mvm_bwd_cuda(u, u, g, g, kind),
         (u, u, g, g), (), None, 1),
        ("ragged", lambda kind: tiled.kernel_mvm_bwd_cuda(*ragged, kind),
         ragged, (), None, 1),
        # 135 probes at pol's width: s' = 272, two launches.
        fused("cg_fused_s272", u, rnd(n, 136), rnd(n, 136), ("matern32",)),
        fused("song_fused_16k", rows("song"), rnd(k, 65), rnd(k, 65),
              ("matern32",)),
        fused("buzz_fused_16k", rows("buzz"), rnd(k, 65), rnd(k, 65),
              ("matern32",)),
    ]
    for wn, _, wd, ws in WIDE_SHAPES:
        cases.append(fused(f"wide_d{wd}_fused",
                           rnd(wn, wd) * math.sqrt(3.0 / wd), rnd(wn, ws),
                           rnd(wn, ws), ("matern32",)))
    results, main_entry, by_shape = [], None, {}
    for label, call, (a, b, c, e), timed, nbytes, per_call in cases:
        splits = tiled.bwd_split_plan(a.shape[0], b.shape[0], sms)
        for kind in KINDS:
            out = call(kind)
            again = call(kind) if label == "cg_fused" else out
            torch.cuda.synchronize()
            if kind == "matern12":
                ref = tiled.kernel_mvm_bwd_plain(a.double(), b.double(),
                                                 c.double(), e.double(), kind)
                tol = TOL_M12_VS_F64
            else:
                ref = tiled.kernel_mvm_bwd_plain(a, b, c, e, kind)
                tol = TOL_BWD_VS_PLAIN
            err = (out.double() - ref.double()).abs().max().item()
            scale = ref.abs().max().item()
            bitwise = bool(torch.equal(out, again))
            rec = {"phase": "kernels_bwd", "shape": label,
                   "n": a.shape[0], "m": b.shape[0], "d": a.shape[1],
                   "s": c.shape[1], "kind": kind, "splits": splits,
                   "path": "wide" if a.shape[1] > 96 else "first",
                   "launches_per_call": per_call,
                   "reference": "plain_f64" if kind == "matern12" else "plain_f32",
                   "max_abs_err": err, "max_abs_out": scale,
                   "rel_err": err / scale, "tol_rel": tol,
                   "two_launches_bitwise_equal": bitwise,
                   "ok": bool(math.isfinite(err) and err <= tol * scale
                              and bitwise)}
            if kind in timed:
                dkappa = registry.get_kernel(kind).dkappa_dr2

                def library(a=a, b=b, c=c, e=e, dkappa=dkappa):
                    dt = (c @ e.T) * dkappa(torch.cdist(a, b) ** 2)
                    return 2.0 * (dt.sum(1, keepdim=True) * a - dt @ b)

                rec["ms"] = time_ms(lambda: call(kind), 10)
                rec["plain_ms"] = time_ms(
                    lambda: tiled.kernel_mvm_bwd_plain(a, b, c, e, kind), 2)
                rec["library_ms"] = time_ms(library, 3)
                rec.update(bound_bwd(a.shape[0], b.shape[0], a.shape[1],
                                     c.shape[1], nbytes))
                rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
                rec["share_of_bound_fp32"] = rec["bound_fp32_ms"] / rec["ms"]
                if kind == "matern32":
                    by_shape[label] = {k: rec[k] for k in (
                        "ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_unit", "bound_fp32_ms", "splits", "path",
                        "launches_per_call")}
            emit(rec)
            results.append(rec)
            if label == "cg_fused" and kind == "matern32":
                main_entry = rec
    main_entry["by_shape"] = by_shape
    main_entry["worst_rel_err"] = max(r["rel_err"] for r in results)
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} backward kernel checks failed: {bad}")
    return main_entry


def phase_grad(torch) -> None:
    """``mll_grad_estimate`` through the kernel pair (backend cuda) vs
    autograd through the plain tiled MVM (backend streamed), per leaf, on
    pol rows at n = 2000, for both estimators."""
    from repro_torch.core.gradients import mll_grad_estimate
    from repro_torch.data.synthetic import load_dataset
    from repro_torch.gp.hyperparams import HyperParams

    ds = load_dataset("pol", max_n=2223, device="cuda")
    x, y = ds.x_train[:2000], ds.y_train[:2000]
    gen = torch.Generator(device="cuda").manual_seed(2)
    v = torch.randn((2000, 9), generator=gen, device="cuda")
    targets = torch.randn((2000, 9), generator=gen, device="cuda")
    params = HyperParams.create(x.shape[1], lengthscale=2.0, device="cuda")
    bad = []
    for est in ("pathwise", "standard"):
        got, _ = mll_grad_estimate(x, y, params, v, targets, est,
                                   backend="cuda")
        ref, _ = mll_grad_estimate(x, y, params, v, targets, est, bm=512,
                                   bn=512, backend="streamed")
        scale = max(r.abs().max().item() for r in ref.leaves)
        errs = [(a - b).abs().max().item() / scale
                for a, b in zip(got.leaves, ref.leaves)]
        ok = all(math.isfinite(e) and e <= TOL_GRAD for e in errs)
        emit({"phase": "grad", "estimator": est, "n": 2000, "rel_err_per_leaf":
              errs, "tol_rel": TOL_GRAD, "ok": ok})
        if not ok:
            bad.append(est)
    if bad:
        raise AssertionError(f"kernel gradient disagrees for {bad}")


def phase_matern(torch, tiled, smi: str) -> None:
    """The Matérn-3/2 compatibility names at the CG shape (pol 12150 x
    12150, d = 26, s = 65), each against the ``kind="matern32"`` call it
    aliases (bitwise) and the plain version (``TOL_VS_PLAIN`` forward,
    ``TOL_BWD_VS_PLAIN`` backward, relative to the largest output), with
    the launches one call of each makes and CUDA-event times of both. The
    hyperparameters name another kernel: the alias fixes the kind."""
    from repro_torch.gp.hyperparams import HyperParams
    from repro_torch.kernels import ops

    n, _, d, s = CG_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x, v, g = rnd(n, d), rnd(n, s), rnd(n, s)
    params = HyperParams(torch.full((d,), 1.5, device="cuda"),
                         torch.tensor(0.3, device="cuda"),
                         torch.tensor(-1.0, device="cuda"), kernel="rbf")
    u = (x / params.lengthscales).contiguous()
    sig2 = params.signal ** 2
    fwd, bwd = tiled.KERNEL_NAME, tiled.BWD_KERNEL_NAME
    cases = (
        ("kernels.ops.matern_mvm", fwd, TOL_VS_PLAIN, 20,
         lambda: ops.matern_mvm(x, x, v, params),
         lambda: ops.kernel_mvm(x, x, v, params, kind="matern32"),
         lambda: sig2 * tiled.kernel_mvm_plain(u, u, v, "matern32")),
        ("kernels.tiled.matern_mvm_pallas", fwd, TOL_VS_PLAIN, 20,
         lambda: tiled.matern_mvm_pallas(u, u, v),
         lambda: tiled.kernel_mvm_unit(u, u, v, "matern32"),
         lambda: tiled.kernel_mvm_plain(u, u, v, "matern32")),
        ("kernels.tiled.matern_mvm_bwd_pallas", bwd, TOL_BWD_VS_PLAIN, 10,
         lambda: tiled.matern_mvm_bwd_pallas(u, u, g, v),
         lambda: tiled.kernel_mvm_bwd_unit(u, u, g, v, "matern32"),
         lambda: tiled.kernel_mvm_bwd_plain(u, u, g, v, "matern32")),
    )
    bad = []
    for name, kernel, tol, reps, alias, wrapped, plain in cases:
        launches = []
        outs = []
        for fn in (alias, wrapped):
            before = tiled.launch_counts()[kernel]
            outs.append(fn())
            torch.cuda.synchronize()
            launches.append(tiled.launch_counts()[kernel] - before)
        ref = plain()
        err = (outs[0].double() - ref.double()).abs().max().item()
        scale = ref.abs().max().item()
        bitwise = bool(torch.equal(outs[0], outs[1]))
        rec = {"phase": "matern", "name": name, "kernel": kernel,
               "shape": "cg", "n": n, "m": n, "d": d, "s": s,
               "launches_per_call": launches[0],
               "wrapped_launches_per_call": launches[1],
               "bitwise_equal_to_wrapped": bitwise,
               "max_abs_err": err, "max_abs_out": scale,
               "rel_err": err / scale, "tol_rel": tol,
               "ms": time_ms(alias, reps), "wrapped_ms": time_ms(wrapped, reps),
               "nvidia_smi": smi}
        rec["ok"] = bool(bitwise and launches[0] >= 1
                         and launches[0] == launches[1]
                         and math.isfinite(err) and err <= tol * scale)
        emit(rec)
        if not rec["ok"]:
            bad.append(rec)
    if bad:
        raise AssertionError(f"{len(bad)} Matérn alias checks failed: {bad}")


def phase_serve(torch, tiled) -> tuple:
    """The port's serve path at full pol size through the kernels."""
    from repro_torch.core.predict import predictive_metrics
    from repro_torch.launch.serve import serve_gp
    from repro_torch.serve.artifact import servable_predict

    args = SimpleNamespace(
        dataset="pol", max_n=0, train_steps=10, requests=20, seed=0,
        buckets="16,64,256", num_probes=64, device="cuda", backend="cuda",
        verbose=True, refresh_every=0)
    torch.cuda.reset_peak_memory_stats()
    tiled.reset_launch_counts()
    run = serve_gp(args)
    report, engine = run.report, run.engine
    launches = tiled.launch_counts()
    second_passes = tiled.second_pass_counts()
    peak = torch.cuda.max_memory_allocated()

    steps = len(report["steps"])
    expected = report["cg_mvms"] + steps + report["engine_dispatches"]
    got = launches[tiled.KERNEL_NAME]
    got_bwd = launches[tiled.BWD_KERNEL_NAME]
    expected_bwd = steps * len(tiled.bwd_s_chunks(
        report["d"], report["num_probes"] + 1, fused=True))
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
        "fwd_second_pass_calls": second_passes[tiled.KERNEL_NAME],
        "bwd_kernel_launches": got_bwd, "expected_bwd_launches": expected_bwd,
        "bwd_second_pass_calls": second_passes[tiled.BWD_KERNEL_NAME],
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
    if got_bwd == 0 or got_bwd != expected_bwd:
        problems.append(f"backward kernel launches {got_bwd} != expected "
                        f"{expected_bwd}")
    if not all(math.isfinite(summary[k]) for k in ("rmse_test", "llh_test")):
        problems.append("non-finite test metrics")
    if not all(e <= TOL_SERVE_VS_CPU for e in serve_err.values()):
        problems.append(f"served predictions disagree with CPU: {serve_err}")
    if problems:
        raise AssertionError("; ".join(problems))
    return summary, (launches, second_passes), run


# The refresh phase (since the online-refresh slice): pol's test rows as
# appends, the block refresh's kernel shapes, and the BO benchmark's setting.
REFRESH_K = (1, 7, 64)
BO_ROUNDS = 100  # benchmarks/online_bo.py --full runs 400
BO_SETTING = dict(d=2, n0=512, candidates=2048, probes=8, rff_pairs=128,
                  fit_steps=5)
TOL_GHOST_DIAG = 1e-6


def _cpu_model(model):
    """A served artifact with every tensor on the CPU (plain versions)."""
    return model._replace(
        x=model.x.cpu(), correction=model.correction.cpu(),
        rff=model.rff._replace(z=model.rff.z.cpu(), u=model.rff.u.cpu(),
                               w=model.rff.w.cpu()),
        params=model.params.with_leaves([t.cpu() for t in model.params.leaves]))


def _prom_totals(text: str) -> dict:
    """Each family's sample values summed over its label sets."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            series, value = line.rsplit(" ", 1)
            name = series.split("{", 1)[0]
            out[name] = out.get(name, 0.0) + float(value)
    return out


def _report_rec(label, rep) -> dict:
    return {"phase": "refresh", "run": label, "mode": rep.mode,
            "appended": rep.appended, "n": rep.n, "capacity": rep.capacity,
            "epochs": rep.epochs, "iters": rep.iters, "mvms": rep.mvms,
            "res_y": rep.res_y, "res_z": rep.res_z, "warm": rep.warm,
            "corrected": rep.corrected, "escalated": rep.escalated,
            "block_rows": rep.block_rows, "block_epochs": rep.block_epochs,
            "correction_epochs": rep.correction_epochs}


def _refresh_kernel_shapes(torch, tiled, x, params, kind) -> dict:
    """(vii) The forward kernel at the block refresh's shapes for k = 1, 7,
    64 rows: k x cap against the carry (s = 65), cap x k against dv, and
    the k x k operator of the block solve; each against its plain version,
    timed with its plain version, the library yardstick and the bound."""
    from repro_torch.kernels import registry

    gen = torch.Generator(device="cuda").manual_seed(18)
    u = (x / params.lengthscales).contiguous()
    cap, d = u.shape
    kappa = registry.get_kernel(kind).kappa_from_r2
    out, bad = {}, []
    for k in REFRESH_K:
        new = u[-k:].contiguous()
        for label, (a, b) in (("k_by_cap", (new, u)), ("cap_by_k", (u, new)),
                              ("k_by_k", (new, new))):
            s = 65
            v = torch.randn((b.shape[0], s), generator=gen, device="cuda")
            got = tiled.kernel_mvm_cuda(a, b, v, kind)
            ref = tiled.kernel_mvm_plain(a, b, v, kind)
            torch.cuda.synchronize()
            err = (got.double() - ref.double()).abs().max().item()
            scale = ref.abs().max().item()
            n, m = a.shape[0], b.shape[0]
            rec = {"phase": "refresh_kernel", "shape": f"{label}_k{k}",
                   "n": n, "m": m, "d": d, "s": s, "kind": kind,
                   "splits": tiled.split_plan(
                       n, m, s, torch.cuda.get_device_properties(0)
                       .multi_processor_count),
                   "max_abs_err": err, "rel_err": err / scale,
                   "tol_rel": TOL_VS_PLAIN}
            rec["ms"] = time_ms(lambda: tiled.kernel_mvm_cuda(a, b, v, kind),
                                50)
            rec["plain_ms"] = time_ms(
                lambda: tiled.kernel_mvm_plain(a, b, v, kind), 5)
            rec["library_ms"] = time_ms(
                lambda: kappa(torch.cdist(a, b) ** 2) @ v, 10)
            rec.update(bound(n, m, d, s))
            rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
            emit(rec)
            out[rec["shape"]] = {key: rec[key] for key in (
                "n", "m", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "bound_unit", "splits", "rel_err")}
            if not (math.isfinite(err) and err <= TOL_VS_PLAIN * scale):
                bad.append((rec["shape"], err / scale))
    if bad:
        raise AssertionError(f"refresh-shape kernel checks failed: {bad}")
    return out


def phase_refresh(torch, tiled, serve_run) -> tuple:
    """Runs (i)-(vi) and (viii) on the model ``phase_serve`` fitted at full
    pol, with the launch counts set to 0 just before and read just after;
    then (vii), the kernel at the block refresh's shapes, and the ghost-row
    checks. Returns the path's counts and (vii)'s records."""
    import tempfile

    from repro_torch.core.outer import effective_kind
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serve import (AUTO_COUPLING_FACTOR, BucketedEngine,
                                   OnlineGP, load_servable, save_servable,
                                   servable_predict)

    ds, cfg, state, engine = (serve_run.dataset, serve_run.cfg,
                              serve_run.state, serve_run.engine)
    n0, d = ds.x_train.shape
    s1 = state.carry_v.shape[1]
    tol = cfg.solver.tolerance
    kind = effective_kind(cfg, state.params)
    problems, reports, onlines = [], [], []
    engines = [engine]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_refresh_")
    obs_trace.configure(path=f"{tmp}/events.jsonl")
    before = _prom_totals(obs_metrics.render_prometheus())
    eng_before = {id(engine): engine.stats_dict()}
    seconds = {}

    def dispatches(e):
        return e.stats_dict()["batches"] - eng_before.get(id(e), {}).get(
            "batches", 0)

    def refine(online, label, **kw):
        t0 = time.perf_counter()
        into = kw.pop("into", None)
        rep = (online.refresh_into(into, **kw) if into is not None
               else online.refine(**kw))
        torch.cuda.synchronize()
        rec = _report_rec(label, rep)
        rec["seconds"] = time.perf_counter() - t0
        emit(rec)
        reports.append(rep)
        return rep

    torch.cuda.synchronize()
    tiled.reset_launch_counts()
    t_path = time.perf_counter()
    try:
        # (i) exact growth: 256 test rows, warm vs cold solve, budget 10.
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(18)
        online = OnlineGP(ds.x_train, ds.y_train, state, cfg, generator=gen)
        online.append(ds.x_test[:256], ds.y_test[:256])
        cold = OnlineGP(ds.x_train, ds.y_train, state, cfg)
        cold.append(ds.x_test[:256], ds.y_test[:256],
                    rows=online.state.probes.w_eps[n0:])
        onlines += [online, cold]
        warm_rep = refine(online, "i_solve_warm", into=engine, mode="solve",
                          budget_epochs=10.0)
        cold_rep = refine(cold, "i_solve_cold", mode="solve", warm=False,
                          budget_epochs=10.0)
        if not warm_rep.epochs <= cold_rep.epochs:
            problems.append(f"(i) warm epochs {warm_rep.epochs} > cold "
                            f"{cold_rep.epochs}")
        seconds["i_exact"] = time.perf_counter() - t0

        # (ii) auto with the damped correction on 64 more rows, against a
        # warm full re-solve to tolerance of the same appended system.
        t0 = time.perf_counter()
        online.append(ds.x_test[256:320], ds.y_test[256:320])
        check = OnlineGP(online.x, online.y, online.state, cfg)
        onlines.append(check)
        auto = refine(online, "ii_auto_damped", into=engine, mode="auto",
                      correction="damped")
        if not (max(auto.res_y, auto.res_z) <= AUTO_COUPLING_FACTOR * tol
                or auto.escalated):
            problems.append(f"(ii) residual {auto.res_y}, {auto.res_z} over "
                            "the threshold without escalation")
        full = refine(check, "ii_full_resolve_check", mode="solve")
        n_real = online.n
        a, b = online.state.carry_v[:n_real], check.state.carry_v[:n_real]
        carry_rel = ((a - b).abs().max() / b.abs().max()).item()
        emit({"phase": "refresh", "run": "ii_auto_vs_full_resolve",
              "carry_rel_diff_real_rows": carry_rel,
              "full_resolve_iters": full.iters})
        seconds["ii_auto"] = time.perf_counter() - t0

        # (iii) geometric growth: reserve 32, then 32 one-row rounds.
        t0 = time.perf_counter()
        geo = OnlineGP(ds.x_train, ds.y_train, state, cfg,
                       growth="geometric", reserve=32,
                       generator=torch.Generator(device="cuda").manual_seed(3))
        onlines.append(geo)
        cap, grown = geo.capacity, geo.stats_dict()["growth_events"]
        geo_engine = BucketedEngine(geo.export(), buckets=(16,))
        engines.append(geo_engine)
        eng_before[id(geo_engine)] = geo_engine.stats_dict()
        geo_reps = []
        for r in range(32):
            row = slice(384 + r, 385 + r)
            geo.append(ds.x_test[row], ds.y_test[row])
            geo_reps.append(refine(geo, f"iii_geometric_round{r}",
                                   into=geo_engine, mode="auto",
                                   correction="damped"))
            geo_engine.submit(ds.x_test[:16])
        gstats = geo.stats_dict()
        emit({"phase": "refresh", "run": "iii_geometric", "capacity": cap,
              "n": geo.n, "growth_events": gstats["growth_events"],
              "cum_epochs": gstats["cum_epochs"],
              "escalations": gstats["escalations"],
              "corrections": gstats["corrections"]})
        if geo.capacity != cap or gstats["growth_events"] != grown:
            problems.append(f"(iii) capacity {cap} -> {geo.capacity}, growth "
                            f"events {grown} -> {gstats['growth_events']}")
        seconds["iii_geometric"] = time.perf_counter() - t0

        # (iv) one step under exact growth: one fused backward per chunk.
        t0 = time.perf_counter()
        bwd0 = tiled.launch_counts()[tiled.BWD_KERNEL_NAME]
        step = refine(online, "iv_step", mode="step")
        bwd = tiled.launch_counts()[tiled.BWD_KERNEL_NAME] - bwd0
        chunks = len(tiled.bwd_s_chunks(d, s1, fused=True))
        if bwd != chunks:
            problems.append(f"(iv) {bwd} backward launches, {chunks} chunks")
        seconds["iv_step"] = time.perf_counter() - t0

        # (v) background refresh under 20 queued 64-row requests.
        t0 = time.perf_counter()
        online.append(ds.x_test[416:480], ds.y_test[416:480])
        n_test = ds.x_test.shape[0]

        def req(i):
            lo = (i * 64) % (n_test - 64)
            return ds.x_test[lo:lo + 64]

        futs = [engine.enqueue(req(i)) for i in range(10)]
        bg = online.refresh_into(engine, mode="auto", correction="damped",
                                 background=True)
        futs += [engine.enqueue(req(i)) for i in range(10, 20)]
        preds = [f.result(timeout=300) for f in futs]
        bg_rep = bg.result(timeout=300)
        torch.cuda.synchronize()
        engine.stop()
        reports.append(bg_rep)
        rec = _report_rec("v_background", bg_rep)
        rec["requests_resolved"] = len(preds)
        emit(rec)
        if not all(bool(torch.isfinite(p.mean).all()) for p in preds):
            problems.append("(v) non-finite predictions under load")
        xq = ds.x_test[:64]
        on_card = engine.submit(xq)
        on_cpu = servable_predict(_cpu_model(engine.model), xq.cpu())
        serve_err = {f: ((getattr(on_card, f).cpu().double()
                          - getattr(on_cpu, f).double()).abs().max()
                         / getattr(on_cpu, f).double().abs().max()).item()
                     for f in ("mean", "var", "samples")}
        emit({"phase": "refresh", "run": "v_after_swap_vs_cpu",
              "rel_err": serve_err, "tol_rel": TOL_SERVE_VS_CPU,
              "model_n": engine.model.n})
        if engine.model.n != online.n or not all(
                e <= TOL_SERVE_VS_CPU for e in serve_err.values()):
            problems.append(f"(v) after the swap: n {engine.model.n}, "
                            f"errors {serve_err}")
        seconds["v_background"] = time.perf_counter() - t0

        # (vi) artifacts: save, load on the card, bitwise-equal predictions.
        t0 = time.perf_counter()
        save_servable(f"{tmp}/artifact", engine.model, step=1)
        loaded = load_servable(f"{tmp}/artifact", device="cuda")
        twin = BucketedEngine(loaded, buckets=engine.buckets)
        engines.append(twin)
        eng_before[id(twin)] = twin.stats_dict()
        a, b = engine.submit(xq), twin.submit(xq)
        bitwise = all(torch.equal(getattr(a, f), getattr(b, f))
                      for f in ("mean", "var", "samples"))
        emit({"phase": "refresh", "run": "vi_artifact", "bitwise_equal":
              bitwise, "n": loaded.n})
        if not bitwise:
            problems.append("(vi) loaded artifact predicts differently")
        seconds["vi_artifact"] = time.perf_counter() - t0
        torch.cuda.synchronize()
    finally:
        engine.stop()
        obs_trace.configure()
    path_s = time.perf_counter() - t_path
    launches = tiled.launch_counts()
    second = tiled.second_pass_counts()

    # Launch accounting: every refine's kernel products + every dispatch.
    engine_dispatches = sum(dispatches(e) for e in engines)
    expected = {tiled.KERNEL_NAME: sum(r.mvms for r in reports)
                + engine_dispatches,
                tiled.BWD_KERNEL_NAME: len(tiled.bwd_s_chunks(d, s1,
                                                              fused=True))}
    for k, want in expected.items():
        if launches[k] == 0 or launches[k] != want:
            problems.append(f"refresh: {k} launches {launches[k]} != "
                            f"expected {want}")

    # (viii) observability: events and Prometheus families.
    events = [json.loads(line) for line in open(f"{tmp}/events.jsonl")]
    refreshes = [e for e in events if e["kind"] == "refresh"]
    refines = sum(o.stats_dict()["refines"] for o in onlines)
    after = _prom_totals(obs_metrics.render_prometheus())

    def delta(name):
        return after.get(name, 0.0) - before.get(name, 0.0)

    stats = [o.stats_dict() for o in onlines]
    want = {
        "gp_engine_requests_total": sum(
            e.stats_dict()["requests"] - eng_before[id(e)]["requests"]
            for e in engines),
        "gp_engine_batches_total": engine_dispatches,
        "gp_refresh_refines_total": refines,
        "gp_refresh_appended_rows_total": sum(st["appended_rows"]
                                              for st in stats),
        "gp_refresh_escalations_total": sum(st["escalations"] for st in stats),
        "gp_refresh_epochs_total": sum(st["cum_epochs"] for st in stats),
    }
    got = {name: delta(name) for name in want}
    obs_ok = (len(refreshes) == refines == len(reports)
              and all(abs(got[k] - v) <= 1e-9 * max(1.0, abs(v))
                      for k, v in want.items())
              and "gp_refresh_pending_appends" in after
              and "gp_engine_queue_depth" in after)
    emit({"phase": "refresh", "run": "viii_observability",
          "refresh_events": len(refreshes), "refines": refines,
          "events": len(events), "metric_deltas": got,
          "expected_deltas": want, "ok": obs_ok})
    if not obs_ok:
        problems.append(f"(viii) events {len(refreshes)} vs refines "
                        f"{refines}; metrics {got} vs {want}")

    # Ghost rows on the card (checks, after the counts were read): every
    # ghost's diagonal is kappa(0) and every cross term is exactly 0.
    from repro_torch.gp.kernels_math import profile_from_r2

    u = geo.x / geo.state.params.lengthscales
    ghosts, real = u[geo.n:].contiguous(), u[:geo.n].contiguous()
    kappa0 = float(profile_from_r2(kind)(torch.zeros((), device="cuda"),
                                         torch.ones((), device="cuda")))
    ones_g = torch.ones((ghosts.shape[0], 1), device="cuda")
    diag = tiled.kernel_mvm_cuda(ghosts, ghosts, ones_g, kind)[:, 0]
    cross = tiled.kernel_mvm_cuda(
        ghosts, real, torch.ones((real.shape[0], 1), device="cuda"), kind)
    ghost = {"ghosts": int(ghosts.shape[0]),
             "max_abs_coordinate": float(ghosts.abs().max()),
             "diag_max_abs_dev": float((diag - kappa0).abs().max()),
             "diag_equal_kappa0": int((diag == kappa0).sum()),
             "cross_nonzero": int((cross != 0).sum()),
             "finite": bool(torch.isfinite(diag).all())}
    emit({"phase": "refresh", "run": "iii_ghost_rows", "kappa0": kappa0,
          **ghost})
    if not (ghost["finite"] and ghost["diag_max_abs_dev"] <= TOL_GHOST_DIAG
            and ghost["cross_nonzero"] == 0):
        problems.append(f"(iii) ghost rows not inert: {ghost}")

    t0 = time.perf_counter()
    shapes = _refresh_kernel_shapes(torch, tiled, online.x, online.state.params,
                                    kind)
    seconds["vii_kernel_shapes"] = time.perf_counter() - t0
    summary = {
        "phase": "refresh", "run": "summary", "n_train": n0,
        "path_seconds": path_s, "seconds": seconds,
        "i_warm": {"epochs": warm_rep.epochs, "iters": warm_rep.iters},
        "i_cold": {"epochs": cold_rep.epochs, "iters": cold_rep.iters},
        "ii_auto": _report_rec("ii", auto),
        "ii_carry_rel_vs_full_resolve": carry_rel,
        "iii_geometric_round_s": seconds["iii_geometric"] / len(geo_reps),
        "iv_step_bwd_launches": bwd, "bwd_s_chunks": chunks,
        "engine_dispatches": engine_dispatches,
        "kernel_launches": launches, "expected_launches": expected,
        "fwd_second_pass_calls": second[tiled.KERNEL_NAME],
        "bwd_second_pass_calls": second[tiled.BWD_KERNEL_NAME],
        "step_iters": step.iters,
    }
    emit(summary)
    shutil.rmtree(tmp, ignore_errors=True)
    if problems:
        raise AssertionError("; ".join(problems))
    return (launches, second), shapes


def phase_bo(torch, tiled) -> tuple:
    """(ix) The BO loop at benchmarks/online_bo.py's --full setting (d = 2,
    n0 = 512, 2048 candidates, 8 probes, 128 RFF pairs, CG to 0.01, 5 fit
    steps, Matérn-3/2), rounds cut to BO_ROUNDS: warm (auto + damped) and
    cold arms from one fit, the same candidate stream; the launch counts
    over the fit and both arms held to their work."""
    from repro_torch.core.driver import fit
    from repro_torch.core.outer import OuterConfig
    from repro_torch.gp.hyperparams import HyperParams
    from repro_torch.online import BOConfig, make_gaussian_bumps, run_bo
    from repro_torch.solvers import SolverConfig

    st = BO_SETTING
    gen = torch.Generator(device="cuda").manual_seed(0)
    objective, f_opt = make_gaussian_bumps(st["d"], generator=gen,
                                           device="cuda")
    x0 = -1.0 + 2.0 * torch.rand((st["n0"], st["d"]), generator=gen,
                                 device="cuda")
    y0 = objective(x0)
    cfg = OuterConfig(
        estimator="pathwise", num_probes=st["probes"],
        num_rff_pairs=st["rff_pairs"],
        solver=SolverConfig(name="cg", tolerance=1e-2, precond_rank=0),
        num_steps=st["fit_steps"], bm=256, bn=256, backend="cuda")
    torch.cuda.synchronize()
    tiled.reset_launch_counts()
    t0 = time.perf_counter()
    res = fit(x0, y0, cfg, generator=gen, init_params=HyperParams.create(
        st["d"], lengthscale=0.3, signal=1.0, noise=0.1, device="cuda"))
    fit_s = time.perf_counter() - t0
    arms = {"warm": BOConfig(rounds=BO_ROUNDS, num_candidates=st["candidates"],
                             refresh_mode="auto", correction="damped"),
            "cold": BOConfig(rounds=BO_ROUNDS, num_candidates=st["candidates"],
                             warm=False)}
    outs = {}
    for name, bo in arms.items():
        outs[name] = run_bo(objective, x0, y0, res.state, cfg, bo=bo,
                            bounds=(-1.0, 1.0), f_opt=f_opt,
                            generator=torch.Generator(device="cuda")
                            .manual_seed(1))
    torch.cuda.synchronize()
    launches = tiled.launch_counts()
    second = tiled.second_pass_counts()
    h = res.history
    steps = len(h["iters"])
    expected = {
        tiled.KERNEL_NAME: int(h["mvms"].sum()) + steps + sum(
            1 + BO_ROUNDS + sum(e["mvms"] for e in out.history)
            for out in outs.values()),
        tiled.BWD_KERNEL_NAME: steps * len(
            tiled.bwd_s_chunks(st["d"], st["probes"] + 1, fused=True)),
    }
    rec = {"phase": "bo", "rounds": BO_ROUNDS, **st, "f_opt": f_opt,
           "fit_seconds": fit_s, "fit_iters": h["iters"].tolist(),
           "launches": launches, "expected_launches": expected,
           "fwd_second_pass_calls": second[tiled.KERNEL_NAME]}
    for name, out in outs.items():
        rec[name] = {"cum_epochs": out.cum_epochs,
                     "escalations": out.escalations,
                     "corrections": out.corrections,
                     "rounds_per_sec": out.rounds_per_sec,
                     "best_y": out.best_y, "regret": out.regret,
                     "capacity": out.refresh_stats["capacity"],
                     "growth_events": out.refresh_stats["growth_events"]}
    ratio = outs["warm"].cum_epochs / max(outs["cold"].cum_epochs, 1e-9)
    rec["epoch_ratio_warm_over_cold"] = ratio
    emit(rec)
    problems = []
    if not ratio <= 0.5:
        problems.append(f"BO warm/cold epochs {ratio:.3f} > 0.5")
    for k, want in expected.items():
        if launches[k] == 0 or launches[k] != want:
            problems.append(f"BO: {k} launches {launches[k]} != {want}")
    if not all(math.isfinite(out.best_y) for out in outs.values()):
        problems.append("BO: non-finite best y")
    if problems:
        raise AssertionError("; ".join(problems))
    return launches, second


# The HTTP phase (since the HTTP/cluster slice): request counts and widths of
# the latency runs, the fleet's poll interval and the patience for v2.
HTTP_REQUESTS = 200
HTTP_WIDTHS = (64, 16)
HTTP_POLL_S = 0.5  # the worker's default poll interval
HTTP_V2_POLLS = 10


def _compute_apps_mib() -> dict:
    """Device memory per process on the card, ``{pid: MiB}``, from
    ``nvidia-smi --query-compute-apps``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=30)
    apps = {}
    for line in out.stdout.strip().splitlines():
        pid, _, mib = line.partition(",")
        if pid.strip().isdigit() and mib.strip().isdigit():
            apps[int(pid)] = int(mib)
    return apps


def _serve_args(*argv):
    from repro_torch.launch.serve import build_parser

    return build_parser().parse_args(
        ["--buckets", "16,64,256", "--seed", "0", *argv])


def _bitwise(body, pred) -> bool:
    """Whether a /predict reply's mean and var equal ``pred``'s bit for bit
    (JSON carries each float32 exactly)."""
    import numpy as np

    return all(np.array_equal(np.float32(body[k]),
                              getattr(pred, k).cpu().numpy())
               for k in ("mean", "var"))


def _pct(values, q) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values), q))


def phase_http(torch, tiled, serve_run, v2_model) -> list:
    """Phase 11 on the model phase 3 fitted at full pol: (a) the in-process
    replica through ``serve_gp_http --http-smoke --metrics``, then 200
    sequential 64-row and 200 16-row ``/predict`` requests on a replica
    without a rate limit (p50/p99, each reply bitwise equal to
    ``engine.submit``, forward launches = warm-up + dispatches); (b) a store
    and ``--replicas 2 --monitor --fleet-smoke`` workers on the card
    (start-up seconds, device memory, bitwise replies before the kill,
    ``_fleet_smoke_probe``'s whole sequence, a respawn, then ``v2_model``
    published and picked up by both); (c) ``POST /append`` of 64 rows into
    a ``--refresh-every`` replica and the refine that absorbs them. Returns
    the counted paths' launch counts."""
    import tempfile

    from repro_torch.launch.serve import (
        _fleet_smoke_probe,
        serve_gp_http,
        start_gp_http,
    )
    from repro_torch.serve import BucketedEngine, export_servable
    from repro_torch.serve.cluster import publish_servable
    from repro_torch.serve.cluster.replica import _http_json

    ds, cfg, state = serve_run.dataset, serve_run.cfg, serve_run.state
    n_test = ds.x_test.shape[0]
    v1_model = export_servable(state, ds.x_train)
    if v2_model.n == v1_model.n:
        raise AssertionError("v2 must be the model the refresh phase grew")
    counted, problems, seconds = [], [], {}

    def post(url, payload):
        status, body = _http_json(url, payload, timeout=60)
        if status != 200:
            raise AssertionError(f"{url} -> {status}: {body}")
        return body

    def count(run):
        """Run ``run`` with the counts set to 0 just before and read just
        after; returns its result and the counts."""
        torch.cuda.synchronize()
        tiled.reset_launch_counts()
        out = run()
        torch.cuda.synchronize()
        launches = tiled.launch_counts()
        counted.append((launches, tiled.second_pass_counts()))
        return out, launches

    # (a) the in-process replica's smoke: health, predict, the 429 flood
    # with Retry-After, the trace echo and the /metrics families.
    t0 = time.perf_counter()
    args = _serve_args("--http", "127.0.0.1:0", "--http-smoke", "--metrics",
                       "--admission-qps", "1", "--admission-burst", "2")
    smoke, launches = count(lambda: serve_gp_http(args, ds, cfg, state))
    engine = smoke.frontend.target.engine
    want = len(engine.buckets) + engine.stats.batches
    rec = {"phase": "http", "run": "a_smoke",
           "engine_dispatches": engine.stats.batches,
           "warmup_dispatches": len(engine.buckets),
           "kernel_launches": launches[tiled.KERNEL_NAME],
           "expected_launches": want,
           "admission": smoke.frontend.admission.as_dict()}
    emit(rec)
    if launches[tiled.KERNEL_NAME] != want:
        problems.append(f"(a) smoke launches {rec['kernel_launches']} != "
                        f"{want}")
    seconds["a_smoke"] = time.perf_counter() - t0

    # (a) latency and bitwise replies on a replica without a rate limit.
    t0 = time.perf_counter()
    serving = start_gp_http(_serve_args("--http", "127.0.0.1:0"), ds, cfg,
                            state)
    url = serving.endpoints[0]
    server = serving.frontend.target
    reqs = [(w, slice(lo, lo + w)) for w in HTTP_WIDTHS
            for lo in ((i * w) % (n_test - w) for i in range(HTTP_REQUESTS))]
    payloads = [{"x": ds.x_test[rows].cpu().tolist()} for _, rows in reqs]
    try:
        def drive():
            out = []
            for payload in payloads:
                ts = time.perf_counter()
                body = post(url + "/predict", payload)
                out.append((time.perf_counter() - ts, body))
            return out

        # The replica's start ran the warm-up: only dispatches are counted.
        replies, launches = count(drive)
        dispatches = server.engine.stats.batches
        model = server.get("default")
        mismatched, engine_ms = 0, []
        for (_, rows), (_, body) in zip(reqs, replies):
            ts = time.perf_counter()
            pred = server.engine.submit(ds.x_test[rows], model=model)
            torch.cuda.synchronize()
            engine_ms.append((time.perf_counter() - ts) * 1e3)
            mismatched += not _bitwise(body, pred)
    finally:
        serving.close()
    lat = {}
    for w in HTTP_WIDTHS:
        idx = [i for i, (width, _) in enumerate(reqs) if width == w]
        http_ms = [replies[i][0] * 1e3 for i in idx]
        lat[str(w)] = {"http_p50_ms": _pct(http_ms, 50),
                       "http_p99_ms": _pct(http_ms, 99),
                       "engine_p50_ms": _pct([engine_ms[i] for i in idx], 50),
                       "engine_p99_ms": _pct([engine_ms[i] for i in idx], 99)}
    rec = {"phase": "http", "run": "a_latency", "requests": len(reqs),
           "latency": lat,
           "serve_phase_engine_p50_ms_64_rows":
               serve_run.report["latency_ms_p50"],
           "replies_not_bitwise_equal": mismatched,
           "engine_dispatches": dispatches,
           "kernel_launches": launches[tiled.KERNEL_NAME],
           "expected_launches": dispatches}
    emit(rec)
    summary = {"latency": lat}
    if launches[tiled.KERNEL_NAME] != dispatches or dispatches != len(reqs):
        problems.append(f"(a) {launches[tiled.KERNEL_NAME]} launches, "
                        f"{dispatches} dispatches, {len(reqs)} requests")
    if mismatched:
        problems.append(f"(a) {mismatched} replies differ from engine.submit")
    seconds["a_latency"] = time.perf_counter() - t0

    # (b) the store and two replica processes on the card.
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_http_")
    args = _serve_args("--http", "127.0.0.1:0", "--replicas", "2",
                       "--artifact-store", f"{tmp}/store", "--monitor",
                       "127.0.0.1:0", "--fleet-smoke", "--request-log",
                       f"{tmp}/logs")
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    serving = start_gp_http(args, ds, cfg, state)
    sup = serving.supervisor
    try:
        free1 = torch.cuda.mem_get_info()[0]
        rec = {"phase": "http", "run": "b_fleet", "version": serving.version,
               "startup_s": list(sup.startup_s)}
        # Per worker by pid where nvidia-smi's pids are this machine's; the
        # card's free memory before and after both workers started (this
        # process's own allocations in between: the re-exported artifact's
        # correction, 3 MB at pol).
        apps = _compute_apps_mib()
        rec["device_mib"] = {f"replica_{i}": apps.get(p.pid, "not measured")
                             for i, p in enumerate(sup._procs)}
        rec["nvidia_smi_compute_apps_mib"] = apps
        rec["workers_device_mib_from_free_memory"] = (free0 - free1) / 2**20
        xq = ds.x_test[:64]
        parent = BucketedEngine(v1_model, buckets=(16, 64, 256)).submit(xq)
        v1_equal = [_bitwise(post(ep + "/predict", {"x": xq.cpu().tolist()}),
                             parent) for ep in serving.endpoints]
        rec["v1_bitwise_equal"] = v1_equal
        rec.update(_fleet_smoke_probe(sup, serving.monitor,
                                      serving.monitor_ep, serving.endpoints,
                                      serving.xq))
        restarted = sup.check()
        t_respawn = time.monotonic()
        endpoints = None
        while time.monotonic() - t_respawn < 300:
            targets = sup.targets()
            try:
                if all(_http_json(u + "/healthz", timeout=2.0)[0] == 200
                       for u in targets.values()) and len(targets) == 2:
                    endpoints = list(targets.values())
                    break
            except OSError:
                pass
            time.sleep(0.1)
        rec["respawned"] = restarted
        rec["respawn_s"] = time.monotonic() - t_respawn
        if endpoints is None:
            raise AssertionError("(b) the killed replica did not come back")
        t_pub = time.monotonic()
        v2 = publish_servable(f"{tmp}/store", v2_model)
        on_v2 = set()
        while time.monotonic() - t_pub < HTTP_V2_POLLS * HTTP_POLL_S \
                and len(on_v2) < 2:
            for ep in endpoints:
                if _http_json(ep + "/healthz")[1].get("version") == v2:
                    on_v2.add(ep)
            time.sleep(0.02)
        rec["swap_s"] = time.monotonic() - t_pub
        rec["replicas_on_v2"] = len(on_v2)
        parent = BucketedEngine(v2_model, buckets=(16, 64, 256)).submit(xq)
        v2_replies = [post(ep + "/predict", {"x": xq.cpu().tolist()})
                      for ep in endpoints]
        rec["v2_bitwise_equal"] = [_bitwise(b, parent) for b in v2_replies]
        rec["v2_versions"] = [b["version"] for b in v2_replies]
        rec["replica_dispatches"] = [
            _http_json(ep + "/stats")[1]["engine"]["batches"]
            for ep in endpoints]
    finally:
        serving.close()
    rec["request_logs"] = sorted(os.listdir(f"{tmp}/logs"))
    emit(rec)
    summary.update({k: rec[k] for k in (
        "startup_s", "device_mib", "workers_device_mib_from_free_memory",
        "kill_to_down_s", "kill_to_page_s",
        "respawn_s", "swap_s")})
    if not all(rec["v1_bitwise_equal"]):
        problems.append(f"(b) v1 replies not bitwise: {rec['v1_bitwise_equal']}")
    if rec["replicas_on_v2"] != 2 or not all(rec["v2_bitwise_equal"]) or \
            rec["v2_versions"] != [v2, v2]:
        problems.append(f"(b) v2: {rec['replicas_on_v2']} replicas, bitwise "
                        f"{rec['v2_bitwise_equal']}, {rec['v2_versions']}")
    seconds["b_fleet"] = time.perf_counter() - t0
    shutil.rmtree(tmp, ignore_errors=True)

    # (c) /append into a --refresh-every replica, then the refine.
    t0 = time.perf_counter()
    serving = start_gp_http(_serve_args("--http", "127.0.0.1:0",
                                        "--refresh-every", "1"), ds, cfg, state)
    url, online = serving.endpoints[0], serving.online
    server = serving.frontend.target
    n0 = online.n
    try:
        rows = slice(n_test - 64, n_test)
        reply = post(url + "/append", {"x": ds.x_test[rows].cpu().tolist(),
                                       "y": ds.y_test[rows].cpu().tolist()})
        refresh = _http_json(url + "/stats")[1]["refresh"]
        rep, launches = count(lambda: online.refresh_into(
            server, name="default", budget_epochs=10.0))
        xq = ds.x_test[:16]
        body = post(url + "/predict", {"x": xq.cpu().tolist()})
        served = server.engine.submit(xq, model=server.get("default"))
        after = _http_json(url + "/stats")[1]["refresh"]
    finally:
        serving.close()
    rec = {"phase": "http", "run": "c_append", "reply": reply,
           "refresh_after_append": {k: refresh[k] for k in (
               "n", "appended_rows", "pending_appends", "refines")},
           "refresh_after_refine": {k: after[k] for k in (
               "n", "pending_appends", "refines")},
           "refine": _report_rec("c", rep), "kernel_launches": launches,
           "expected_fwd_launches": rep.mvms,
           "served_n": server.get("default").n,
           "predict_bitwise_after_refresh": _bitwise(body, served)}
    emit(rec)
    if not (reply["appended"] == 64 and refresh["n"] == n0 + 64
            and refresh["appended_rows"] == 64
            and refresh["pending_appends"] == 64
            and after["pending_appends"] == 0
            and rec["served_n"] == n0 + 64):
        problems.append(f"(c) append not shown: {rec}")
    if launches[tiled.KERNEL_NAME] != rep.mvms or rep.mvms == 0:
        problems.append(f"(c) refine launches {launches} != mvms {rep.mvms}")
    if not rec["predict_bitwise_after_refresh"]:
        problems.append("(c) /predict after the refresh differs from the "
                        "engine")
    seconds["c_append"] = time.perf_counter() - t0
    emit({"phase": "http", "run": "summary", "seconds": seconds, **summary})
    if problems:
        raise AssertionError("; ".join(problems))
    return counted


def expected_launches(tiled, h, solver, d, probes, grid=0) -> dict:
    """The launches a fit's history accounts for. Forward: every full MVM,
    every AP/SGD slab (one per iteration), the gradient's forward (1 per
    step), each evaluation's cross-MVM and solves, and the SGD grid's
    slabs and MVMs (``grid``). Backward: the gradient's fused call every
    step, one launch per column chunk of (g, v) at width d."""
    steps = len(h["iters"])
    slabs = int(h["iters"].sum()) if solver != "cg" else 0
    return {
        tiled.KERNEL_NAME: int(h["mvms"].sum()) + slabs + steps
        + int(h["eval_mvms"].sum()) + len(h["eval_step"]) + grid,
        tiled.BWD_KERNEL_NAME: steps * len(
            tiled.bwd_s_chunks(d, probes + 1, fused=True)),
    }


def _train_args(**over) -> SimpleNamespace:
    """The train CLI's flags at their defaults, with ``over`` applied."""
    from repro_torch.launch.train import build_parser

    args = build_parser().parse_args([])
    for k, v in over.items():
        setattr(args, k, v)
    return args


def phase_train(torch, tiled) -> tuple:
    """The port's train entry point at full pol size, in four runs, each
    with the launch counts set to 0 just before it and read just after."""
    from repro_torch.launch.train import run_gp

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    blocks = dict(max_n=0, pathwise=True, warm_start=True, budget=10.0,
                  steps=10, eval_every=10, device="cuda")
    runs = {
        "a_pathwise_warm": _train_args(
            max_n=0, pathwise=True, warm_start=True, steps=20, eval_every=10,
            ckpt_every=10, ckpt_dir=str(CKPT_DIR), device="cuda"),
        "b_defaults_standard_cold": _train_args(
            max_n=0, steps=3, eval_every=3, device="cuda"),
        "c_ap_pathwise_warm_budget10": _train_args(
            solver="ap", block_size=1000, **blocks),
        "d_sgd_pathwise_warm_budget10": _train_args(
            solver="sgd", batch_size=500, sgd_lr=0.0, **blocks),
    }
    problems, fits = [], {}
    totals = dict.fromkeys(tiled.LAUNCHES, 0)
    second_totals = dict.fromkeys(tiled.SECOND_PASSES, 0)
    for label, args in runs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tiled.reset_launch_counts()
        run = run_gp(args)
        torch.cuda.synchronize()
        launches = tiled.launch_counts()
        second_passes = tiled.second_pass_counts()
        peak = torch.cuda.max_memory_allocated()
        out, res, h = run.summary, run.fit, run.fit.history
        steps = len(h["iters"])
        evals = len(h["eval_step"])
        slabs = int(h["iters"].sum()) if args.solver != "cg" else 0
        expected = expected_launches(
            tiled, h, args.solver, res.state.params.raw_lengthscales.numel(),
            args.probes, grid=sum(t.iters + t.mvms for _, t in run.lr_trials))
        for k in tiled.LAUNCHES:
            totals[k] += launches[k]
            second_totals[k] += second_passes[k]
        ckpts = sorted(p.name for p in CKPT_DIR.glob("step_*.npz")) \
            if args.ckpt_dir else []
        rec = {"phase": "train", "run": label, "solver": args.solver,
               "estimator": "pathwise" if args.pathwise else "standard",
               "warm_start": args.warm_start,
               "budget_epochs": args.budget or None,
               "precond_rank": args.precond_rank if args.solver == "cg" else None,
               "n_train": int(res.state.carry_v.shape[0]),
               "num_probes": args.probes, "steps": steps,
               "step_time_s": [float(t) for t in h["step_time_s"]],
               "iters": [int(i) for i in h["iters"]],
               "epochs": [float(e) for e in h["epochs"]],
               "res_y": [float(r) for r in h["res_y"]],
               "res_z": [float(r) for r in h["res_z"]],
               "host_syncs": int(h["host_syncs"].sum()),
               "mvms": int(h["mvms"].sum()), "slabs": slabs,
               "sgd_lr": run.cfg.solver.learning_rate
               if args.solver == "sgd" else None,
               "sgd_lr_grid": [{"lr": lr, "iters": t.iters,
                                "res_sum": float(t.res_y) + float(t.res_z)}
                               for lr, t in run.lr_trials],
               "eval_step": h["eval_step"].tolist(),
               "eval_mvms": h["eval_mvms"].tolist(),
               "eval_rmse": out["eval_rmse"], "eval_llh": out["eval_llh"],
               "final_res_y": out["final_res_y"],
               "final_res_z": out["final_res_z"],
               "total_time_s": out["total_time_s"],
               "launches": launches, "expected_launches": expected,
               "fwd_second_pass_calls": second_passes[tiled.KERNEL_NAME],
               "bwd_second_pass_calls": second_passes[tiled.BWD_KERNEL_NAME],
               "peak_mem_bytes": peak, "checkpoints": ckpts}
        emit(rec)
        fits[label] = (args, run)
        for k, want in expected.items():
            if launches[k] == 0 or launches[k] != want:
                problems.append(f"{label}: {k} launches {launches[k]} != "
                                f"expected {want}")
        values = [out["final_res_y"], out["final_res_z"], *out["eval_rmse"],
                  *out["eval_llh"], *h["hypers"].ravel().tolist()]
        if not all(math.isfinite(x) for x in values):
            problems.append(f"{label}: non-finite output")
        if evals != steps // args.eval_every:
            problems.append(f"{label}: {evals} evaluations")
        if args.ckpt_dir and ckpts != ["step_10.npz", "step_20.npz"]:
            problems.append(f"{label}: checkpoints {ckpts}")
        if args.solver != "cg" and (
                rec["n_train"] % (args.block_size if args.solver == "ap"
                                  else args.batch_size)
                or any(e > args.budget for e in rec["epochs"])):
            problems.append(f"{label}: n_train {rec['n_train']} or epochs "
                            f"{rec['epochs']} outside the budget")
    problems += _train_vs_cpu(torch)
    if problems:
        raise AssertionError("; ".join(problems))
    return (totals, second_totals), fits


def _train_vs_cpu(torch) -> list:
    """Three outer steps on the card and on the CPU from one initial state,
    carried to the card through a checkpoint: hyperparameters per step,
    for CG (pathwise, warm start, rank-100 preconditioner, 8 iterations),
    AP (100-row blocks, 2 epochs) and SGD (50-row batches, 2 epochs, lr 5,
    one block schedule handed to both)."""
    import numpy as np

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core.outer import OuterConfig, init_outer_state, outer_step
    from repro_torch.data.synthetic import load_dataset
    from repro_torch.solvers import SolverConfig

    cpu = load_dataset("pol", max_n=667, device="cpu")
    gpu = load_dataset("pol", max_n=667, device="cuda")
    n = cpu.x_train.shape[0]  # 600: a multiple of both blocks
    solvers = {
        "": SolverConfig(tolerance=0.0, max_epochs=8, precond_rank=100),
        "_ap": SolverConfig(name="ap", tolerance=0.0, max_epochs=2,
                            block_size=100),
        "_sgd": SolverConfig(name="sgd", tolerance=0.0, max_epochs=2,
                             batch_size=50, learning_rate=5.0),
    }
    problems = []
    for suffix, scfg in solvers.items():
        cfg = OuterConfig(estimator="pathwise", warm_start=True, num_probes=16,
                          num_rff_pairs=256, num_steps=3, backend="cuda",
                          solver=scfg)
        state = init_outer_state(cfg, cpu.x_train,
                                 generator=torch.Generator().manual_seed(3))
        ckpt = CKPT_DIR / f"cpu_to_card{suffix}"
        save_checkpoint(str(ckpt), 0, state)
        template = init_outer_state(
            cfg, gpu.x_train,
            generator=torch.Generator(device="cuda").manual_seed(3))
        on_card, _ = restore_checkpoint(str(ckpt), template)
        rng = np.random.default_rng(4)
        schedules = [rng.integers(0, n // scfg.batch_size, size=24).tolist()
                     for _ in range(3)]
        hypers = []
        for st, ds in ((state, cpu), (on_card, gpu)):
            per_step = []
            for step in range(3):
                st, m = outer_step(st, ds.x_train, ds.y_train, cfg,
                                   batch_idx=schedules[step])
                per_step.append(m["hypers"])
            hypers.append(per_step)
        a, b = hypers
        errs = [float(abs(b[i] - a[i]).max() / abs(a[i]).max())
                for i in range(3)]
        ok = all(e <= TOL_TRAIN_VS_CPU for e in errs)
        emit({"phase": "train", "run": f"small_card_vs_cpu{suffix}",
              "solver": scfg.name, "n_train": n, "rel_err_per_step": errs,
              "tol_rel": TOL_TRAIN_VS_CPU, "ok": ok})
        if not ok:
            problems.append(f"card vs CPU trajectory ({scfg.name}): {errs}")
    return problems


def phase_profile(torch, label, args, run) -> dict:
    """Where one more outer step of a train run goes: the solve's setup (CG:
    the preconditioner build; AP: the block Cholesky factors), the solve and
    the gradient timed apart (host clock + synchronise), with the solve's
    wall time per iteration; then one outer step under ``torch.profiler``
    for the device's busy share, its time per solver iteration and its top
    kernels."""
    from repro_torch.core.estimators import build_system_targets
    from repro_torch.core.gradients import mll_grad_estimate
    from repro_torch.core.outer import outer_step
    from repro_torch.data.synthetic import load_dataset, pad_to_block_multiple
    from repro_torch.solvers import HOperator
    from repro_torch.solvers.ap import solve_ap
    from repro_torch.solvers.cg import solve_cg
    from repro_torch.solvers.precond import build_preconditioner
    from repro_torch.solvers.sgd import solve_sgd

    cfg, state, scfg = run.cfg, run.fit.state, run.cfg.solver
    ds = load_dataset(args.dataset, max_n=args.max_n, device="cuda")
    x, y = ds.x_train, ds.y_train
    if scfg.name != "cg":
        x, y, _ = pad_to_block_multiple(
            x, y, scfg.block_size if scfg.name == "ap" else scfg.batch_size)
    gen = torch.Generator(device="cuda").manual_seed(5)

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
        if scfg.name == "cg":
            setup, setup_s = timed(lambda: build_preconditioner(
                op, scfg.precond_rank))
            sol, solve_s = timed(lambda: solve_cg(op, targets, state.carry_v,
                                                  scfg, precond=setup))
        elif scfg.name == "ap":
            setup, setup_s = timed(lambda: op.all_block_cholesky(
                scfg.block_size))
            sol, solve_s = timed(lambda: solve_ap(op, targets, state.carry_v,
                                                  scfg, block_chols=setup))
        else:
            setup_s = 0.0
            sol, solve_s = timed(lambda: solve_sgd(op, targets, state.carry_v,
                                                   scfg, generator=gen))
    _, grad_s = timed(lambda: mll_grad_estimate(
        x, y, state.params, sol.v, targets, cfg.estimator, bm=cfg.bm,
        bn=cfg.bn, backend=cfg.backend))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _, m = outer_step(state, x, y, cfg, generator=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    rec = {"phase": "profile", "run": label, "solver": scfg.name,
           "iters": sol.iters, "setup": {"cg": "precond_build", "ap":
                                         "block_cholesky", "sgd": None}[scfg.name],
           "setup_s": setup_s, "solve_s": solve_s,
           "solve_s_per_iter": solve_s / max(sol.iters, 1),
           "host_syncs": sol.host_syncs, "grad_s": grad_s,
           "window": "1 outer step", "window_iters": m["iters"],
           "window_wall_s": wall,
           "device_kernel_launches": sum(e.count for e in kernels),
           "device_busy_s": busy_us / 1e6 if busy_us else "not measured",
           "device_busy_s_per_iter": busy_us / 1e6 / max(m["iters"], 1)
           if busy_us else "not measured",
           "device_idle_share": 1.0 - busy_us / 1e6 / wall if busy_us
           else "not measured",
           "top_kernels": [{"name": e.key[:80], "calls": e.count,
                            "device_ms": e.self_device_time_total / 1e3}
                           for e in top]}
    emit(rec)
    return rec


def _example(name: str):
    """A script of ``examples/`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_large(torch, tiled) -> tuple:
    """Run (e): ``examples/torch_budget_large_scale.py`` at full 3droad
    (352 248 training rows padded to 353 000, d = 3) with the paper's
    heuristic (10 000-row subsets, 10 centroids, 30 steps), AP with
    1000-row blocks, 3 epochs per step, 32 probes, pathwise, cold and then
    warm start, :data:`LARGE_RUN_STEPS` steps each, eval at the last; the
    launch counts set to 0 just before and read just after. Per start mode
    and step: iterations, epochs, residuals and step time; the paper's
    claim (warm res_z falls, cold stagnates) is printed, not gated."""
    from repro_torch.data.synthetic import load_dataset

    ex = _example("torch_budget_large_scale")
    args = ex.build_parser().parse_args([
        "--max-n", "0", "--block-size", "1000", "--subset-size", "10000",
        "--num-centroids", "10", "--heuristic-steps", "30",
        "--steps", str(LARGE_RUN_STEPS)])
    t0 = time.perf_counter()
    ds = load_dataset("3droad", max_n=0, device="cuda")
    data_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tiled.reset_launch_counts()
    t0 = time.perf_counter()
    out = ex.run(ds, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tiled.launch_counts()
    second_passes = tiled.second_pass_counts()
    peak = torch.cuda.max_memory_allocated()
    n, d = out[True].state.carry_v.shape[0], ds.x_train.shape[1]
    expected = dict.fromkeys(tiled.LAUNCHES, 0)
    problems, res_z = [], {}
    for warm in (False, True):
        h = out[warm].history
        for k, want in expected_launches(tiled, h, "ap", d, 32).items():
            expected[k] += want
        label = f"e_3droad_{'warm' if warm else 'cold'}"
        res_z[warm] = [float(r) for r in h["res_z"]]
        emit({"phase": "large", "run": label, "warm_start": warm,
              "steps": len(h["iters"]),
              "step_time_s": [float(t) for t in h["step_time_s"]],
              "iters": [int(i) for i in h["iters"]],
              "epochs": [float(e) for e in h["epochs"]],
              "res_y": [float(r) for r in h["res_y"]], "res_z": res_z[warm],
              "eval_rmse": h["eval_rmse"].tolist(),
              "eval_llh": h["eval_llh"].tolist(),
              "fit_wall_s": out[warm].wall_time_s})
        values = [*h["res_y"], *h["res_z"], *h["eval_rmse"], *h["eval_llh"],
                  *h["hypers"].ravel()]
        if not all(math.isfinite(float(x)) for x in values):
            problems.append(f"{label}: non-finite output")
        if any(e > 3.0 for e in h["epochs"]) or len(h["eval_llh"]) != 1:
            problems.append(f"{label}: epochs {h['epochs']} or evals")
    init = out["init"]
    rec = {"phase": "large", "run": "e_3droad", "n_train": ds.x_train.shape[0],
           "n_padded": n, "d": d, "n_test": ds.x_test.shape[0],
           "heuristic": {"lengthscales": init.lengthscales.tolist(),
                         "signal": float(init.signal),
                         "noise": float(init.noise)},
           "data_s": data_s, "wall_s": wall,
           "heuristic_s": wall - sum(out[w].wall_time_s for w in (False, True)),
           "launches": launches, "expected_launches": expected,
           "fwd_second_pass_calls": second_passes[tiled.KERNEL_NAME],
           "bwd_second_pass_calls": second_passes[tiled.BWD_KERNEL_NAME],
           "peak_mem_bytes": peak,
           "res_z_cold_first_last": [res_z[False][0], res_z[False][-1]],
           "res_z_warm_first_last": [res_z[True][0], res_z[True][-1]],
           "warm_res_z_falls": res_z[True][-1] < res_z[True][0],
           "warm_below_cold_at_last": res_z[True][-1] < res_z[False][-1]}
    emit(rec)
    for k, want in expected.items():
        if launches[k] == 0 or launches[k] != want:
            problems.append(f"e_3droad: {k} launches {launches[k]} != {want}")
    if n % 1000 or not all(math.isfinite(x) for x in init.flat().tolist()):
        problems.append(f"e_3droad: n {n} or heuristic {init.flat().tolist()}")
    if problems:
        raise AssertionError("; ".join(problems))
    return (launches, second_passes), (
        SimpleNamespace(dataset="3droad", max_n=0),
        SimpleNamespace(cfg=ex.config(args, True), fit=out[True]))


def phase_rff_memory(torch) -> None:
    """Peak device memory of the pathwise targets' prior sample, the
    row-chunked ``prior_sample_at`` against the unchunked ``phi(x) @ w``
    (its body before the chunking), at pol's 12 150 training rows and
    houseelectric's 1 659 916 (d = 26 and 11, 1000 pairs, 64 samples), on
    the same draws; the two within 1e-5 of the largest value."""
    from repro_torch.gp.hyperparams import HyperParams
    from repro_torch.gp.rff import init_rff, prior_sample_at, rff_features

    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(6)
    for name, n, d in (("pol", 12150, 26), ("houseelectric", 1659916, 11)):
        x = torch.randn((n, d), generator=gen, device="cuda")
        st = init_rff(gen, 1000, d, 64, device="cuda")
        params = HyperParams.create(d, device="cuda")
        rec = {"phase": "rff_memory", "dataset": name, "n": n, "d": d,
               "pairs": 1000, "samples": 64}
        outs = {}
        for label, fn in (("chunked", prior_sample_at),
                          ("unchunked", lambda a, b, c:
                           rff_features(a, b, c) @ b.w)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            outs[label] = fn(x, st, params)
            torch.cuda.synchronize()
            rec[f"{label}_s"] = time.perf_counter() - t0
            rec[f"{label}_peak_bytes"] = torch.cuda.max_memory_allocated() - base
        err = (outs["chunked"] - outs["unchunked"]).abs().max().item()
        rec["rel_err"] = err / outs["unchunked"].abs().max().item()
        emit(rec)
        del x, outs
        if not rec["rel_err"] <= 1e-5:
            raise AssertionError(f"rff chunking at {name}: {rec['rel_err']}")


@contextlib.contextmanager
def phase_timers(torch, seconds: dict):
    """Host seconds of an outer step's phases, each taken between two
    device synchronises, added into ``seconds``: the targets, the solve
    (with, inside it, the block Cholesky factors, the full MVM of the
    initial residual and the column slabs) and the gradient. The wrapped
    functions are restored on exit."""
    import repro_torch.core.outer as outer
    from repro_torch.solvers.operator import HOperator

    phases = ((outer, "build_system_targets", "targets"),
              (outer, "solve", "solve"),
              (outer, "mll_grad_estimate", "gradient"),
              (HOperator, "all_block_cholesky", "block_cholesky"),
              (HOperator, "mvm", "full_mvm"),
              (HOperator, "col_block_mvm", "column_slabs"))

    def timed(fn, key):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                seconds[key] += time.perf_counter() - t0
        return call

    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in phases]
    for owner, name, key in phases:
        seconds.setdefault(key, 0.0)
        setattr(owner, name, timed(getattr(owner, name), key))
    try:
        yield seconds
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def phase_large_steps(torch, tiled) -> tuple:
    """One outer step of AP through the train CLI at full song (d = 90),
    buzz (d = 77) and houseelectric (1 659 916 rows, d = 11): ``--max-n 0
    --solver ap --pathwise --warm-start --budget 1 --steps 1 --eval-every
    0`` with the CLI's defaults otherwise (64 probes, 1000-row blocks),
    with the launch counts set to 0 just before and read just after. Per
    dataset: the host's seconds to load, pad and set up, the step's
    seconds split by :func:`phase_timers`, iterations, epochs, residuals,
    launches and peak memory."""
    from repro_torch.launch.train import run_gp

    totals = dict.fromkeys(tiled.LAUNCHES, 0)
    second_totals = dict.fromkeys(tiled.SECOND_PASSES, 0)
    problems = []
    for name in LARGE_STEP_DATASETS:
        args = _train_args(dataset=name, max_n=0, solver="ap", pathwise=True,
                           warm_start=True, budget=1.0, steps=1,
                           eval_every=0, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tiled.reset_launch_counts()
        t0 = time.perf_counter()
        with phase_timers(torch, {}) as phase:
            run = run_gp(args)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = tiled.launch_counts()
        second_passes = tiled.second_pass_counts()
        peak = torch.cuda.max_memory_allocated()
        h, state = run.fit.history, run.fit.state
        n, d = state.carry_v.shape[0], state.params.raw_lengthscales.numel()
        expected = expected_launches(tiled, h, "ap", d, args.probes)
        phase["solve_rest"] = phase["solve"] - sum(
            phase[k] for k in ("block_cholesky", "full_mvm", "column_slabs"))
        iters = int(h["iters"][0])
        emit({"phase": "large_steps", "dataset": name, "n_padded": n, "d": d,
              "num_probes": args.probes, "block_size": args.block_size,
              "budget_epochs": args.budget, "wall_s": wall,
              "setup_s": wall - run.fit.wall_time_s,
              "step_s": float(h["step_time_s"][0]), "phase_s": phase,
              "slab_s_per_iter": phase["column_slabs"] / max(iters, 1),
              "iters": iters, "epochs": float(h["epochs"][0]),
              "res_y": float(h["res_y"][0]), "res_z": float(h["res_z"][0]),
              "launches": launches, "expected_launches": expected,
              "fwd_second_pass_calls": second_passes[tiled.KERNEL_NAME],
              "bwd_second_pass_calls": second_passes[tiled.BWD_KERNEL_NAME],
              "peak_mem_bytes": peak})
        for k in tiled.LAUNCHES:
            totals[k] += launches[k]
            second_totals[k] += second_passes[k]
            if launches[k] == 0 or launches[k] != expected[k]:
                problems.append(f"{name}: {k} launches {launches[k]} != "
                                f"{expected[k]}")
        values = [h["res_y"][0], h["res_z"][0], *h["hypers"].ravel()]
        if not all(math.isfinite(float(x)) for x in values):
            problems.append(f"{name}: non-finite output")
        if n % args.block_size or h["epochs"][0] > args.budget:
            problems.append(f"{name}: n {n} or epochs {h['epochs'][0]}")
        del run
    if problems:
        raise AssertionError("; ".join(problems))
    return totals, second_totals


LANE_COUNTS = (1, 4)
# Lane-batched kernel checks at B = 1 and 4 (label, n, m, d, s), each lane
# held to the plain version of its operands and timed.
LANE_FWD_SHAPES = (("cg", *CG_SHAPE), ("ap_col_slab", *AP_COL_SLAB_SHAPE),
                   ("sgd_slab_padded", *SGD_SLAB_PADDED_SHAPE))
LANE_BWD_SHAPES = (("cg_fused", 12150, 12150, 26, 65),
                   ("cg_fused_s272", 12150, 12150, 26, 136))
# A lane of a lane-stacked fit vs the single fit of its cell: the lanes'
# launches plan their own splits, so sums run in another order and a CG
# count at the tolerance may shift; the hyperparameters per step are held
# to this relative error of the largest.
TOL_LANE_VS_SINGLE = 1e-3
BATCH_OUT = ROOT / "build" / "chip_smoke_batch"


def phase_kernel_lanes(torch, tiled) -> dict:
    """Both kernels on lane-stacked operands (Matérn-3/2) at B = 1 and 4:
    each lane against the plain version of its operands at every shape of
    LANE_FWD_SHAPES / LANE_BWD_SHAPES (one launch for all lanes, or one
    per column chunk), timed per call and per lane, with the split count
    each plans, beside B times one lane's bound, the plain version over
    the lanes in turn and the batched library yardstick (materialised
    ``cdist``, the profile and ``matmul``)."""
    from repro_torch.kernels import registry

    gen = torch.Generator(device="cuda").manual_seed(3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kappa = registry.get_kernel("matern32").kappa_from_r2
    dkappa = registry.get_kernel("matern32").dkappa_dr2
    out = {tiled.KERNEL_NAME: {}, tiled.BWD_KERNEL_NAME: {}}
    bad = []
    for label, n, m, d, s in LANE_FWD_SHAPES + LANE_BWD_SHAPES:
        fused = label.startswith("cg_fused")
        name = tiled.BWD_KERNEL_NAME if fused else tiled.KERNEL_NAME
        rec = {"phase": "kernel_lanes", "kernel": name, "shape": label,
               "n": n, "m": m, "d": d, "s": s, "kind": "matern32"}
        for lanes in LANE_COUNTS:
            u = torch.randn((lanes, n, d), generator=gen, device="cuda")
            if fused:
                g = torch.randn((lanes, n, s), generator=gen, device="cuda")
                v = torch.randn((lanes, n, s), generator=gen, device="cuda")

                def call(u=u, g=g, v=v):
                    return tiled.kernel_mvm_bwd_fused_cuda(u, g, v, "matern32")

                def plain(i, u=u, g=g, v=v):
                    return tiled.kernel_mvm_bwd_plain(
                        u[i], u[i], torch.cat([g[i], v[i]], 1),
                        torch.cat([v[i], g[i]], 1), "matern32")

                def library(u=u, g=g, v=v):
                    dt = (torch.cat([g, v], -1)
                          @ torch.cat([v, g], -1).transpose(1, 2)) \
                        * dkappa(torch.cdist(u, u) ** 2)
                    return 2.0 * (dt.sum(-1, keepdim=True) * u - dt @ u)
                one = bound_bwd(n, n, d, 2 * s, 4 * (2 * n * d + 2 * n * s))
                splits = tiled.bwd_split_plan(n, n, sms, lanes)
                tol = TOL_BWD_VS_PLAIN
            else:
                w = u if label == "cg" else torch.randn(
                    (lanes, m, d), generator=gen, device="cuda")
                v = torch.randn((lanes, m, s), generator=gen, device="cuda")

                def call(u=u, w=w, v=v):
                    return tiled.kernel_mvm_cuda(u, w, v, "matern32")

                def plain(i, u=u, w=w, v=v):
                    return tiled.kernel_mvm_plain(u[i], w[i], v[i], "matern32")

                def library(u=u, w=w, v=v):
                    return kappa(torch.cdist(u, w) ** 2) @ v
                one = bound(n, m, d, s)
                splits = tiled.split_plan(n, m, s, sms, lanes)
                tol = TOL_VS_PLAIN
            got = call()
            torch.cuda.synchronize()
            errs = []
            for i in range(lanes if lanes > 1 else 1):
                ref = plain(i)
                errs.append((got[i] - ref).abs().max().item()
                            / ref.abs().max().item())
            key = f"B{lanes}"
            rec[key] = {"splits": splits, "rel_err_per_lane": errs,
                        "tol_rel": tol}
            ms = time_ms(call, 10 if fused else 20)
            rec[key].update({
                "ms": ms, "ms_per_lane": ms / lanes,
                "bound_ms": lanes * one["bound_ms"],
                "bound_by": one["bound_by"], "bound_unit": one["bound_unit"],
                "plain_ms": time_ms(lambda: [plain(i) for i in range(lanes)],
                                    2),
                "library_ms": time_ms(library, 3)})
            if not all(math.isfinite(e) and e <= tol for e in errs):
                bad.append((label, lanes, errs))
        emit(rec)
        out[name][label] = {k: rec[k] for k in rec if k.startswith("B")}
    if bad:
        raise AssertionError(f"lane-stacked kernel checks failed: {bad}")
    return out


def _batch_args(**over) -> SimpleNamespace:
    """The batch CLI's flags at their defaults, with ``over`` applied."""
    from repro_torch.launch.batch import build_parser

    args = build_parser().parse_args([])
    for k, v in over.items():
        setattr(args, k, v)
    return args


def _argv(args) -> list:
    """The batch CLI command line of ``args`` (flags that differ from the
    defaults)."""
    from repro_torch.launch.batch import build_parser

    defaults = vars(build_parser().parse_args([]))
    argv = []
    for k, v in vars(args).items():
        if v == defaults[k]:
            continue
        flag = "--" + k.replace("_", "-")
        argv += [flag] if v is True else [flag, str(v)]
    return argv


def expected_lane_launches(tiled, cfg, results, d) -> dict:
    """The launches of a lane-stacked fit: per step, one forward launch per
    lane-stacked full MVM (CG: its iterations + 1; AP: the initial
    residual), per AP/SGD slab (the loop's iterations, the largest lane's
    count) and for the gradient's forward; one fused backward launch per
    column chunk, whatever the lane count."""
    h0 = results[0].history
    steps = len(h0["iters"])
    slabs = 0 if cfg.solver.name == "cg" else sum(
        max(int(r.history["iters"][k]) for r in results) for k in range(steps))
    chunks = len(tiled.bwd_s_chunks(d, cfg.num_probes + 1, fused=True))
    return {tiled.KERNEL_NAME: int(h0["mvms"].sum()) + slabs + steps,
            tiled.BWD_KERNEL_NAME: steps * chunks}


def _profile_lanes_step(torch, states, x, y, cfg, nums, gens) -> dict:
    """One lane-stacked outer step under ``torch.profiler``: wall time,
    device busy time and idle share, kernel launches."""
    from repro_torch.core.outer import outer_step_lanes

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _, m = outer_step_lanes(states, x, y, cfg, numerics=nums,
                                generators=gens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"window_wall_s": wall, "window_iters": m["iters"].tolist(),
            "device_busy_s": busy if busy else "not measured",
            "device_idle_share": 1.0 - busy / wall if busy else "not measured",
            "device_kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:80], "calls": e.count,
                             "device_ms": e.self_device_time_total / 1e3}
                            for e in top]}


def _run_batch(torch, tiled, label, args) -> tuple:
    """``python -m repro_torch.launch.batch`` in this process with the flags
    of ``args``; per group, right after its ``fit_batch`` call: the launch
    counts (set to 0 just before the group and read just after, held to
    one forward launch per lane-stacked MVM, slab and gradient forward and
    one fused backward per step, whatever B is), then every lane's single
    ``fit`` with that cell's seed and numerics (per-step iterations and
    hyperparameters held to the lane's), the step times and a profiled
    lane-stacked step. Returns the groups' launch totals and problems."""
    import numpy as np

    from repro_torch.core.outer import stack_states
    from repro_torch.launch import batch
    from repro_torch.solvers import stack_numerics

    shutil.rmtree(args.out, ignore_errors=True)
    x, y = batch._load_data(batch.sweep_archs(
        args.kernels.split(","), args.smoke), args)
    totals = dict.fromkeys(tiled.LAUNCHES, 0)
    second_totals = dict.fromkeys(tiled.SECOND_PASSES, 0)
    problems, groups = [], []

    def on_group(cfg, cells, results, seconds):
        torch.cuda.synchronize()
        launches = tiled.launch_counts()
        second = tiled.second_pass_counts()
        h0 = results[0].history
        steps = len(h0["iters"])
        expected = expected_lane_launches(tiled, cfg, results, x.shape[1])
        for k in tiled.LAUNCHES:
            totals[k] += launches[k]
            second_totals[k] += second[k]
            if launches[k] == 0 or launches[k] != expected[k]:
                problems.append(f"{label} {cfg.kind}: {k} launches "
                                f"{launches[k]} != expected {expected[k]}")
        batched_step_s = [float(t) * len(results) for t in h0["step_time_s"]]
        lanes_rec, single_s = [], 0.0
        for c, res in zip(cells, results):
            one = batch.single_cell_fit(c, args, x, y)
            single_s += float(one.history["step_time_s"].sum())
            differ = int(np.sum(one.history["iters"] != res.history["iters"]))
            a, b = one.history["hypers"], res.history["hypers"]
            err = float(np.abs(a - b).max() / np.abs(a).max())
            lanes_rec.append({"seed": c.seed, "tag": c.tag,
                              "iters": res.history["iters"].tolist(),
                              "single_iters": one.history["iters"].tolist(),
                              "steps_iters_differ": differ,
                              "hypers_rel_err": err,
                              "final_res_y": float(res.history["res_y"][-1]),
                              "final_res_z": float(res.history["res_z"][-1])})
            finite = np.all(np.isfinite(b)) and np.all(np.isfinite(
                res.history["res_y"]))
            if not finite and cfg.solver.name != "sgd":
                problems.append(f"{label} {cfg.kind} s{c.seed}{c.tag}: "
                                "non-finite lane")
            if not err <= TOL_LANE_VS_SINGLE and np.all(np.isfinite(a)):
                problems.append(f"{label} {cfg.kind} s{c.seed}{c.tag}: lane "
                                f"vs single hypers {err}")
        states = stack_states([r.state for r in results])
        nums = stack_numerics([batch.cell_numerics(c, args) for c in cells])
        gens = [torch.Generator(device="cuda").manual_seed(c.seed + 1000)
                for c in cells]
        prof = _profile_lanes_step(torch, states, x, y, cfg, nums, gens)
        rec = {"phase": "lanes", "run": label, "kernel": cfg.kind,
               "solver": cfg.solver.name, "lanes": len(cells),
               "n_train": int(x.shape[0]), "num_probes": cfg.num_probes,
               "steps": steps, "group_s": seconds,
               "batched_step_s": batched_step_s,
               "batched_s_total": sum(batched_step_s),
               "single_fits_s_total": single_s,
               "launches": launches, "expected_launches": expected,
               "fwd_second_pass_calls": second[tiled.KERNEL_NAME],
               "bwd_second_pass_calls": second[tiled.BWD_KERNEL_NAME],
               "lanes_vs_single": lanes_rec,
               "steps_iters_differ_total": sum(r["steps_iters_differ"]
                                               for r in lanes_rec),
               "profiled_batched_step": prof}
        emit(rec)
        groups.append(rec)
        tiled.reset_launch_counts()

    tiled.reset_launch_counts()
    rc = batch.main(_argv(args), on_group=on_group)
    status = json.loads((Path(args.out) / "_sweep_status.json").read_text())
    emit({"phase": "lanes", "run": label, "argv": _argv(args), "rc": rc,
          "status": status})
    if rc != 0 or status["failures"]:
        problems.append(f"{label}: batch rc {rc}, failures "
                        f"{status['failures']}")
    if status["num_compiles"] != status["groups"] or not groups:
        problems.append(f"{label}: {status['num_compiles']} fit_batch calls "
                        f"for {status['groups']} groups")
    return (totals, second_totals), problems


def _budget_lanes(torch, tiled) -> tuple:
    """Run (h): ``fit_batch(budget_policy=...)``, AP at padded pol
    (1000-row blocks, 64 probes, pathwise, warm, tolerance 0.01, at most 10
    epochs per step, a 32-slot residual ring), 2 lanes (seeds 0, 1), 10
    steps; the allocation per lane and step, and each lane held to its
    single ``fit(budget_policy=...)``."""
    import numpy as np

    from repro_torch.core.driver import fit, fit_batch
    from repro_torch.core.outer import OuterConfig
    from repro_torch.data.synthetic import load_dataset, pad_to_block_multiple
    from repro_torch.solvers import SolverConfig
    from repro_torch.solvers.adaptive import make_budget_policy

    ds = load_dataset("pol", max_n=0, device="cuda")
    x, y, _ = pad_to_block_multiple(ds.x_train, ds.y_train, 1000)
    cfg = OuterConfig(estimator="pathwise", warm_start=True, num_probes=64,
                      num_rff_pairs=1000, kind="matern32", num_steps=10,
                      backend="cuda",
                      solver=SolverConfig(name="ap", tolerance=0.01,
                                          max_epochs=10.0, block_size=1000,
                                          record_history=32))
    policy = make_budget_policy()
    tiled.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lanes = fit_batch(x, y, cfg, [0, 1], budget_policy=policy)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tiled.launch_counts()
    second = tiled.second_pass_counts()
    problems, recs = [], []
    for seed, res in enumerate(lanes):
        one = fit(x, y, cfg, generator=torch.Generator(device="cuda")
                  .manual_seed(seed), budget_policy=policy, steps_per_round=0)
        a, b = one.history["hypers"], res.history["hypers"]
        err = float(np.abs(a - b).max() / np.abs(a).max())
        rec = {"seed": seed,
               "budget_alloc": res.history["budget_alloc"].tolist(),
               "single_budget_alloc": one.history["budget_alloc"].tolist(),
               "iters": res.history["iters"].tolist(),
               "single_iters": one.history["iters"].tolist(),
               "epochs": res.history["epochs"].tolist(),
               "res_z": res.history["res_z"].tolist(),
               "pred_to_tol": res.history["budget_pred_to_tol"].tolist(),
               "hypers_rel_err": err}
        recs.append(rec)
        if not err <= TOL_LANE_VS_SINGLE:
            problems.append(f"budget lane {seed} vs single hypers {err}")
        if not np.all(np.isfinite(b)):
            problems.append(f"budget lane {seed}: non-finite hypers")
    expected = expected_lane_launches(tiled, cfg, lanes, x.shape[1])
    emit({"phase": "lanes", "run": "h_budget_ap", "n_train": int(x.shape[0]),
          "wall_s": wall, "launches": launches, "expected_launches": expected,
          "fwd_second_pass_calls": second[tiled.KERNEL_NAME],
          "bwd_second_pass_calls": second[tiled.BWD_KERNEL_NAME],
          "lanes": recs})
    for k in tiled.LAUNCHES:
        if launches[k] == 0 or launches[k] != expected[k]:
            problems.append(f"budget lanes: {k} launches {launches[k]} != "
                            f"expected {expected[k]}")
    return (launches, second), problems


def phase_lanes(torch, tiled) -> list:
    """Runs (f)-(h): the batch CLI at full pol over the kernel x seed x
    tolerance grid (CG), then AP over seeds x epoch budgets and SGD over
    seeds x learning rates at padded pol, then adaptive budget lanes."""
    runs = {
        "f_cg_kernels": _batch_args(
            dataset="pol", max_n=0, kernels="matern12,matern32,matern52,rbf",
            seeds=2, tolerances="0.01,0.05", steps=10, device="cuda",
            out=str(BATCH_OUT / "f")),
        "g_ap_budgets": _batch_args(
            dataset="pol", max_n=0, kernels="matern32", solver="ap",
            block_size=1000, seeds=2, epoch_budgets="5,10", steps=10,
            device="cuda", out=str(BATCH_OUT / "g_ap")),
        "g_sgd_lrs": _batch_args(
            dataset="pol", max_n=0, kernels="matern32", solver="sgd",
            batch_size=500, seeds=2, sgd_lrs="30,70", steps=10,
            device="cuda", out=str(BATCH_OUT / "g_sgd")),
    }
    path_launches, problems = [], []
    for label, args in runs.items():
        launches, found = _run_batch(torch, tiled, label, args)
        path_launches.append(launches)
        problems += found
    launches, found = _budget_lanes(torch, tiled)
    path_launches.append(launches)
    problems += found
    if problems:
        raise AssertionError("; ".join(problems))
    return path_launches


# -- phase 12: the distributed GP path on virtual shards -------------------

# (5, 2) ("data", "model") over 10 virtual cuda:0 shards: 1215 pol rows
# each; (2, 2, 2) ("pod", "data", "model") over 8: 44 125 rows of padded
# 3droad each.
DIST_POL_MESH = ((5, 2), ("data", "model"))
DIST_3DROAD_MESH = ((2, 2, 2), ("pod", "data", "model"))
# The ring against the one-launch MVM: both run the forward kernel (3xTF32
# products) on the same entries; only the order of the sums differs (P
# tiles, each with its own column split plan), so the two are held to this
# relative error of the largest entry, the kernel-vs-plain bound's order.
TOL_RING_VS_ONE = 2e-5
# Distributed steps held against each other (P = 10 vs P = 1, card vs
# CPU). Summation order alone puts the gradients' components about 2.4e-5
# of the largest apart in absolute terms, all alike (CPU, P = 10 vs P = 1
# at 600 pol rows), so the Adam first moments are held per component at
# TOL_MU_RTOL of themselves plus TOL_MU_ATOL of the largest. Adam's update
# is normalised per component, so a near-zero gradient's rounding moves
# its hyperparameter: those sound runs end 1.0e-3 of the largest apart
# after 3 steps, and the small card-vs-CPU run is held to 3x that
# (tests/test_torch_distributed.py pins both).
TOL_MU_ATOL, TOL_MU_RTOL = 5e-5, 1e-2
TOL_HYPERS_SMALL_STEPS = 3e-3
DIST_STEPS = 3
DIST_EPOCHS = 10
DIST_AP = dict(block_size=405, num_iters=20, omega=0.3)  # 3 blocks a shard
DIST_LANE_DEVICES = 2
BATCH_SHARD_OUT = ROOT / "build" / "chip_smoke_batch_shard"
# The forward kernel at the distributed path's shapes (label, n, m, d, s):
# a pol ring tile, a 3droad ring tile, and an AP slab of the pol ring
# (K(x_loc, x_blk) @ delta).
RING_TILE_SHAPES = (("ring_tile_pol", 1215, 1215, 26, 65),
                    ("ring_tile_3droad", 44125, 44125, 3, 65),
                    ("ap_ring_slab_pol", 1215, 405, 26, 65))
# The backward kernel at the ring's tiles (label, n, m, d, s): the
# gradient of a step takes du and dw of every tile whose operands differ
# and the fused call (s' = 2s) on each position's own tile.
RING_BWD_SHAPES = (("ring_tile_pol_bwd", 1215, 1215, 26, 65),
                   ("ring_tile_3droad_bwd", 44125, 44125, 3, 65))


def _virtual_mesh(torch, shape, axes):
    """``shape`` positions, every one on cuda:0."""
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, axes,
                     devices=[torch.device("cuda", 0)] * math.prod(shape))


def _counted(torch, tiled, fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after (synchronised): (result, seconds, (launches, second passes))."""
    torch.cuda.synchronize()
    tiled.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, seconds, (tiled.launch_counts(), tiled.second_pass_counts())


def _ring_vs_one(torch, tiled, x, v, params, mesh, kind, timed=True) -> dict:
    """``ring_h_mvm`` over ``mesh`` (counted) against the one-launch
    ``h_mvm``, and both timed (CUDA events)."""
    from repro_torch.distributed.ring import ring_h_mvm
    from repro_torch.distributed.sharding import shard_rows
    from repro_torch.kernels.ops import h_mvm

    xs, vs = shard_rows(x, mesh), shard_rows(v, mesh)
    ring, seconds, counts = _counted(
        torch, tiled, lambda: ring_h_mvm(xs, vs, params, mesh, kind=kind))
    one = h_mvm(x, v, params, kind=kind)
    err = ((ring.gather(x.device) - one).abs().max()
           / one.abs().max()).item()
    rec = {"kind": kind, "positions": mesh.size, "rows_per_shard":
           x.shape[0] // mesh.size, "launches": counts[0],
           "first_call_s": seconds, "rel_err_vs_one_launch": err}
    if not timed:  # large shapes: one call of each, host clock
        _, rec["one_launch_s"], _ = _counted(
            torch, tiled, lambda: h_mvm(x, v, params, kind=kind))
    else:
        rec["ring_ms"] = time_ms(
            lambda: ring_h_mvm(xs, vs, params, mesh, kind=kind), 5)
        rec["one_launch_ms"] = time_ms(lambda: h_mvm(x, v, params, kind=kind),
                                       5)
    return rec, counts


def _ring_tiles(torch, tiled, registry) -> dict:
    """Both kernels (Matérn-3/2, the steps' kind) at the distributed path's
    shapes against their plain versions, timed with their bound, plain and
    library times: the forward kernel at RING_TILE_SHAPES, the backward
    kernel at RING_BWD_SHAPES in both of the ring's calls (du of a tile
    whose operands differ; the fused call of a position's own tile, s' =
    2s). u and w are distinct rows, as on a ring step; the 3droad tiles
    have r2 ~ 6 on average, as the large-dataset shapes of phase 2."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    reg = registry.get_kernel("matern32")
    out, bad = {"fwd": {}, "bwd": {}}, []

    def inputs(n, m, d, s):
        scale = math.sqrt(3.0 / d) if d < 10 else 1.0
        return (scale * torch.randn((n, d), generator=gen, device="cuda"),
                scale * torch.randn((m, d), generator=gen, device="cuda"),
                torch.randn((n, s), generator=gen, device="cuda"),
                torch.randn((m, s), generator=gen, device="cuda"))

    def check(which, label, call, plain, library, rec, tol):
        got, ref = call(), plain()
        err = (got - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        big = rec["n"] > 10000
        rec.update({"phase": "distributed", "run": f"tiles_{which}",
                    "shape": label, "kind": "matern32", "max_abs_err": err,
                    "rel_err": rel, "tol_rel": tol,
                    "ms": time_ms(call, 5 if big else 50),
                    "plain_ms": time_ms(plain, 1 if big else 3),
                    "library_ms": time_ms(library, 1 if big else 5)})
        emit(rec)
        out[which][label] = {k: rec[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_unit",
            "splits", "rel_err", "max_abs_err")}
        if not rel <= tol:
            bad.append((which, label, rel))

    for label, n, m, d, s in RING_TILE_SHAPES:
        u, w, _, v = inputs(n, m, d, s)
        check("fwd", label, lambda: tiled.kernel_mvm_cuda(u, w, v, "matern32"),
              lambda: tiled.kernel_mvm_plain(u, w, v, "matern32"),
              lambda: reg.kappa_from_r2(torch.cdist(u, w) ** 2) @ v,
              {"n": n, "m": m, "d": d, "s": s,
               "splits": tiled.split_plan(n, m, s, sms), **bound(n, m, d, s)},
              TOL_VS_PLAIN)
        del u, w, v

    def bwd_library(a, b, c, e):
        dt = (c @ e.T) * reg.dkappa_dr2(torch.cdist(a, b) ** 2)
        return 2.0 * (dt.sum(1, keepdim=True) * a - dt @ b)

    for label, n, m, d, s in RING_BWD_SHAPES:
        u, w, g, v = inputs(n, m, d, s)
        splits = tiled.bwd_split_plan(n, m, sms)
        # du of a tile K(x_loc, x_rot): u, w, g, v read once, du written
        check("bwd", label,
              lambda: tiled.kernel_mvm_bwd_cuda(u, w, g, v, "matern32"),
              lambda: tiled.kernel_mvm_bwd_plain(u, w, g, v, "matern32"),
              lambda: bwd_library(u, w, g, v),
              {"n": n, "m": m, "d": d, "s": s, "splits": splits,
               "launches_per_call": len(tiled.bwd_s_chunks(d, s)),
               **bound_bwd(n, m, d, s, 4 * (2 * n * d + m * d + n * s
                                            + m * s))},
              TOL_BWD_VS_PLAIN)
        # the own tile K(x_loc, x_loc): one call on (u, u, [g | v], [v | g])
        v = v[:n]
        gv, vg = torch.cat([g, v], dim=1), torch.cat([v, g], dim=1)
        check("bwd", f"{label}_fused",
              lambda: tiled.kernel_mvm_bwd_fused_cuda(u, g, v, "matern32"),
              lambda: tiled.kernel_mvm_bwd_plain(u, u, gv, vg, "matern32"),
              lambda: bwd_library(u, u, gv, vg),
              {"n": n, "m": n, "d": d, "s": 2 * s,
               "splits": tiled.bwd_split_plan(n, n, sms),
               "launches_per_call": len(tiled.bwd_s_chunks(d, s, fused=True)),
               **bound_bwd(n, n, d, 2 * s, 4 * (2 * n * d + 2 * n * s))},
              TOL_BWD_VS_PLAIN)
        del u, w, g, v, gv, vg
    if bad:
        raise AssertionError(f"ring tiles vs plain: {bad}")
    return out


def _gp_steps(torch, tiled, mesh, x, y, rff, w_eps, params, steps, epochs,
              probes) -> dict:
    """``steps`` distributed outer steps from a fresh state on ``mesh``,
    counted together; seconds per step, res_z, peak memory."""
    from repro_torch.distributed.gp_step import GPStepState, make_gp_outer_step
    from repro_torch.distributed.sharding import shard_rows
    from repro_torch.train.adam import adam_init

    dev = x.device
    step = make_gp_outer_step(mesh, probes, solver_epochs=epochs)
    state = GPStepState(params, adam_init(params), shard_rows(
        torch.zeros((x.shape[0], 1 + probes), device=dev), mesh),
        torch.zeros((), device=dev), torch.zeros((), device=dev))
    xs, ys, ws = (shard_rows(t, mesh) for t in (x, y, w_eps))
    step_s, res_z, mu = [], [], []

    def run():
        nonlocal state
        for _ in range(steps):
            t0 = time.perf_counter()
            state = step(state, xs, ys, rff, ws)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            res_z.append(float(state.res_z))
            mu.append(torch.cat([m.reshape(-1) for m in state.adam.mu.leaves])
                      .cpu())
        return state

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        _, _, counts = _counted(torch, tiled, run)
        peak = torch.cuda.max_memory_allocated() / 2**20
    else:
        run()
        counts, peak = None, None
    return {"state": state, "step_s": step_s, "res_z": res_z, "mu": mu,
            "res_y": float(state.res_y), "counts": counts,
            "peak_mib": peak, "hypers": state.params.flat().cpu()}


def _moments_agree(got: list, want: list) -> tuple:
    """The Adam first moments of two runs, step by step, per component:
    |got - want| <= TOL_MU_ATOL * max|want| + TOL_MU_RTOL * |want|.
    Returns (all agree, per step the largest gap over its allowance)."""
    gaps = []
    for a, b in zip(got, want):
        allow = TOL_MU_ATOL * b.abs().max() + TOL_MU_RTOL * b.abs()
        gaps.append(float(((a - b).abs() / allow).max()))
    return all(g <= 1.0 for g in gaps), gaps


def _expected_step_launches(tiled, positions, steps, epochs, d, cols) -> dict:
    """Per distributed step: (epochs + 2) ring sweeps of P^2 forward tiles;
    the gradient's backward once per position for its own tile (the fused
    call, per column chunk) and twice per other tile (du, dw)."""
    fused = len(tiled.bwd_s_chunks(d, cols, fused=True))
    plain = len(tiled.bwd_s_chunks(d, cols))
    return {tiled.KERNEL_NAME: steps * (epochs + 2) * positions ** 2,
            tiled.BWD_KERNEL_NAME: steps * (positions * fused + 2 * positions
                                            * (positions - 1) * plain)}


def _check_counts(label, counts, expected, problems) -> None:
    for k, want in expected.items():
        if counts[0][k] != want:
            problems.append(f"{label}: {k} launches {counts[0][k]} != {want}")


def phase_distributed(torch, tiled, registry) -> tuple:
    """(a) the ring at full pol over 10 virtual shards against the
    one-launch MVM, all four kernels; (b) 3 distributed GP steps at pol on
    that mesh against a (1, 1) mesh, then small card vs CPU; (c)
    distributed AP at pol; (d) full 3droad over 8 shards: one ring MVM and
    one 3-epoch step; (e) lane-sharded fit_batch and ``--shard-lanes``;
    then both kernels at the path's tile shapes against their plain
    versions. Each counted run has its launch counts set to 0 just before
    and read just after. Returns those counts, the forward kernel's
    records and the backward kernel's tile records."""
    import numpy as np

    from repro_torch.data.synthetic import load_dataset, pad_to_block_multiple
    from repro_torch.distributed.ap import distributed_ap_sweeps
    from repro_torch.distributed.ring import global_col_norms
    from repro_torch.gp.hyperparams import HyperParams
    from repro_torch.gp.rff import init_rff
    from repro_torch.kernels.ops import h_mvm
    from repro_torch.launch.mesh import make_mesh

    path, problems = [], []
    cards = torch.cuda.device_count()
    gen = torch.Generator(device="cuda").manual_seed(12)
    pol = load_dataset("pol", max_n=0, device="cuda")
    x, y = pol.x_train, pol.y_train
    n, d = x.shape
    probes = 64
    mesh = _virtual_mesh(torch, *DIST_POL_MESH)
    P = mesh.size
    emit({"phase": "distributed", "cards": cards, "mesh": mesh.shape,
          "positions": P, "n_train": n, "rows_per_shard": n // P})

    # (a) the ring MVM at the CG shape
    v = torch.randn((n, probes + 1), generator=gen, device="cuda")
    ring_recs = []
    for kind in ("rbf", "matern12", "matern32", "matern52"):
        params = HyperParams.create(d, lengthscale=4.0, noise=0.5,
                                    kernel=kind, device="cuda")
        rec, counts = _ring_vs_one(torch, tiled, x, v, params, mesh, kind)
        path.append(counts)
        ring_recs.append(rec)
        emit({"phase": "distributed", "run": "a_ring_pol", **rec})
        _check_counts(f"ring {kind}", counts, {tiled.KERNEL_NAME: P * P,
                                               tiled.BWD_KERNEL_NAME: 0},
                      problems)
        if not rec["rel_err_vs_one_launch"] <= TOL_RING_VS_ONE:
            problems.append(f"ring {kind} vs one launch: "
                            f"{rec['rel_err_vs_one_launch']}")
    if cards > 1:
        real = make_mesh((cards,), ("data",))
        rows = n - n % cards
        params = HyperParams.create(d, lengthscale=4.0, noise=0.5,
                                    device="cuda")
        rec, counts = _ring_vs_one(torch, tiled, x[:rows], v[:rows], params,
                                   real, "matern32")
        path.append(counts)
        emit({"phase": "distributed", "run": "a_ring_real_cards", **rec})
        if not rec["rel_err_vs_one_launch"] <= TOL_RING_VS_ONE:
            problems.append(f"ring over {cards} cards: "
                            f"{rec['rel_err_vs_one_launch']}")

    # (b) distributed GP steps, 10 epochs, P = 10 against P = 1
    rff = init_rff(gen, 1000, d, probes, kind="matern32", device="cuda")
    w_eps = torch.randn((n, probes), generator=gen, device="cuda")
    runs = {}
    for label, m in (("p10", mesh), ("p1", _virtual_mesh(
            torch, (1, 1), ("data", "model")))):
        params = HyperParams.create(d, lengthscale=4.0, device="cuda")
        runs[label] = _gp_steps(torch, tiled, m, x, y, rff, w_eps, params,
                                DIST_STEPS, DIST_EPOCHS, probes)
        path.append(runs[label]["counts"])
        expected = _expected_step_launches(tiled, m.size, DIST_STEPS,
                                           DIST_EPOCHS, d, probes + 1)
        _check_counts(f"gp_step {label}", runs[label]["counts"], expected,
                      problems)
        r = runs[label]
        emit({"phase": "distributed", "run": f"b_gp_step_pol_{label}",
              "positions": m.size, "epochs": DIST_EPOCHS,
              "step_s": r["step_s"], "res_z": r["res_z"], "res_y": r["res_y"],
              "peak_mib": r["peak_mib"], "launches": r["counts"][0],
              "expected_launches": expected,
              "hypers": r["hypers"].tolist()})
    h10, h1 = runs["p10"]["hypers"], runs["p1"]["hypers"]
    err = float((h10 - h1).abs().max() / h1.abs().max())
    mu_ok, mu_gap = _moments_agree(runs["p10"]["mu"], runs["p1"]["mu"])
    emit({"phase": "distributed", "run": "b_p10_vs_p1", "hypers_rel_err": err,
          "tol_rel": TOL_TRAIN_VS_CPU, "adam_mu_gap": mu_gap,
          "mu_atol_of_largest": TOL_MU_ATOL, "mu_rtol": TOL_MU_RTOL,
          "adam_mu_ok": mu_ok})
    if not err <= TOL_TRAIN_VS_CPU:
        problems.append(f"gp_step P=10 vs P=1 hypers {err}")
    if not mu_ok:
        problems.append(f"gp_step P=10 vs P=1 Adam moments {mu_gap}")
    for label, r in runs.items():
        if not r["res_z"][-1] < r["res_z"][0]:
            problems.append(f"gp_step {label}: res_z {r['res_z']} not falling")
    small = {}
    for dev in ("cpu", "cuda"):
        ds = load_dataset("pol", max_n=667, device=dev)
        g = torch.Generator().manual_seed(5)
        rff_s = init_rff(g, 256, d, 16, kind="matern32")
        w_s = torch.randn((ds.x_train.shape[0], 16), generator=g)
        m = (_virtual_mesh(torch, *DIST_POL_MESH) if dev == "cuda" else
             make_mesh(*DIST_POL_MESH, devices=["cpu"] * P))
        small[dev] = _gp_steps(
            torch, tiled, m, ds.x_train, ds.y_train,
            rff_s._replace(z=rff_s.z.to(dev), u=rff_s.u.to(dev),
                           w=rff_s.w.to(dev)), w_s.to(dev),
            HyperParams.create(d, lengthscale=4.0, device=dev), DIST_STEPS,
            8, 16)
    # The moments per component and the hyperparameters at a limit from
    # sound runs: see TOL_MU_ATOL.
    mu_ok, mu_gap = _moments_agree(small["cuda"]["mu"], small["cpu"]["mu"])
    h_err = float((small["cuda"]["hypers"] - small["cpu"]["hypers"]).abs()
                  .max() / small["cpu"]["hypers"].abs().max())
    vc, vp = (small[k]["state"].carry_v.gather("cpu") for k in ("cuda", "cpu"))
    emit({"phase": "distributed", "run": "b_small_card_vs_cpu",
          "n_train": int(ds.x_train.shape[0]), "adam_mu_gap": mu_gap,
          "mu_atol_of_largest": TOL_MU_ATOL, "mu_rtol": TOL_MU_RTOL,
          "adam_mu_ok": mu_ok, "hypers_rel_err": h_err,
          "tol_hypers_rel": TOL_HYPERS_SMALL_STEPS,
          "carry_v_rel_err": float((vc - vp).norm() / vp.norm())})
    if not mu_ok:
        problems.append(f"gp_step small card vs CPU: Adam moments {mu_gap}")
    if not h_err <= TOL_HYPERS_SMALL_STEPS:
        problems.append(f"gp_step small card vs CPU: hypers {h_err}")

    # (c) distributed AP at pol: [y | 64 probes], 20 iterations, then 20 warm
    params = HyperParams.create(d, lengthscale=4.0, noise=0.5, device="cuda")
    rhs = torch.cat([y[:, None], torch.randn((n, probes), generator=gen,
                                             device="cuda")], dim=1)
    iters = DIST_AP["num_iters"]
    (v1, r1), s1, c1 = _counted(torch, tiled, lambda: distributed_ap_sweeps(
        x, rhs, torch.zeros_like(rhs), params, mesh, **DIST_AP))
    (v2, r2), s2, c2 = _counted(torch, tiled, lambda: distributed_ap_sweeps(
        x, rhs, v1, params, mesh, **DIST_AP))
    path += [c1, c2]
    for label, c in (("cold", c1), ("warm", c2)):
        _check_counts(f"ap {label}", c, {tiled.KERNEL_NAME: P * P * (1 + iters),
                                         tiled.BWD_KERNEL_NAME: 0}, problems)
    r_true = rhs - h_mvm(x, v1.gather("cuda"), params)
    track = (r1.gather("cuda") - r_true).abs()
    track_ok = bool(torch.all(track <= 1e-3 + 1e-3 * r_true.abs()))

    def relres(r):
        return float((global_col_norms(r) / rhs.norm(dim=0)).max())

    rel1, rel2 = relres(r1), relres(r2)
    emit({"phase": "distributed", "run": "c_ap_pol", "positions": P,
          **DIST_AP, "cold_s": s1, "warm_s": s2, "launches_cold": c1[0],
          "launches_warm": c2[0], "relres_cold": rel1, "relres_warm": rel2,
          "tracked_vs_true_max_abs": track.max().item(),
          "tracked_ok": track_ok})
    if not track_ok:
        problems.append(f"ap tracked residual vs true {track.max().item()}")
    if not rel2 < rel1 < 1.0:
        problems.append(f"ap relative residual {rel1} -> {rel2}")

    # (d) full 3droad over 8 shards: one ring MVM, one 3-epoch step
    road = load_dataset("3droad", max_n=0, device="cuda")
    xr, yr, n_real = pad_to_block_multiple(road.x_train, road.y_train, 1000)
    mesh3 = _virtual_mesh(torch, *DIST_3DROAD_MESH)
    vr = torch.randn((xr.shape[0], probes + 1), generator=gen, device="cuda")
    params = HyperParams.create(xr.shape[1], device="cuda")
    rec, counts = _ring_vs_one(torch, tiled, xr, vr, params, mesh3,
                               "matern32", timed=False)
    path.append(counts)
    _check_counts("ring 3droad", counts, {tiled.KERNEL_NAME: mesh3.size ** 2,
                                          tiled.BWD_KERNEL_NAME: 0}, problems)
    if not rec["rel_err_vs_one_launch"] <= TOL_RING_VS_ONE:
        problems.append(f"ring 3droad vs one launch: "
                        f"{rec['rel_err_vs_one_launch']}")
    del vr
    rff3 = init_rff(gen, 1000, xr.shape[1], probes, kind="matern32",
                    device="cuda")
    w3 = torch.randn((xr.shape[0], probes), generator=gen, device="cuda")
    big = _gp_steps(torch, tiled, mesh3, xr, yr, rff3, w3, params, 1, 3,
                    probes)
    path.append(big["counts"])
    expected = _expected_step_launches(tiled, mesh3.size, 1, 3, xr.shape[1],
                                       probes + 1)
    _check_counts("gp_step 3droad", big["counts"], expected, problems)
    emit({"phase": "distributed", "run": "d_3droad", "n_train": n_real,
          "n_padded": int(xr.shape[0]), "mesh": mesh3.shape, **rec,
          "step_s": big["step_s"], "step_res_z": big["res_z"],
          "step_peak_mib": big["peak_mib"], "step_launches": big["counts"][0],
          "step_expected_launches": expected})
    if not np.isfinite(big["res_z"]).all():
        problems.append(f"gp_step 3droad res_z {big['res_z']}")
    del road, xr, yr, w3

    # (e) lanes sharded over a lane mesh
    path_e, found = _sharded_lanes(torch, tiled, x, y)
    path += path_e
    problems += found
    try:
        tiles = _ring_tiles(torch, tiled, registry)
    except AssertionError as e:
        problems.append(str(e))
    if problems:
        raise AssertionError("; ".join(problems))
    return path, {"ring_pol": ring_recs, "tiles": tiles["fwd"]}, tiles["bwd"]


def _lanes_bitwise(torch, got, want) -> bool:
    """Two lists of lane results are bitwise equal: every state tensor and
    the iteration, residual and hyperparameter histories."""
    import numpy as np

    from repro_torch import lanes as lanes_mod

    def leaves(tree):
        out = []
        lanes_mod.tree_map(out.append, tree)
        return out

    for a, b in zip(got, want, strict=True):
        if not all(torch.equal(p, q) for p, q in
                   zip(leaves(a.state), leaves(b.state), strict=True)):
            return False
        if not all(np.array_equal(a.history[k], b.history[k])
                   for k in ("iters", "res_y", "res_z", "hypers")):
            return False
    return True


def _device_busy(torch, fn) -> dict:
    """``fn()`` under ``torch.profiler``: its wall seconds, the seconds in
    which at least one kernel ran on the card (the union of the kernels'
    intervals: kernels of two streams that overlap count once), the
    kernels' summed seconds and the card's idle share."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    union, start, end = 0.0, None, None
    for a, b in spans:
        if end is None or a > end:
            union += 0.0 if end is None else end - start
            start, end = a, b
        else:
            end = max(end, b)
    union += 0.0 if end is None else end - start
    if not spans:
        return {"wall_s": wall, "device_busy_s": "not measured"}
    return {"wall_s": wall, "device_busy_s": union / 1e6,
            "device_kernel_sum_s": sum(b - a for a, b in spans) / 1e6,
            "device_idle_share": 1.0 - union / 1e6 / wall}


def _sharded_lanes(torch, tiled, x, y) -> tuple:
    """fit_batch over ``DIST_LANE_DEVICES`` virtual cuda:0 lane positions,
    4 CG lanes at full pol (Matérn-3/2 x 2 seeds x tolerances 0.01 / 0.05,
    phase 8 (f)'s config), whose groups run at once (a thread and a stream
    each): counted once, then timed beside the unsharded fit_batch and the
    groups run alone in turn (``fit_batch`` over a group's lanes, no mesh),
    each warmed up once, then timed in the order ABC CBA and profiled once
    each (the card's busy seconds); every concurrent run must be bitwise
    the groups alone, and near the unsharded run. Then the batch CLI with
    ``--shard-lanes`` over the cards it finds."""
    import numpy as np

    from repro_torch import lanes as lanes_mod
    from repro_torch.core.driver import fit_batch
    from repro_torch.launch import batch
    from repro_torch.launch.mesh import make_lane_mesh
    from repro_torch.solvers import stack_numerics

    problems = []
    args = _batch_args(dataset="pol", max_n=0, kernels="matern32", seeds=2,
                       tolerances="0.01,0.05", steps=10, device="cuda",
                       shard_lanes=True, out=str(BATCH_SHARD_OUT))
    cells = batch.make_cells(batch.sweep_archs(["matern32"], args.smoke),
                             list(range(args.seeds)), args)
    (cfg, members), = batch.group_cells(cells, args).items()
    nums = stack_numerics([batch.cell_numerics(c, args) for c in members])
    seeds = [c.seed for c in members]
    mesh = make_lane_mesh(devices=[torch.device("cuda", 0)] * DIST_LANE_DEVICES)
    per = len(members) // DIST_LANE_DEVICES

    def concurrent():
        return fit_batch(x, y, cfg, seeds, numerics=nums, mesh=mesh)

    def unsharded():
        return fit_batch(x, y, cfg, seeds, numerics=nums)

    def alone():
        out = []
        for g in range(DIST_LANE_DEVICES):
            sl = slice(g * per, (g + 1) * per)
            out += fit_batch(x, y, cfg, seeds[sl],
                             numerics=lanes_mod.tree_map(lambda t: t[sl], nums))
        return out

    plain, alone_lanes = unsharded(), alone()
    sharded, seconds, counts = _counted(torch, tiled, concurrent)
    expected = dict.fromkeys(tiled.LAUNCHES, 0)
    for g in range(DIST_LANE_DEVICES):
        part = expected_lane_launches(tiled, cfg, sharded[g * per:(g + 1) * per],
                                      x.shape[1])
        for k in expected:
            expected[k] += part[k]
    _check_counts("sharded lanes", counts, expected, problems)
    runs = {"unsharded": unsharded, "groups_alone_in_turn": alone,
            "concurrent": concurrent}

    def counters():
        """What can stall a run besides its own work: the allocator's
        device allocations and retries, the collector's passes."""
        mem = torch.cuda.memory_stats()
        return [mem.get("num_device_alloc", 0), mem.get("num_alloc_retries", 0),
                *(g["collections"] for g in gc.get_stats())]

    times = {name: [] for name in runs}
    stalls = {name: [] for name in runs}
    bitwise = [_lanes_bitwise(torch, sharded, alone_lanes)]
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            before = counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = runs[name]()
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            stalls[name].append(dict(zip(
                ("device_allocs", "alloc_retries", "gc_gen0", "gc_gen1",
                 "gc_gen2"), (b - a for a, b in zip(before, counters())))))
            if name == "concurrent":
                bitwise.append(_lanes_bitwise(torch, out, alone_lanes))
    if not all(bitwise):
        problems.append(f"sharded lanes not bitwise the groups alone: {bitwise}")
    profiled = {name: _device_busy(torch, fn) for name, fn in runs.items()}
    lanes = []
    for c, a, b in zip(members, plain, sharded):
        differ = int(np.sum(a.history["iters"] != b.history["iters"]))
        err = float(np.abs(a.history["hypers"] - b.history["hypers"]).max()
                    / np.abs(a.history["hypers"]).max())
        lanes.append({"seed": c.seed, "tag": c.tag, "steps_iters_differ":
                      differ, "hypers_rel_err": err,
                      "iters": b.history["iters"].tolist()})
        if differ or not err <= TOL_LANE_VS_SINGLE:
            problems.append(f"sharded lane s{c.seed}{c.tag}: {differ} steps "
                            f"differ, hypers {err}")
    mean = {name: sum(t) / len(t) for name, t in times.items()}
    emit({"phase": "distributed", "run": "e_sharded_lanes",
          "lane_devices": DIST_LANE_DEVICES, "lanes": len(members),
          "counted_concurrent_s": seconds, "times_s": times,
          "mean_s": mean, "timed_order": "ABC CBA", "card": nvidia_smi(),
          "stalls": stalls, "threads": threading.active_count(),
          "profiled": profiled,
          "concurrent_vs_alone": mean["concurrent"]
          / mean["groups_alone_in_turn"],
          "concurrent_vs_unsharded": mean["concurrent"] / mean["unsharded"],
          "bitwise_groups_alone": bitwise,
          "launches": counts[0], "expected_launches": expected,
          "lanes_vs_unsharded": lanes})
    shutil.rmtree(args.out, ignore_errors=True)
    args.steps = 3
    cli, cli_s, cli_counts = _counted(
        torch, tiled, lambda: batch.main(_argv(args)))
    status = json.loads((Path(args.out) / "_sweep_status.json").read_text())
    emit({"phase": "distributed", "run": "e_batch_shard_lanes",
          "argv": _argv(args), "rc": cli, "seconds": cli_s,
          "launches": cli_counts[0], "status": status})
    cards = torch.cuda.device_count()
    sharded = int(len(members) % cards == 0)
    if cli != 0 or status["sharded_groups"] != sharded or \
            status["shard_devices"] != cards * sharded:
        problems.append(f"batch --shard-lanes: rc {cli}, status {status}")
    return [counts, cli_counts], problems


# --------------------------------------------------------------------------
# Phase 13: the LM substrate's models and training step
# --------------------------------------------------------------------------
LM_SEQ = 4096  # train_4k's sequence
LM_ROWS = 2  # of train_4k's global batch of 256
LM_STEPS = 3
LM_FULL_RUNS = (
    # (label, arch, layers kept or None for all, microbatches)
    ("a_llama3_8b", "llama3-8b", 2, 2),
    ("b_mamba2_780m", "mamba2-780m", None, 1),
)
# At random init the logits are about N(0, s2) with s2 the mean squared
# norm of the head's columns (the final norm gives unit RMS), so the first
# loss is near ln(padded vocab) + s2 / 2: 12.26 for llama3-8b's untied head
# (s2 = 1), 11.14 for mamba2-780m's tied 0.02-scale embedding (s2 = 0.61).
LM_LOSS0_WINDOW = 0.5
# Card against CPU, 3 SMOKE steps from the same params and batches. fp32
# (allow_tf32 off): each loss within 1e-5 relative, every parameter within
# lr and all but 0.5 % of a model's within 1e-6. Adam moves an element by
# up to about lr a step whatever its gradient's size, and where the first
# moment is a near-cancellation of successive gradients (or the gradient is
# at rounding level) the step's sign and size follow the rounding: such an
# element may part by up to one step's movement (the CPU tests against the
# reference hold lr / 3; on an H100 80GB HBM3 one jamba element parts from
# the CPU's by 0.36 lr). bf16: each loss within 5e-3, every parameter within
# 6 lr (three opposite steps), at most 10 % beyond 1e-4 (the CPU tests' bf16
# bounds).
LM_LR = 3e-4
TOL_LM = {"float32": dict(loss=1e-5, tight=1e-6, loose=LM_LR, share=5e-3),
          "bfloat16": dict(loss=5e-3, tight=1e-4, loose=6 * LM_LR,
                           share=0.1)}


def _lm_full_run(torch, label, arch, layers, microbatches, smi,
                 device="cuda") -> dict:
    """``LM_STEPS`` train steps of ``arch`` at its published widths on
    ``LM_ROWS`` x ``LM_SEQ`` synthetic tokens on the card: per step the
    loss, seconds after a synchronise, tokens/s, peak device memory and the
    model FLOP/s (6 N_active D) against the card's bf16 peak."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import PEAK_BF16_FLOPS
    from repro_torch.launch.train import lm_train_batch
    from repro_torch.models import init_params, make_train_step
    from repro_torch.train.adam import adam_init, tree_leaves

    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          num_layers=layers)
    reduced = {"global_batch": [256, LM_ROWS]}
    if layers is not None:
        reduced = {"num_layers": [full.num_layers, layers], **reduced}
    emit({"phase": "lm", "run": label, "arch": arch, "reduced": reduced,
          "d_model": cfg.d_model, "num_layers": cfg.num_layers,
          "vocab": cfg.padded_vocab, "seq_len": LM_SEQ, "rows": LM_ROWS,
          "num_microbatches": microbatches, "compute_dtype": cfg.compute_dtype,
          "remat": cfg.remat})
    torch.cuda.empty_cache()  # what earlier phases left cached
    gen = torch.Generator(device=device).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(gen, cfg)
    opt = adam_init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    head = params.get("lm_head", params["embed"].T)
    s2 = float((head.double() ** 2).sum(0).mean())
    expected0 = math.log(cfg.padded_vocab) + s2 / 2
    step = make_train_step(cfg, num_microbatches=microbatches)
    n_active = cfg.active_params_per_token_layers()
    tokens = LM_ROWS * LM_SEQ
    steps = []
    for i in range(LM_STEPS):
        batch = lm_train_batch(cfg, gen, LM_ROWS, LM_SEQ, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch)
        loss = float(loss)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        flops = 6 * n_active * tokens / sec
        rec = {"phase": "lm", "run": label, "step": i, "loss": loss,
               "step_s": sec, "tokens_per_s": tokens / sec,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "model_flops_per_s": flops,
               "model_flops_share": flops / PEAK_BF16_FLOPS}
        steps.append(rec)
        emit(rec)
    batch = lm_train_batch(cfg, gen, LM_ROWS, LM_SEQ, device)
    profile = _lm_profile_step(torch, lambda: step(params, opt, batch))
    emit({"phase": "lm", "run": label, "profiled_step": profile})
    leaves_finite = all(bool(torch.isfinite(v).all()) for v in
                        tree_leaves(params))
    loss0 = steps[0]["loss"]
    summary = {"phase": "lm", "run": label, "init_s": init_s,
               "n_active_params": n_active, "tokens_per_step": tokens,
               "loss0": loss0, "ln_vocab": math.log(cfg.padded_vocab),
               "head_col_sq_norm": s2, "expected_loss0": expected0,
               "loss0_window": LM_LOSS0_WINDOW,
               "params_finite": leaves_finite, "nvidia_smi": smi}
    summary["ok"] = bool(
        all(math.isfinite(r["loss"]) for r in steps) and leaves_finite
        and abs(loss0 - expected0) < LM_LOSS0_WINDOW)
    emit(summary)
    del params, opt, batch
    torch.cuda.empty_cache()
    return summary


def _lm_profile_step(torch, call) -> dict:
    """One more step, ``call()``, under ``torch.profiler`` (its result
    dropped): wall seconds, the device's busy share and the top kernels by
    device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall,
            "top_kernels": [{"name": e.key[:80], "calls": e.count,
                             "device_ms": e.self_device_time_total / 1e3}
                            for e in top]}


def _lm_card_vs_cpu(torch, arch: str, compute: str, card="cuda") -> dict:
    """``LM_STEPS`` SMOKE steps of ``arch`` on the card and on the CPU from
    the same params and batches (made once on the CPU from a fixed
    generator), at ``compute`` as the compute dtype."""
    import dataclasses

    from repro_torch.configs import SMOKE_SHAPES, get_config
    from repro_torch.launch.train import lm_train_batch
    from repro_torch.models import init_params, make_train_step
    from repro_torch.train.adam import adam_init, tree_leaves

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=compute)
    gen = torch.Generator().manual_seed(0)
    p0 = init_params(gen, cfg)
    shape = SMOKE_SHAPES["train_4k"]
    batches = [lm_train_batch(cfg, gen, shape.global_batch, shape.seq_len,
                              "cpu") for _ in range(LM_STEPS)]
    step = make_train_step(cfg)
    runs = {}
    for dev in (card, "cpu"):
        params = _lm_to(p0, dev)
        opt = adam_init(params)
        losses = []
        for b in batches:
            params, opt, loss = step(params, opt,
                                     {k: v.to(dev) for k, v in b.items()})
            losses.append(float(loss))
        runs[dev] = (losses, {name: [v.cpu().double() for v in
                                     tree_leaves(tree)]
                              for name, tree in (("p", params),
                                                 ("mu", opt.mu),
                                                 ("nu", opt.nu))})
    tol = TOL_LM[compute]
    (card_l, card_t), (cpu_l, cpu_t) = runs[card], runs["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
    errs = [(a - b).abs() for a, b in zip(card_t["p"], cpu_t["p"])]
    max_err = max(float(e.max()) for e in errs)
    beyond = sum(int((e > tol["tight"]).sum()) for e in errs)
    total = sum(e.numel() for e in errs)
    # The element that parted most, with both runs' moments after the
    # last step (leaves in tree_leaves order on both sides).
    leaf = max(range(len(errs)), key=lambda i: float(errs[i].max()))
    at = int(errs[leaf].argmax())
    worst = {"leaf": leaf, "index": at, "p0": float(
        tree_leaves(p0)[leaf].double().flatten()[at])}
    for side, t in (("card", card_t), ("cpu", cpu_t)):
        for name in ("p", "mu", "nu"):
            worst[f"{side}_{name}"] = float(t[name][leaf].flatten()[at])
    rec = {"phase": "lm", "run": "c_smoke_card_vs_cpu", "arch": arch,
           "compute_dtype": compute, "card_losses": card_l,
           "cpu_losses": cpu_l, "loss_rel_err": loss_rel,
           "param_max_abs_err": max_err, "params_beyond_tight": beyond,
           "params": total, "worst": worst, "tol": tol}
    rec["ok"] = bool(all(math.isfinite(v) for v in card_l)
                     and loss_rel <= tol["loss"] and max_err <= tol["loose"]
                     and beyond <= tol["share"] * total)
    emit(rec)
    return rec


def _lm_to(tree: dict, device) -> dict:
    """A copy of ``tree`` on ``device``, even where it already is there."""
    return {k: _lm_to(v, device) if isinstance(v, dict)
            else v.to(device, copy=True) for k, v in tree.items()}


def phase_lm(torch, tiled, smi: str) -> None:
    """Phase 13: the LM substrate on the card. (a) llama3-8b at its
    published widths cut to 2 of 32 layers, (b) mamba2-780m whole, each 3
    Adam steps at 2 x 4096 tokens (llama3 as 2 microbatches of one row);
    (c) every LM architecture's SMOKE config, card against CPU at fp32 and
    bf16; the train CLI's LM path once. The LM path reaches no kernel of
    the port: both kernels' launch counts stay 0."""
    from repro_torch.configs import LM_ARCHS
    from repro_torch.launch.train import main as train_main

    tiled.reset_launch_counts()
    bad = []
    for label, arch, layers, micro in LM_FULL_RUNS:
        rec = _lm_full_run(torch, label, arch, layers, micro, smi)
        if not rec["ok"]:
            bad.append(label)
    for arch in LM_ARCHS:
        for compute in ("float32", "bfloat16"):
            if not _lm_card_vs_cpu(torch, arch, compute)["ok"]:
                bad.append(f"c_{arch}_{compute}")
    cli = train_main(["--arch", "llama3-8b", "--steps", "2"])
    launches = tiled.launch_counts()
    rec = {"phase": "lm", "run": "d_cli", "argv": "--arch llama3-8b --steps 2",
           "losses": cli, "kernel_launches": launches}
    rec["ok"] = bool(len(cli) == 2 and all(math.isfinite(v) for v in cli)
                     and not any(launches.values()))
    emit(rec)
    if not rec["ok"]:
        bad.append("d_cli")
    if bad:
        raise AssertionError(f"LM checks failed: {bad}")


# --------------------------------------------------------------------------
# Phase 14: LM decoding
# --------------------------------------------------------------------------
DECODE_WARMUP = 2
DECODE_STEPS = 16
DECODE_RUNS = (
    # (label, arch, layers kept or None for all, shape, invariant rows x
    # tokens)
    ("a_llama3_8b", "llama3-8b", 2, "decode_32k", (2, 64)),
    ("b_mamba2_780m", "mamba2-780m", None, "decode_32k", (1, 512)),
    ("c_gemma3_4b", "gemma3-4b", 17, "long_500k", (1, 1040)),
)
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's published memory rate
# Decode against the port's own forward at full width, fp32 compute and
# cache (the reference's invariant bound, tests/test_archs_smoke.py).
TOL_DECODE_INVARIANT = 1e-3
# Card against CPU, the CPU tests' bounds (tests/test_torch_lm_decode.py):
# fp32, each device its own cache for 24 steps: logits within 1e-5 x
# max(1, max |cpu|), every cache leaf within 1e-5 x max(1, its max); bf16,
# each step from the CPU's cache: per (step, row) logits within 2^-4 x
# max |cpu|, bf16 cache leaves within 8 bf16 ulps of their largest value
# and the fp32 SSM state within 32, a MoE config's rows allowed beyond on
# 1/8 of (step, row) pairs (a router near-tie can pick another expert).
TOL_DECODE = {"logits": 1e-5, "cache": 1e-5, "bf16_logits": 2.0 ** -4,
              "bf16_ulps": 8, "bf16_state_ulps": 32, "moe_share": 1 / 8}
DECODE_SMOKE = dict(rows=2, max_len=32, steps=24, enc_len=16)


def _sync_dev(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _tree_bytes(torch, tree: dict) -> int:
    from repro_torch.train.adam import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _greedy(torch, serve, params, cfg, cache, toks, positions):
    """Greedy steps at ``positions``; tokens stay on the device."""
    for pos in positions:
        logits, cache = serve(params, cache, toks, pos)
        toks = torch.argmax(logits[:, : cfg.vocab_size], dim=-1).to(
            torch.int32)
    return toks


def _decode_invariant(torch, params, cfg, rows, tokens, device) -> float:
    """Max |decode logits - forward_lm logits| over ``tokens`` steps of
    ``rows`` random rows, fp32 compute and cache."""
    import dataclasses

    from repro_torch.models import forward_lm, init_cache, make_serve_step

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    gen = torch.Generator(device=device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (rows, tokens), generator=gen,
                         device=device)
    with torch.no_grad():
        ref = forward_lm(params, cfg32, toks)
    cache = init_cache(cfg32, rows, tokens, dtype=torch.float32,
                       device=device)
    serve = make_serve_step(cfg32)
    errs = []
    for t in range(tokens):
        logits, cache = serve(params, cache, toks[:, t], t)
        errs.append((logits - ref[:, t]).abs().max())
    return float(torch.stack(errs).max())


def _lm_decode_run(torch, label, cfg, shape, inv, smi, device="cuda",
                   reduced=None) -> dict:
    """Greedy decoding of ``cfg`` (random weights) at ``shape``'s rows and
    slots: ``DECODE_STEPS`` timed steps after ``DECODE_WARMUP``, the bound,
    a profiled step (on the card), then the fp32 invariant at ``inv``."""
    from repro_torch.models import init_cache, init_params, make_serve_step

    rows, slots = shape.global_batch, shape.seq_len
    emit({"phase": "lm_decode", "run": label, "arch": cfg.name,
          "reduced": reduced or {}, "shape": shape.name, "rows": rows,
          "slots": slots, "num_layers": cfg.num_layers,
          "d_model": cfg.d_model, "vocab": cfg.padded_vocab,
          "compute_dtype": cfg.compute_dtype, "cache_dtype": "bfloat16"})
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(gen, cfg)
    cache = init_cache(cfg, rows, slots, device=device)
    param_bytes = _tree_bytes(torch, params)
    cache_bytes = _tree_bytes(torch, cache)
    serve = make_serve_step(cfg)
    toks = torch.zeros((rows,), dtype=torch.int32, device=device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    toks = _greedy(torch, serve, params, cfg, cache, toks,
                   range(DECODE_WARMUP))
    _sync_dev(torch, device)
    t0 = time.perf_counter()
    toks = _greedy(torch, serve, params, cfg, cache, toks,
                   range(DECODE_WARMUP, DECODE_WARMUP + DECODE_STEPS))
    _sync_dev(torch, device)
    step_s = (time.perf_counter() - t0) / DECODE_STEPS
    bound_s = (param_bytes + cache_bytes) / HBM_BYTES_PER_S
    rec = {"phase": "lm_decode", "run": label, "step_s": step_s,
           "tokens_per_s": rows / step_s,
           "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2**30
                            if on_card else None),
           "param_bytes": param_bytes, "cache_bytes": cache_bytes,
           "bound_ms": bound_s * 1e3, "bound_tokens_per_s": rows / bound_s,
           "bound_share": bound_s / step_s,
           "tokens_in_vocab": bool(((toks >= 0)
                                    & (toks < cfg.vocab_size)).all()),
           "nvidia_smi": smi}
    if on_card:
        pos = DECODE_WARMUP + DECODE_STEPS
        rec["profiled_step"] = _lm_profile_step(
            torch, lambda: serve(params, cache, toks, pos))
    emit(rec)
    del cache
    if on_card:
        torch.cuda.empty_cache()
    err = _decode_invariant(torch, params, cfg, inv[0], inv[1], device)
    inv_rec = {"phase": "lm_decode", "run": label, "invariant_rows": inv[0],
               "invariant_tokens": inv[1], "decode_vs_forward_max_abs": err,
               "tol": TOL_DECODE_INVARIANT}
    inv_rec["ok"] = bool(rec["tokens_in_vocab"] and math.isfinite(err)
                         and err <= TOL_DECODE_INVARIANT)
    emit(inv_rec)
    del params
    if on_card:
        torch.cuda.empty_cache()
    return inv_rec


def _cache_rows_beyond(torch, got: dict, want: dict, rows: int, tol) -> tuple:
    """(per-row bool beyond the bound, worst value) of every cache leaf of
    ``got`` against ``want`` (both on the CPU): within ``tol["ulps"]`` bf16
    ulps of the leaf's largest value (``tol["state_ulps"]`` for an fp32
    leaf), or else ``tol["cache"]`` x max(1, leaf max); the worst as a
    share of the bound."""
    from repro_torch.train.adam import tree_leaves

    bad = torch.zeros(rows, dtype=torch.bool)
    worst = 0.0
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        top = float(a.abs().max())
        if "ulps" in tol:
            ulps = tol["ulps" if b.dtype == torch.bfloat16 else "state_ulps"]
            limit = ulps * 2.0 ** (
                math.floor(math.log2(max(top, 2.0 ** -126))) - 7)
        else:
            limit = tol["cache"] * max(1.0, top)
        diff = (a.double() - b.double()).abs().transpose(0, 1).reshape(
            rows, -1).amax(1)
        bad |= diff > limit
        worst = max(worst, float(diff.max()) / limit)
    return bad, worst


def _lm_decode_card_vs_cpu(torch, arch: str, compute: str,
                           card="cuda") -> dict:
    """``DECODE_SMOKE`` teacher-forced SMOKE steps of ``arch`` on the card
    and on the CPU from the same params (and whisper's frames), at
    ``compute`` with a cache of the same dtype; at bf16 every card step
    starts from the CPU's cache."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_params, make_serve_step
    from repro_torch.models.transformer import prefill_cross_cache

    sm = DECODE_SMOKE
    rows, steps = sm["rows"], sm["steps"]
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=compute)
    dtype = getattr(torch, compute)
    gen = torch.Generator().manual_seed(0)
    p0 = init_params(gen, cfg)
    toks = torch.randint(0, cfg.vocab_size, (steps, rows), generator=gen)
    enc = sm["enc_len"] if cfg.is_encdec else 0
    frames = torch.randn((rows, enc, cfg.d_model), generator=gen) * 0.3
    serve = make_serve_step(cfg)
    params, caches = {}, {}
    for side, dev in (("card", card), ("cpu", "cpu")):
        params[side] = _lm_to(p0, dev)
        caches[side] = init_cache(cfg, rows, sm["max_len"], enc_len=enc,
                                  dtype=dtype, device=dev)
        if enc:
            prefill_cross_cache(params[side], cfg, frames.to(dev),
                                caches[side])
    bf16 = compute == "bfloat16"
    tol = ({"ulps": TOL_DECODE["bf16_ulps"],
            "state_ulps": TOL_DECODE["bf16_state_ulps"]} if bf16
           else {"cache": TOL_DECODE["cache"]})
    beyond, worst_logit, worst_cache = 0, 0.0, 0.0
    finite = True
    for t in range(steps):
        if bf16:
            caches["card"] = _lm_to(caches["cpu"], card)
        want, _ = serve(params["cpu"], caches["cpu"], toks[t], t)
        got, _ = serve(params["card"], caches["card"], toks[t].to(card), t)
        got = got.cpu()
        finite &= bool(torch.isfinite(got).all())
        scale = (float(want.abs().max()) if bf16
                 else max(1.0, float(want.abs().max())))
        row_err = (got - want).abs().amax(-1) / scale
        bad_cache, w = _cache_rows_beyond(torch, _lm_to(caches["card"], "cpu"),
                                          caches["cpu"], rows, tol)
        limit = TOL_DECODE["bf16_logits" if bf16 else "logits"]
        bad = (row_err > limit) | bad_cache
        beyond += int(bad.sum())
        worst_logit = max(worst_logit, float(row_err.max()))
        worst_cache = max(worst_cache, w)
    allowed = (TOL_DECODE["moe_share"] * steps * rows
               if bf16 and cfg.moe is not None else 0)
    rec = {"phase": "lm_decode", "run": "d_smoke_card_vs_cpu", "arch": arch,
           "compute_dtype": compute, "steps": steps,
           "worst_logit_rel": worst_logit,
           "worst_cache": worst_cache,
           "worst_cache_unit": "share of the bound",
           "rows_beyond": beyond, "rows_allowed": allowed,
           "tol": TOL_DECODE}
    rec["ok"] = bool(finite and beyond <= allowed)
    emit(rec)
    return rec


def phase_lm_decode(torch, tiled, smi: str) -> None:
    """Phase 14: LM decoding on the card, (a)-(e) of the module docstring.
    The LM path reaches no kernel of the port: both kernels' launch counts,
    set to 0 before it, stay 0."""
    import dataclasses

    from repro_torch.configs import LM_ARCHS, get_config, runnable_cells
    from repro_torch.configs.shapes import LM_SHAPES
    from repro_torch.launch.serve import main as serve_main

    tiled.reset_launch_counts()
    bad = []
    cells = {(a, s): st for a, s, st in runnable_cells(include_skips=True)}
    for label, arch, layers, shape, inv in DECODE_RUNS:
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(
            full, num_layers=layers)
        reduced = ({} if layers is None
                   else {"num_layers": [full.num_layers, layers]})
        if cells.get((arch, shape)) != "run":
            bad.append(f"{label}: runnable_cells has {cells.get((arch, shape))}")
        if not _lm_decode_run(torch, label, cfg, LM_SHAPES[shape], inv, smi,
                              reduced=reduced)["ok"]:
            bad.append(label)
    for arch in LM_ARCHS:
        for compute in ("float32", "bfloat16"):
            if not _lm_decode_card_vs_cpu(torch, arch, compute)["ok"]:
                bad.append(f"d_{arch}_{compute}")
    argv = ["--arch", "llama3-8b", "--tokens", "8"]
    tokens = serve_main(argv)
    launches = tiled.launch_counts()
    rec = {"phase": "lm_decode", "run": "e_cli", "argv": " ".join(argv),
           "tokens": tokens.tolist(), "kernel_launches": launches}
    rec["ok"] = bool(tuple(tokens.shape) == (8, 4)
                     and not any(launches.values()))
    emit(rec)
    if not rec["ok"]:
        bad.append("e_cli")
    if bad:
        raise AssertionError(f"LM decode checks failed: {bad}")


# Phase 15: the dry-run accounting. The sweep's cells run as subprocesses
# of ``repro_torch.launch.sweep`` (one per core at once); the host-mesh
# runs at phase lm's and lm_decode's cuts; the GP step on 8 virtual shards.
DRYRUN_DIR = ROOT / "build" / "chip_smoke_dryrun"
DRYRUN_SINGLE_CELLS = 38
DRYRUN_MULTI_ARCH = "llama3-8b"
# The estimated peak against torch.cuda.max_memory_allocated, either way.
DRYRUN_PEAK_FACTOR = 2.0
# Estimated flops against FlopCounterMode of the real step, relative.
DRYRUN_FLOPS_RTOL = 1e-6
# The reference keeps Adam's step as a device int32; the port as a Python
# int: the accounting's argument bytes count those 4 bytes.
ADAM_STEP_BYTES = 4


def _dryrun_sweep() -> list:
    """(a): the sweep over every runnable cell on the single-pod mesh, then
    llama3-8b's cells on the two-pod mesh; one line per cell."""
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    problems = []
    for meshes, extra in (("single", []),
                          ("multi", ["--only-arch", DRYRUN_MULTI_ARCH])):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.sweep", "--out",
             str(DRYRUN_DIR), "--meshes", meshes, "--timeout", "300",
             *extra],
            capture_output=True, text=True, timeout=900,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        emit({"phase": "dryrun", "run": f"a_sweep_{meshes}", "rc":
              r.returncode, "seconds": time.perf_counter() - t0,
              "tail": r.stdout[-300:]})
        if r.returncode != 0:
            problems.append(f"sweep {meshes}: rc {r.returncode}: "
                            f"{r.stdout[-2000:]}")
    reports = sorted(p for p in DRYRUN_DIR.glob("*.json")
                     if not p.name.startswith("_"))
    counts = {"single": 0, "multi": 0}
    for path in reports:
        rep = json.loads(path.read_text())
        counts[rep["mesh"]] += 1
        emit({"phase": "dryrun", "run": "a_cell", "arch": rep["arch"],
              "shape": rep["shape"], "mesh": rep["mesh"],
              "chips": rep["chips"],
              "peak_gib_per_chip": rep["peak_bytes"] / 2**30,
              "argument_bytes": rep["argument_bytes"],
              "t_compute_s": rep["t_compute"], "t_memory_s": rep["t_memory"],
              "t_collective_s": rep["t_collective"],
              "bottleneck": rep["bottleneck"],
              "roofline_fraction": rep["roofline_fraction"]})
    from repro_torch.configs import runnable_cells

    want = {"single": DRYRUN_SINGLE_CELLS,
            "multi": sum(a == DRYRUN_MULTI_ARCH
                         for a, _, st in runnable_cells() if st == "run")}
    if counts != want:
        problems.append(f"sweep reports {counts} != {want}")
    return problems


def _real_bytes(torch, trees) -> int:
    """Bytes of every tensor in ``trees`` (nested dicts, lists, tensors)."""
    from torch.utils._pytree import tree_flatten

    return sum(t.numel() * t.element_size() for t in tree_flatten(trees)[0]
               if isinstance(t, torch.Tensor))


def _dryrun_host(torch, label, arch, shape, cfg, smi, device="cuda") -> dict:
    """(b): ``run_cell`` on ``make_host_mesh()``, then the real step on the
    card: argument bytes, peak memory and flops against the accounting."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.dryrun import _num_microbatches, run_cell
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import (concrete_batch, init_params,
                                    make_serve_step, make_train_step)
    from repro_torch.train.adam import adam_init

    t0 = time.perf_counter()
    rep = run_cell(arch, shape.name, "host", str(DRYRUN_DIR / "host"),
                   cfg=cfg, shape=shape, device=device)
    account_s = time.perf_counter() - t0
    on_card = device != "cpu"
    if on_card:
        torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(gen, cfg)
    inputs = concrete_batch(cfg, shape, gen)
    if shape.step == "train":
        step = make_train_step(cfg, num_microbatches=_num_microbatches(
            shape, make_host_mesh(device)))
        opt = adam_init(params)
        args = (params, opt, inputs["batch"])
        arg_bytes = _real_bytes(torch, (params, opt.mu, opt.nu,
                                        inputs["batch"])) + ADAM_STEP_BYTES
    else:
        step = make_serve_step(cfg)
        args = (params, inputs["cache"], inputs["tokens"], inputs["pos"])
        arg_bytes = _real_bytes(torch, args)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    with FlopCounterMode(display=False) as counter:
        out = step(*args)
    sync()
    del out
    real_flops = counter.get_total_flops()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = step(*args)
    sync()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else None
    del out, args, params, inputs
    if on_card:
        torch.cuda.empty_cache()
    rel = abs(rep["flops_per_chip"] - real_flops) / real_flops
    rec = {"phase": "dryrun", "run": label, "arch": arch, "shape": shape.name,
           "num_layers": cfg.num_layers, "account_s": account_s,
           "argument_bytes": rep["argument_bytes"],
           "real_argument_bytes": arg_bytes,
           "estimated_peak_bytes": rep["peak_bytes"],
           "estimated_temp_bytes": rep["temp_bytes"],
           "max_memory_allocated": peak,
           "peak_ratio": (rep["peak_bytes"] / peak) if peak else None,
           "estimated_flops": rep["flops_per_chip"], "real_flops": real_flops,
           "flops_rel_err": rel, "step_s": seconds,
           "t_compute_s": rep["t_compute"], "t_memory_s": rep["t_memory"],
           "t_collective_s": rep["t_collective"],
           "bottleneck": rep["bottleneck"],
           "roofline_fraction": rep["roofline_fraction"],
           "nvidia_smi": smi}
    rec["ok"] = bool(
        rep["argument_bytes"] == arg_bytes and rel <= DRYRUN_FLOPS_RTOL
        and (peak is None or 1 / DRYRUN_PEAK_FACTOR <= rec["peak_ratio"]
             <= DRYRUN_PEAK_FACTOR))
    emit(rec)
    return rec


def _dryrun_gp(torch, tiled, shape=None, device="cuda") -> tuple:
    """(c): ``lower_gp_outer_step`` at gp_392k (or ``shape``) on (2, 2, 2)
    virtual shards of the card (of the CPU: ``device="cpu"``, a dry run
    whose launches are not counted), the inputs drawn from a seed, one
    step counted."""
    from repro_torch.configs import GP_SHAPES
    from repro_torch.distributed.gp_step import GPStepState, lower_gp_outer_step
    from repro_torch.distributed.sharding import shard_rows
    from repro_torch.gp.hyperparams import HyperParams
    from repro_torch.gp.rff import init_rff
    from repro_torch.launch.analysis import analysis_gp_cell
    from repro_torch.train.adam import adam_init

    from repro_torch.launch.mesh import make_mesh

    shape = shape or GP_SHAPES["gp_392k"]
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), devices=[dev] * 8)
    low = lower_gp_outer_step(shape, mesh)
    _, pieces = analysis_gp_cell(shape.name, mesh, shape=shape)
    on_card = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(15)
    x_abs, y_abs, rff_abs, w_abs = low.inputs
    x = torch.randn(tuple(x_abs.shape), generator=gen, device=dev)
    y = torch.randn(tuple(y_abs.shape), generator=gen, device=dev)
    w_eps = torch.randn(tuple(w_abs.shape), generator=gen, device=dev)
    rff = init_rff(gen, rff_abs.z.shape[0], shape.d, shape.num_probes,
                   kind=rff_abs.kind, device=dev)
    params = HyperParams.create(shape.d, kernel=rff_abs.kind, device=dev)
    state = GPStepState(params, adam_init(params), shard_rows(
        torch.zeros(tuple(low.state.carry_v.shape), device=dev), mesh),
        torch.zeros((), device=dev), torch.zeros((), device=dev))
    xs, ys, ws = (shard_rows(t, mesh) for t in (x, y, w_eps))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        new, seconds, counts = _counted(
            torch, tiled, lambda: low.step(state, xs, ys, rff, ws))
    else:
        t0 = time.perf_counter()
        new = low.step(state, xs, ys, rff, ws)
        seconds, counts = time.perf_counter() - t0, (tiled.launch_counts(),)
    moved = mesh.moved_bytes
    expected = _expected_step_launches(tiled, mesh.size, 1,
                                       shape.solver_epochs, shape.d,
                                       1 + shape.num_probes)
    problems = []
    _check_counts("c_gp_392k", counts, expected, problems)
    res_z = float(new.res_z)
    mult = pieces["multipliers"]
    sweeps_comm = shape.solver_epochs + 4
    rec = {"phase": "dryrun", "run": "c_gp_392k_8_shards", "rows": shape.n,
           "d": shape.d, "probes": shape.num_probes,
           "epochs": shape.solver_epochs, "positions": mesh.size,
           "model_flops": low.model_flops, "notes": low.notes,
           "launches": counts[0], "expected_launches": expected,
           "res_z": res_z, "res_y": float(new.res_y), "step_s": seconds,
           "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2**30
                            if on_card else None),
           "rot_bytes_per_step": mult["rot_bytes_per_step"],
           "accounted_rotation_bytes_per_position":
               mult["rot_bytes_per_step"] * mesh.size * sweeps_comm,
           "moved_bytes_per_position": moved / mesh.size}
    rec["ok"] = bool(math.isfinite(res_z) and not problems)
    emit(rec)
    del state, new, xs, ys, ws, x, y, w_eps
    if on_card:
        torch.cuda.empty_cache()
    return rec, counts, problems


def phase_dryrun(torch, tiled, smi: str) -> list:
    """Phase 15: (a) the sweep, (b) the host mesh against the real steps,
    (c) the GP step from ``lower_gp_outer_step`` on 8 virtual shards.
    Returns (c)'s launch counts (the LM runs launch neither kernel)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import LM_SHAPES

    bad = _dryrun_sweep()
    llama = get_config("llama3-8b")
    cut = dataclasses.replace(llama, num_layers=2)
    train = dataclasses.replace(LM_SHAPES["train_4k"], global_batch=LM_ROWS,
                                microbatch_rows=1)
    emit({"phase": "dryrun", "run": "b_reduced", "reduced": {
        "b_train": {"num_layers": [32, 2], "global_batch": [256, LM_ROWS],
                    "microbatches": 2},
        "b_decode": {"num_layers": [32, 2]}}})
    tiled.reset_launch_counts()
    for label, shape in (("b_train", train),
                         ("b_decode", LM_SHAPES["decode_32k"])):
        if not _dryrun_host(torch, label, "llama3-8b", shape, cut, smi)["ok"]:
            bad.append(label)
    if any(tiled.launch_counts().values()):
        bad.append(f"LM runs launched kernels: {tiled.launch_counts()}")
    rec, counts, problems = _dryrun_gp(torch, tiled)
    bad.extend(problems)
    if not rec["ok"]:
        bad.append("c_gp_392k")
    if bad:
        raise AssertionError(f"dry-run checks failed: {bad}")
    return [counts]


def _kernel_entry(name, source, replaces, launches, measured,
                  **extra) -> dict:
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches}
    if measured is not None:
        entry.update({k: measured[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")})
        entry["rel_err"] = measured["rel_err"]
        entry.update({k: measured[k] for k in (
            "bound_unit", "bound_fp32_ms", "splits", "by_shape")
            if k in measured})
    entry.update(extra)
    return entry


def ptxas_spills(report: str) -> dict:
    """Bytes of spill stores per compiled kernel, from nvcc's -Xptxas -v
    report."""
    spills, current = {}, None
    for line in report.splitlines():
        if "Function properties for " in line:
            current = line.split("Function properties for ")[1].strip()
        elif current and "bytes spill stores" in line:
            spills[current] = int(line.split(" bytes spill stores")[0]
                                  .rsplit(",", 1)[1])
            current = None
    return spills


def main() -> int:
    t_start = time.perf_counter()
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
    spills = ptxas_spills(ptxas.read_text()) if ptxas.exists() else {}
    by_kernel = {name: {k: b for k, b in spills.items() if name in k}
                 for name in tiled.LAUNCHES}
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "library": str(lib),
          "registers_per_thread": regs, "instantiations": len(spills),
          "instantiations_without_spills": sum(b == 0 for b in spills.values()),
          "instantiations_by_kernel": {name: len(found) for name, found in
                                       by_kernel.items()},
          "instantiations_with_spills": sum(b > 0 for b in spills.values())})

    failures = []
    for name, found in by_kernel.items():
        if not found or any(found.values()):
            print(f"chip_smoke: {name} spills (or was not found in the ptxas "
                  f"report): {found}", file=sys.stderr, flush=True)
            failures.append("device")
    fwd_entry = bwd_entry = None
    path_launches = []
    phase_s = {"build": build_s}
    t_phase = time.perf_counter()
    lane_kernels = {}
    try:
        fwd_entry = phase_kernels(torch, tiled, registry)
        lane_kernels = phase_kernel_lanes(torch, tiled)
    except Exception:  # every phase runs; any failure fails the smoke
        traceback.print_exc()
        failures.append("kernels")
    phase_s["kernels"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    try:
        bwd_entry = phase_kernels_bwd(torch, tiled, registry)
        phase_grad(torch)
    except Exception:
        traceback.print_exc()
        failures.append("kernels_bwd")
    phase_s["kernels_bwd"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    try:
        phase_matern(torch, tiled, smi)
    except Exception:
        traceback.print_exc()
        failures.append("matern")
    phase_s["matern"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    serve_run = None
    try:
        _, launches, serve_run = phase_serve(torch, tiled)
        path_launches.append(launches)
    except Exception:
        traceback.print_exc()
        failures.append("serve")
    phase_s["serve"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    refresh_shapes = None
    try:
        if serve_run is None:
            raise RuntimeError("the refresh phase needs the serve phase's fit")
        launches, refresh_shapes = phase_refresh(torch, tiled, serve_run)
        path_launches.append(launches)
        path_launches.append(phase_bo(torch, tiled))
    except Exception:
        traceback.print_exc()
        failures.append("refresh")
    phase_s["refresh"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    try:
        if serve_run is None:
            raise RuntimeError("the http phase needs the serve phase's fit")
        path_launches.extend(phase_http(torch, tiled, serve_run,
                                        serve_run.engine.model))
    except Exception:
        traceback.print_exc()
        failures.append("http")
    phase_s["http"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    try:
        launches, fits = phase_train(torch, tiled)
        path_launches.append(launches)
        for label in ("a_pathwise_warm", "c_ap_pathwise_warm_budget10",
                      "d_sgd_pathwise_warm_budget10"):
            phase_profile(torch, label, *fits[label])
    except Exception:
        traceback.print_exc()
        failures.append("train")
    phase_s["train"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    try:
        launches, prof_args = phase_large(torch, tiled)
        path_launches.append(launches)
        phase_profile(torch, "e_3droad_warm", *prof_args)
    except Exception:
        traceback.print_exc()
        failures.append("large")
    phase_s["large"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    try:
        path_launches.append(phase_large_steps(torch, tiled))
        phase_rff_memory(torch)
    except Exception:
        traceback.print_exc()
        failures.append("large_steps")
    phase_s["large_steps"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    try:
        path_launches.extend(phase_lanes(torch, tiled))
    except Exception:
        traceback.print_exc()
        failures.append("lanes")
    phase_s["lanes"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    dist_recs = dist_bwd = {}
    try:
        launches, dist_recs, dist_bwd = phase_distributed(torch, tiled,
                                                          registry)
        path_launches.extend(launches)
    except Exception:
        traceback.print_exc()
        failures.append("distributed")
    phase_s["distributed"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    try:
        phase_lm(torch, tiled, smi)
    except Exception:
        traceback.print_exc()
        failures.append("lm")
    phase_s["lm"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    try:
        phase_lm_decode(torch, tiled, smi)
    except Exception:
        traceback.print_exc()
        failures.append("lm_decode")
    phase_s["lm_decode"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    try:
        path_launches.extend(phase_dryrun(torch, tiled, smi))
    except Exception:
        traceback.print_exc()
        failures.append("dryrun")
    phase_s["dryrun"] = time.perf_counter() - t_phase

    def total(name, which=0):
        return sum(counts[which][name] for counts in path_launches)

    entries = [
        _kernel_entry(tiled.KERNEL_NAME, "src/repro_torch/csrc/kernel_mvm.cu",
                      "src/repro/kernels/tiled.py:98",
                      total(tiled.KERNEL_NAME), fwd_entry,
                      second_pass_calls=total(tiled.KERNEL_NAME, 1),
                      lanes=lane_kernels.get(tiled.KERNEL_NAME),
                      refresh_shapes=refresh_shapes,
                      distributed=dist_recs),
        _kernel_entry(tiled.BWD_KERNEL_NAME,
                      "src/repro_torch/csrc/kernel_mvm_bwd.cu",
                      "src/repro/kernels/tiled.py:131",
                      total(tiled.BWD_KERNEL_NAME), bwd_entry,
                      second_pass_calls=total(tiled.BWD_KERNEL_NAME, 1),
                      lanes=lane_kernels.get(tiled.BWD_KERNEL_NAME),
                      distributed={"tiles": dist_bwd}),
    ]
    emit({"phase": "timing", "phase_s": phase_s,
          "wall_s": time.perf_counter() - t_start})
    if failures:
        fail(f"phases failed: {failures}", code=1)
    print(smi, flush=True)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
