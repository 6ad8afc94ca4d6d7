"""Trip-count composition of a dry-run cell's cost; port of
``repro.launch.analysis``.

The port has no compiler: "lower + compile" becomes a placement over the
port's :class:`~repro_torch.launch.mesh.Mesh` plus an estimate.

| reference (JAX) | port (PyTorch) | held to the reference |
| --- | --- | --- |
| ``jax.eval_shape``, ``ShapeDtypeStruct`` | tensors made under ``FakeTensorMode`` (``transformer.fake_mode()``; shape and dtype, no storage) | exact shapes and dtypes |
| ``NamedSharding(mesh, P(...))`` | a placement: the port's ``Mesh`` plus the per-dimension axis tuple from ``valid_spec`` (``sharding.NamedSharding``) | exact tuples, leaf by leaf |
| ``make_production_mesh``: 256 or 512 placeholder host devices | a ``Mesh`` of (16, 16) ("data", "model") or (2, 16, 16) ("pod", "data", "model") over ``meta`` placeholders; no device-count lock, so no ``REPRO_DRYRUN_DEVICES`` | mesh shape and axis names |
| ``memory_analysis`` argument and output bytes | Σ leaf bytes / Π axis sizes of its tuple over params, Adam state, batch, cache, tokens and pos; donated arguments alias their outputs | exact, per chip |
| ``memory_analysis`` temp bytes | the high-water mark of live fake-tensor bytes in the pieces' fake runs (plus, for train, the periods' retained activations and the fp32 gradient accumulator), over the positions activations split across (DP; TP where the mixers split over "model", by heads or by sequence) | an estimate |
| ``cost_analysis`` flops | ``torch.utils.flop_counter``'s formulas over the same pieces under fake tensors; products with a weight over DP x TP positions, batched products (attention, the SSD) over DP x TP where the attention policy splits them, else DP | stated tolerance |
| ``cost_analysis`` bytes accessed | each non-view op's inputs plus outputs in the same fake runs (unfused) | reported |
| ``parse_collectives`` over HLO text | a collective list derived from the policy (:func:`_block_collectives`, :func:`_outside_collectives`); no HLO text, so the reference's regex has no input | stated factor |
| ``RooflineReport.finalise`` with TPU v5e peaks | the same, with the H100's (``launch/mesh.py``) | the formula |

Pieces (the reference's names), composed per chip:

  train   total = M * (A + (P-1) * (B + R)) + C
            A = one-microbatch loss and gradient of the model cut to one
                period (``mb_grad``; the reference's scanned program,
                whose period body XLA counts once)
            B = one period forward + backward (``period_body``)
            R = that period's rematerialised forward when ``cfg.remat``
                (``remat_body``; the reference's B has no recompute, so
                its composition counts it in one period only)
            C = the Adam update (``optimizer``)
            (+ M * (L_enc-1) * (B_enc + R_enc) for whisper's encoder)
  prefill total = A + (P-1) * B_fwd          (+ encoder correction)
  decode  total = A + (P-1) * B_dec
  gp      tile composition (:func:`analysis_gp_cell`)

The decoder period of an encoder-decoder model runs with the encoder
output, so its cross-attention is in B (the reference passes no encoder
output to its B). Per-chip flops divide each op class by the positions
the policy splits it over; the router's small replicated product is
counted as split.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import GP_SHAPES, LM_SHAPES, get_config
from repro_torch.distributed.sharding import (DP, FSDP, TP, NamedSharding,
                                              axis_size, set_global_mesh,
                                              valid_spec)
from repro_torch.launch.hlo_analysis import (CollectiveStats, CostCounter,
                                             _nbytes, extract_cost)


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_counts: dict = dataclasses.field(default_factory=dict)

    def __add__(self, o):
        return Cost(
            self.flops + o.flops,
            self.bytes + o.bytes,
            self.coll_bytes + o.coll_bytes,
            {k: self.coll_counts.get(k, 0) + o.coll_counts.get(k, 0)
             for k in set(self.coll_counts) | set(o.coll_counts)},
        )

    def __mul__(self, k):
        return Cost(
            self.flops * k, self.bytes * k, self.coll_bytes * k,
            {key: v * k for key, v in self.coll_counts.items()},
        )

    __rmul__ = __mul__


# --------------------------------------------------------------------------
# Fake runs
# --------------------------------------------------------------------------
def _raw(cost: Cost, stats: CollectiveStats) -> dict:
    """The one-period program's numbers (the reference's scanned program,
    whose loop bodies XLA counts once)."""
    return {"flops": cost.flops, "bytes": cost.bytes,
            "coll_bytes": cost.coll_bytes, "coll_counts": cost.coll_counts,
            "by_op": dict(stats.by_op_bytes)}


class _Piece:
    """One fake run: its global counter, its per-chip Cost (collectives
    added by the caller) and the live bytes it retained at ``mark``."""

    def __init__(self, fn, divisors: dict):
        from repro_torch.models.transformer import fake_mode

        self.counter = CostCounter()
        self.retained = 0
        with fake_mode(), self.counter:
            fn(self)
        flops, byts = extract_cost(self.counter, divisors)
        self.cost = Cost(flops, byts)

    def mark(self) -> None:
        self.retained = self.counter.live

    @property
    def peak(self) -> int:
        return self.counter.peak

    def with_collectives(self, stats: CollectiveStats) -> Cost:
        return Cost(self.cost.flops, self.cost.bytes, stats.bytes_per_chip,
                    dict(stats.counts))


def _one_period(cfg):
    """``cfg`` cut to one pattern period (and one encoder layer)."""
    enc = (dataclasses.replace(cfg.encoder, num_layers=1)
           if cfg.is_encdec else cfg.encoder)
    return dataclasses.replace(cfg, num_layers=len(cfg.pattern), encoder=enc)


def _strip_lead(tree: dict) -> dict:
    """Every leaf without its leading (period) axis, as a fake tensor."""
    return {k: _strip_lead(v) if isinstance(v, dict)
            else torch.empty(tuple(v.shape[1:]), dtype=v.dtype)
            for k, v in tree.items()}


def _grad_leaves(tree: dict) -> tuple:
    from repro_torch.train.adam import tree_leaves, tree_unflatten

    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tree)]
    return tree_unflatten(tree, leaves), leaves


def _period_shardings(cfg, mesh, params_abs, serving=False):
    """Abstract single-period params + their placements (leading axis
    removed)."""
    from repro_torch.models import param_shardings
    from repro_torch.models.steps import _map_named
    from repro_torch.models.transformer import fake_mode

    with fake_mode():
        one = _strip_lead(params_abs["layers"])
    full_sh = param_shardings(cfg, mesh, params_abs, serving=serving)["layers"]
    one_sh = _map_named(lambda _, leaf, s: NamedSharding(mesh, s.spec[1:]),
                        one, full_sh)
    return one, one_sh


# --------------------------------------------------------------------------
# Division of work over positions
# --------------------------------------------------------------------------
def _dp_split(mesh, rows: int) -> int:
    """Positions the rows split across (DP axes that divide them)."""
    return axis_size(mesh, valid_spec(mesh, (rows,), (DP,))[0])


def _attention_split(cfg, tp: int, seq: int, decode: bool) -> str:
    """How the reference's layers split attention over "model":
    ``"heads"``, ``"sequence"`` (Q rows in train, KV slots in decode) or
    ``""`` (replicated), as ``models/layers.py`` chooses."""
    if tp == 1:
        return "heads"
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if (kv % tp == 0) if decode else (h % tp == 0 and kv % tp == 0):
        return "heads"
    return "sequence" if seq % tp == 0 else ""


def _ssm_split(cfg, tp: int) -> bool:
    return cfg.ssm.num_heads(cfg.d_model) % tp == 0


def _divisors(cfg, mesh, rows: int, seq: int, decode: bool) -> tuple:
    """(divisor per op class, divisor of activation memory)."""
    from repro_torch.models.config import MAMBA

    dp = _dp_split(mesh, rows)
    tp = axis_size(mesh, TP)
    kinds = {spec.kind for spec in cfg.pattern}
    split = all(_ssm_split(cfg, tp) if k == MAMBA
                else _attention_split(cfg, tp, seq, decode) for k in kinds)
    # activations split over "model" where the mixers do (heads, or Q
    # rows / KV slots under sequence parallelism)
    return ({"weight": dp * tp, "batched": dp * (tp if split else 1),
             "other": dp * tp}, dp * (tp if split else 1))


# --------------------------------------------------------------------------
# Collectives derived from the policy
# --------------------------------------------------------------------------
def _axis_in(sh: NamedSharding, axis: str) -> int:
    """Positions ``axis`` splits the leaf over (1 if not in its spec)."""
    for a in sh.spec:
        names = (a,) if isinstance(a, str) else (a or ())
        if axis in names:
            return sh.mesh.shape[axis]
    return 1


def _gathers(stats, leaves, shardings, uses: int) -> None:
    """FSDP all-gathers of every leaf stored split over "data", per use."""
    from repro_torch.train.adam import tree_leaves

    for leaf, sh in zip(tree_leaves(leaves), tree_leaves(shardings)):
        g = _axis_in(sh, FSDP)
        if g > 1:
            stats.add("all-gather", _nbytes(leaf) * g / sh.num_shards, g,
                      uses)


def _grad_sync(stats, leaves, shardings, mesh) -> None:
    """Gradient reduce-scatter over "data" (all-reduce for leaves not
    split there), then all-reduce over "pod"."""
    from repro_torch.train.adam import tree_leaves

    data = mesh.shape.get("data", 1)
    for leaf, sh in zip(tree_leaves(leaves), tree_leaves(shardings)):
        piece = _nbytes(leaf) / sh.num_shards
        if _axis_in(sh, FSDP) > 1:
            stats.add("reduce-scatter", piece, data)
        else:
            stats.add("all-reduce", piece, data)
        stats.add("all-reduce", piece, mesh.shape.get("pod", 1))


def _block_collectives(stats, cfg, mesh, period_abs, period_sh, rows: int,
                       seq: int, *, passes: int, backward: bool,
                       decode: bool, enc_seq: int = 0) -> None:
    """One period's activation collectives, ``passes`` forward runs (1, or
    2 with the remat recompute) and, with ``backward``, one backward: TP
    all-reduces after row-parallel products (forward) and of the
    column-parallel inputs' gradients (backward); K/V all-gathers of
    sequence-parallel attention, the flash-decoding combine of a
    KV-sequence-split cache."""
    from repro_torch.models.config import MAMBA

    tp = axis_size(mesh, TP)
    if tp == 1:
        return
    rows_loc = rows / _dp_split(mesh, rows)
    isz = 2 if cfg.compute_dtype == "bfloat16" else 4
    act = rows_loc * seq * cfg.d_model * isz
    for i, spec in enumerate(cfg.pattern):
        blk = period_abs[f"block_{i}"]
        products = 1  # the mixer's out projection
        ffn = blk.get("ffn", {})
        if cfg.moe is not None and spec.moe:
            cap = max(1, -(-int(seq * cfg.moe.top_k * cfg.moe.capacity_factor)
                           // cfg.moe.num_experts))
            expert = rows_loc * min(cap, seq) * cfg.d_model * isz
            stats.add("all-reduce", expert, tp,
                      (passes + backward) * cfg.moe.num_experts)
            products += 1 if cfg.moe.shared_expert else 0
        elif ffn:
            products += 1
        if "cross" in blk:
            products += 1
        stats.add("all-reduce", act, tp, (passes + backward) * products)
        if spec.kind == MAMBA:
            continue
        split = _attention_split(cfg, tp, seq, decode)
        kv_bytes = rows_loc * seq * cfg.kv_dim * isz
        if decode and split == "sequence":
            combine = rows_loc * (cfg.q_dim + 2 * cfg.num_heads) * 4
            stats.add("all-reduce", combine, tp, passes)
        elif not decode and split == "sequence":
            stats.add("all-gather", kv_bytes, tp, 2 * passes)
            if backward:
                stats.add("reduce-scatter", kv_bytes / tp, tp, 2)
        if "cross" in blk and enc_seq and split != "heads":
            cross = rows_loc * enc_seq * cfg.kv_dim * isz
            stats.add("all-gather", cross, tp, 2 * passes)


def _outside_collectives(stats, cfg, mesh, params_abs, p_sh, rows: int,
                         seq: int, *, train: bool) -> None:
    """The model outside its period stack: the vocab-split embedding's sum
    over "model", the loss's log-sum-exp and gold logit over the
    vocab-split logits (train), and the FSDP gathers of the head and
    frontends (forward; again in the backward)."""
    tp = axis_size(mesh, TP)
    rows_loc = rows / _dp_split(mesh, rows)
    isz = 2 if cfg.compute_dtype == "bfloat16" else 4
    stats.add("all-reduce", rows_loc * seq * cfg.d_model * isz, tp)
    if train:
        stats.add("all-reduce", rows_loc * seq * 4, tp, 3)
    outside = {k: v for k, v in params_abs.items()
               if k not in ("layers", "encoder")}
    out_sh = {k: p_sh[k] for k in outside}
    _gathers(stats, outside, out_sh, 1 + train)
    if cfg.is_encdec:
        enc = {"frontend_proj": params_abs["encoder"]["frontend_proj"]}
        _gathers(stats, enc, {"frontend_proj":
                              p_sh["encoder"]["frontend_proj"]}, 1 + train)


# --------------------------------------------------------------------------
# LM cells
# --------------------------------------------------------------------------
def _period_train(cfg, pattern, period_abs, rows, seq, enc_len, remat):
    """Fake-run body: one period forward + backward (through
    ``transformer._run_stack``, so with its checkpoint when ``remat``)."""
    from repro_torch.models.layers import compute_dtype
    from repro_torch.models.transformer import _run_stack

    def run(piece):
        cdt = compute_dtype(cfg)
        x = torch.empty((rows, seq, cfg.d_model), dtype=cdt,
                        requires_grad=True)
        enc = (torch.empty((rows, enc_len, cfg.d_model), dtype=cdt,
                           requires_grad=True) if enc_len else None)
        pp, leaves = _grad_leaves(period_abs)
        stacked = _stack1(pp)
        c = dataclasses.replace(cfg, remat=remat)
        out = _run_stack(stacked, x, c, pattern, torch.arange(seq), enc)
        loss = torch.sum(out.float())
        piece.mark()
        inputs = leaves + [x] + ([enc] if enc is not None else [])
        torch.autograd.grad(loss, inputs, allow_unused=True)

    return run


def _stack1(tree: dict) -> dict:
    """Every leaf with a leading axis of one (a one-period stack)."""
    return {k: _stack1(v) if isinstance(v, dict) else v[None]
            for k, v in tree.items()}


def _period_forward(cfg, pattern, period_abs, rows, seq, enc_len):
    """Fake-run body: one period forward without gradients."""
    from repro_torch.models.layers import compute_dtype
    from repro_torch.models.transformer import _run_stack

    def run(piece):
        cdt = compute_dtype(cfg)
        x = torch.empty((rows, seq, cfg.d_model), dtype=cdt)
        enc = (torch.empty((rows, enc_len, cfg.d_model), dtype=cdt)
               if enc_len else None)
        with torch.no_grad():
            _run_stack(_stack1(period_abs), x, cfg, pattern,
                       torch.arange(seq), enc)

    return run


def _period_decode(cfg, period_abs, period_cache, rows):
    """Fake-run body: one period of ``decode_step``'s loop."""
    from repro_torch.models.layers import compute_dtype
    from repro_torch.models.transformer import _decode_period

    def run(piece):
        x = torch.empty((rows, 1, cfg.d_model), dtype=compute_dtype(cfg))
        with torch.no_grad():
            _decode_period(period_abs, period_cache, x,
                           torch.zeros((), dtype=torch.int32), cfg)

    return run


def analysis_lm_cell(arch: str, shape_name: str, mesh, opts=None, *,
                     cfg=None, shape=None) -> tuple:
    """Composed per-chip Cost for an LM cell + the piece breakdown.

    ``cfg`` / ``shape`` replace the arch's config and the named shape (a
    cut cell); ``pieces["memory"]`` holds the temp estimate's parts."""
    from repro_torch.launch.dryrun import _num_microbatches, apply_opts
    from repro_torch.models import (abstract_params, input_specs,
                                    param_shardings)
    from repro_torch.models.steps import _loss_and_grads, make_prefill_step
    from repro_torch.models.transformer import (decode_step, fake_mode,
                                                init_cache)
    from repro_torch.train.adam import (AdamConfig, adam_init, adam_update,
                                        tree_leaves, tree_unflatten)

    opts = opts or {}
    cfg = cfg or get_config(arch)
    shape = shape or LM_SHAPES[shape_name]
    cfg, shape = apply_opts(cfg, shape, opts)
    serving = bool(opts.get("serving_resident")) and shape.step != "train"
    set_global_mesh(mesh)
    params_abs = abstract_params(cfg)
    p_sh = param_shardings(cfg, mesh, params_abs, serving=serving)
    period_abs, period_sh = _period_shardings(cfg, mesh, params_abs,
                                              serving=serving)
    cfg1 = _one_period(cfg)
    params1 = abstract_params(cfg1)
    pcount = cfg.num_periods
    pieces = {}
    seq = shape.seq_len if not cfg.is_encdec else cfg.decoder_len
    enc_len = shape.seq_len if cfg.is_encdec else 0

    if shape.step == "train":
        m = _num_microbatches(shape, mesh)
        specs = input_specs(cfg, shape)["batch"]
        rows = specs["tokens"].shape[0] // m
        with fake_mode():
            mb = {k: torch.empty((rows,) + tuple(v.shape[1:]), dtype=v.dtype)
                  for k, v in specs.items()}
        div, act_div = _divisors(cfg, mesh, rows, seq, decode=False)

        a_p = _Piece(lambda piece: _loss_and_grads(params1, cfg1, mb), div)
        b_p = _Piece(_period_train(cfg, cfg.pattern, period_abs, rows, seq,
                                   enc_len, remat=False), div)
        t_p = _Piece(_period_train(cfg, cfg.pattern, period_abs, rows, seq,
                                   enc_len, remat=cfg.remat), div)
        acfg = AdamConfig(learning_rate=3e-4, grad_clip_norm=1.0)

        def opt_run(piece):
            opt = adam_init(params_abs)
            grads = tree_unflatten(params_abs, [
                torch.empty(p.shape, dtype=torch.float32)
                for p in tree_leaves(params_abs)])
            adam_update(grads, opt, params_abs, acfg)

        # Adam is elementwise over leaves split over every position
        c_p = _Piece(opt_run, {k: mesh.size for k in div})

        passes = 1 + bool(cfg.remat)
        a_st, b_st, r_st = (CollectiveStats(), CollectiveStats(),
                            CollectiveStats())
        _block_collectives(a_st, cfg, mesh, period_abs, period_sh, rows, seq,
                           passes=passes, backward=True, decode=False,
                           enc_seq=enc_len)
        _gathers(a_st, period_abs, period_sh, passes + 1)
        _outside_collectives(a_st, cfg, mesh, params_abs, p_sh, rows, seq,
                             train=True)
        outside = {k: v for k, v in params_abs.items() if k != "layers"}
        _grad_sync(a_st, outside, {k: p_sh[k] for k in outside}, mesh)
        _grad_sync(a_st, period_abs, period_sh, mesh)
        _block_collectives(b_st, cfg, mesh, period_abs, period_sh, rows, seq,
                           passes=1, backward=True, decode=False,
                           enc_seq=enc_len)
        _gathers(b_st, period_abs, period_sh, 2)
        _grad_sync(b_st, period_abs, period_sh, mesh)
        if cfg.remat:
            _block_collectives(r_st, cfg, mesh, period_abs, period_sh, rows,
                               seq, passes=1, backward=False, decode=False,
                               enc_seq=enc_len)
            _gathers(r_st, period_abs, period_sh, 1)
        c_st = CollectiveStats()
        c_st.add("all-reduce", 4, mesh.size)  # the global-norm clip

        a = a_p.with_collectives(a_st)
        b_piece = b_p.with_collectives(b_st)
        r_piece = Cost(t_p.cost.flops - b_p.cost.flops,
                       t_p.cost.bytes - b_p.cost.bytes,
                       r_st.bytes_per_chip, dict(r_st.counts))
        c = Cost(c_p.cost.flops, c_p.cost.bytes, c_st.bytes_per_chip,
                 dict(c_st.counts))
        total = m * (a + (pcount - 1) * (b_piece + r_piece)) + c
        live = a_p.peak + (pcount - 1) * t_p.retained
        if cfg.is_encdec:  # encoder stack correction (one layer in A)
            enc_piece, enc_r, enc_p = lower_period_encoder(
                cfg, mesh, rows, shape.seq_len, train=True,
                period_args=(params_abs, p_sh), div=div)
            total = total + m * (cfg.encoder.num_layers - 1) * (enc_piece
                                                               + enc_r)
            live += (cfg.encoder.num_layers - 1) * enc_p.retained
            pieces["enc_body"] = dataclasses.asdict(enc_piece)
            pieces["enc_remat_body"] = dataclasses.asdict(enc_r)
        acc = 0
        if m > 1:  # fp32 gradient accumulators, placed as the params
            acc = sum(p.numel() * 4 // sh.num_shards
                      for p, sh in zip(tree_leaves(params_abs),
                                       tree_leaves(p_sh)))
        temp = max(live / act_div + acc, c_p.peak / mesh.size)
        pieces.update(
            raw_production=_raw(a, a_st),
            mb_grad=dataclasses.asdict(a),
            period_body=dataclasses.asdict(b_piece),
            remat_body=dataclasses.asdict(r_piece),
            optimizer=dataclasses.asdict(c),
            multipliers={"microbatches": m, "periods": pcount},
            memory={"temp_bytes": temp, "live_peak_mb_grad": a_p.peak,
                    "retained_per_period": t_p.retained,
                    "grad_accumulator": acc, "activation_divisor": act_div},
        )
        return total, pieces

    if shape.step == "prefill":
        specs = input_specs(cfg, shape)["batch"]
        rows = shape.global_batch
        div, act_div = _divisors(cfg, mesh, rows, seq, decode=False)
        step1 = make_prefill_step(cfg1)
        a_p = _Piece(lambda piece: step1(params1, specs), div)
        b_p = _Piece(_period_forward(cfg, cfg.pattern, period_abs, rows, seq,
                                     enc_len), div)
        a_st, b_st = CollectiveStats(), CollectiveStats()
        _block_collectives(a_st, cfg, mesh, period_abs, period_sh, rows, seq,
                           passes=1, backward=False, decode=False,
                           enc_seq=enc_len)
        _gathers(a_st, period_abs, period_sh, 1)
        _outside_collectives(a_st, cfg, mesh, params_abs, p_sh, rows, seq,
                             train=False)
        _block_collectives(b_st, cfg, mesh, period_abs, period_sh, rows, seq,
                           passes=1, backward=False, decode=False,
                           enc_seq=enc_len)
        _gathers(b_st, period_abs, period_sh, 1)
        a = a_p.with_collectives(a_st)
        b_piece = b_p.with_collectives(b_st)
        total = a + (pcount - 1) * b_piece
        peak = max(a_p.peak, b_p.peak)
        if cfg.is_encdec:
            enc_piece, _, enc_p = lower_period_encoder(
                cfg, mesh, rows, shape.seq_len, train=False,
                period_args=(params_abs, p_sh), div=div)
            total = total + (cfg.encoder.num_layers - 1) * enc_piece
            peak = max(peak, enc_p.peak)
            pieces["enc_body"] = dataclasses.asdict(enc_piece)
        pieces.update(raw_production=_raw(a, a_st),
                      full_once=dataclasses.asdict(a),
                      period_body=dataclasses.asdict(b_piece),
                      multipliers={"periods": pcount},
                      memory={"temp_bytes": peak / act_div,
                              "activation_divisor": act_div})
        return total, pieces

    # decode
    specs = input_specs(cfg, shape)
    rows = shape.global_batch
    div, act_div = _divisors(cfg, mesh, rows, shape.seq_len, decode=True)
    enc_len = min(shape.seq_len, cfg.encoder.max_source_len) \
        if cfg.is_encdec else 0
    with fake_mode():
        cache1 = init_cache(cfg1, rows, shape.seq_len, enc_len=enc_len,
                            device="cpu")
        period_cache = _strip_lead(cache1)
    a_p = _Piece(lambda piece: decode_step(params1, cfg1, cache1,
                                           specs["tokens"], specs["pos"]),
                 div)
    b_p = _Piece(_period_decode(cfg, period_abs, period_cache, rows), div)
    a_st, b_st = CollectiveStats(), CollectiveStats()
    for st in (a_st, b_st):
        _block_collectives(st, cfg, mesh, period_abs, period_sh, rows, 1,
                           passes=1, backward=False, decode=True)
        _gathers(st, period_abs, period_sh, 1)
    _outside_collectives(a_st, cfg, mesh, params_abs, p_sh, rows, 1,
                         train=False)
    a = a_p.with_collectives(a_st)
    b_piece = b_p.with_collectives(b_st)
    total = a + (pcount - 1) * b_piece
    pieces.update(raw_production=_raw(a, a_st),
                  full_once=dataclasses.asdict(a),
                  period_body=dataclasses.asdict(b_piece),
                  multipliers={"periods": pcount},
                  memory={"temp_bytes": max(a_p.peak, b_p.peak) / act_div,
                          "activation_divisor": act_div})
    return total, pieces


def lower_period_encoder(cfg, mesh, rows, seq, train, period_args, div):
    """One encoder layer's cost (whisper's stack correction): (forward +
    backward, its remat recompute, the piece) with ``train``, else
    (forward, zero, the piece)."""
    from repro_torch.models.config import ATTN_BIDIR, LayerSpec

    params_abs, p_sh = period_args
    enc_abs = _strip_lead_in_fake(params_abs["encoder"]["layers"])
    enc_sh = {"block_0": _map_lead(p_sh["encoder"]["layers"]["block_0"],
                                   mesh)}
    pattern = (LayerSpec(kind=ATTN_BIDIR),)
    base = dataclasses.replace(cfg, pattern=pattern)
    b_st, r_st = CollectiveStats(), CollectiveStats()
    if train:
        b_p = _Piece(_period_train(base, pattern, enc_abs, rows, seq, 0,
                                   remat=False), div)
        t_p = _Piece(_period_train(base, pattern, enc_abs, rows, seq, 0,
                                   remat=cfg.remat), div)
        _block_collectives(b_st, base, mesh, enc_abs, enc_sh, rows, seq,
                           passes=1, backward=True, decode=False)
        _gathers(b_st, enc_abs, enc_sh, 2)
        _grad_sync(b_st, enc_abs, enc_sh, mesh)
        if cfg.remat:
            _block_collectives(r_st, base, mesh, enc_abs, enc_sh, rows, seq,
                               passes=1, backward=False, decode=False)
            _gathers(r_st, enc_abs, enc_sh, 1)
        r = Cost(t_p.cost.flops - b_p.cost.flops,
                 t_p.cost.bytes - b_p.cost.bytes, r_st.bytes_per_chip,
                 dict(r_st.counts))
        return b_p.with_collectives(b_st), r, t_p
    b_p = _Piece(_period_forward(base, pattern, enc_abs, rows, seq, 0), div)
    _block_collectives(b_st, base, mesh, enc_abs, enc_sh, rows, seq,
                       passes=1, backward=False, decode=False)
    _gathers(b_st, enc_abs, enc_sh, 1)
    return b_p.with_collectives(b_st), Cost(), b_p


def _strip_lead_in_fake(tree: dict) -> dict:
    from repro_torch.models.transformer import fake_mode

    with fake_mode():
        return _strip_lead(tree)


def _map_lead(tree: dict, mesh) -> dict:
    return {k: _map_lead(v, mesh) if isinstance(v, dict)
            else NamedSharding(mesh, v.spec[1:]) for k, v in tree.items()}


# --------------------------------------------------------------------------
# GP cell
# --------------------------------------------------------------------------
def tile_costs(n: int, m: int, d: int, cols: int, itemsize: int = 4) -> tuple:
    """(forward, backward) Cost of one ring tile K(u, w) @ V from the CUDA
    kernels' own counts: forward r2 and the profile (2nmd + nm) plus the
    product (2nm * cols); backward the du and dw calls, each (4nmd + 3nm)
    plus the g v^T product (2nm * cols). Bytes: each input read once, each
    output written once."""
    fwd = Cost(2 * n * m * d + n * m + 2 * n * m * cols,
               itemsize * (n * d + m * d + m * cols + n * cols))
    one = 4 * n * m * d + 3 * n * m + 2 * n * m * cols
    bwd = Cost(2 * one, 2 * itemsize * (n * d + m * d + n * cols + m * cols
                                        + n * d))
    return fwd, bwd


def analysis_gp_cell(shape_name: str, mesh, opts=None, *,
                     shape=None) -> tuple:
    """GP cell: tile-composition analysis.

    ring sweeps = epochs (CG) + 1 (initial residual) + 1 (gradient's
    forward); the gradient's backward runs each tile's du and dw.
    Rotation traffic: (x_loc + v_loc) bytes per step, ``chips`` steps per
    sweep, one extra sweep-equivalent for the transposes (the reference's
    arithmetic). ``shape`` replaces the named shape (a cut cell)."""
    opts = opts or {}
    bf16 = opts.get("gp_tile_dtype") == "bfloat16"
    shape = shape or GP_SHAPES[shape_name]
    chips = mesh.size
    n_loc = shape.n // chips
    s = shape.num_probes
    d = shape.d

    t_fwd, t_bwd = tile_costs(n_loc, n_loc, d, 1 + s)
    sweeps_fwd = shape.solver_epochs + 2
    tiles_fwd = sweeps_fwd * chips
    tiles_bwd = chips
    total = tiles_fwd * t_fwd + tiles_bwd * t_bwd

    itemsize = 2 if bf16 else 4
    rot_bytes = (n_loc * d + n_loc * (1 + s)) * itemsize
    sweeps_comm = sweeps_fwd + 2  # the gradient's transposes
    # Per chip: ``chips`` rotation steps per sweep, each moving rot_bytes.
    total.coll_bytes += rot_bytes * chips * sweeps_comm
    total.coll_counts["collective-permute"] = (
        total.coll_counts.get("collective-permute", 0)
        + sweeps_comm * chips
    )
    # CG column dots: all-reduce of (1+s) scalars per iteration, counted.
    total.coll_counts["all-reduce"] = shape.solver_epochs * 3
    # the program with its CG loop counted once: 3 sweeps, 5 for comms
    raw = 3 * chips * t_fwd + tiles_bwd * t_bwd
    raw_stats = CollectiveStats()
    raw_stats.add("collective-permute", rot_bytes, 2, chips * 5)
    raw.coll_bytes = raw_stats.bytes_per_chip
    raw.coll_counts = {"collective-permute": 5 * chips, "all-reduce": 3}
    pieces = {
        "raw_production": _raw(raw, raw_stats),
        "tile_fwd": dataclasses.asdict(t_fwd),
        "tile_bwd": dataclasses.asdict(t_bwd),
        "multipliers": {
            "tiles_fwd": tiles_fwd, "tiles_bwd": tiles_bwd,
            "rot_bytes_per_step": rot_bytes,
        },
    }
    return total, pieces
