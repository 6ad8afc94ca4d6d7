"""The port's LM building blocks against the reference's, on numpy inputs
from fixed seeds: norms and positions, the four attention masks, attention
(full, SWA, chunked, bidirectional; with and without QKV bias; GQA groups
of 2), cross-attention, the dense FFN (SwiGLU, tanh GELU), MoE (top-2;
top-1 with a shared expert and an overflowing expert; the per-expert
scatter), the SSD scan and the Mamba2 block with chunk < seq, the loss with
a mask, Adam on a dict tree, every field of the twenty LM configs, the
registry, ``make_lm_batch`` and the numpy round trip of a parameter tree.

Bounds: float32 results within ``ATOL`` of the largest reference magnitude
(a bitwise check where the function is exact); bf16 results within
``BF16_ATOL`` of it (two bf16 roundings, 2^-7), the Mamba2 block within
``BF16_BLOCK_ATOL`` (four in sequence: projection, conv, gate, output
projection)."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jconfigs  # noqa: E402
from repro.models import config as jmc  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.steps import lm_loss as j_lm_loss  # noqa: E402
from repro.train import adam as jadam  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.data.synthetic import make_lm_batch  # noqa: E402
from repro_torch.interop import (lm_adam_from_numpy, lm_adam_to_numpy,  # noqa: E402
                                 lm_params_from_numpy, lm_params_to_numpy)
from repro_torch.models import config as tmc  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.steps import lm_loss  # noqa: E402
from repro_torch.train import adam as tadam  # noqa: E402
from torch_lm_parity import leaves_with_paths, reference_params  # noqa: E402

ATOL = 1e-5
BF16_ATOL = 2.0 ** -7
BF16_BLOCK_ATOL = 2.0 ** -6


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got, want, atol=ATOL):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= atol * scale


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(moe=None, ssm=None, **kw):
    """(reference, port) ModelConfigs with the same fields."""
    ref = jmc.ModelConfig(moe=jmc.MoEConfig(**moe) if moe else None,
                          ssm=jmc.SSMConfig(**ssm) if ssm else None, **kw)
    port = tmc.ModelConfig(moe=tmc.MoEConfig(**moe) if moe else None,
                           ssm=tmc.SSMConfig(**ssm) if ssm else None, **kw)
    return ref, port


ATTN = dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
            compute_dtype="float32")


def _attn_params(rng, cfg, bias):
    d = cfg.d_model
    p = {"wq": _normal(rng, d, cfg.q_dim, scale=d ** -0.5),
         "wk": _normal(rng, d, cfg.kv_dim, scale=d ** -0.5),
         "wv": _normal(rng, d, cfg.kv_dim, scale=d ** -0.5),
         "wo": _normal(rng, cfg.q_dim, d, scale=cfg.q_dim ** -0.5)}
    if bias:
        p.update(bq=_normal(rng, cfg.q_dim, scale=0.1),
                 bk=_normal(rng, cfg.kv_dim, scale=0.1),
                 bv=_normal(rng, cfg.kv_dim, scale=0.1))
    return p


# --------------------------------------------------------------------------
# Norms, positions, masks
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    rng = _rng(0)
    x, scale = _normal(rng, 2, 5, 16), _normal(rng, 16, scale=0.1)
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(getattr(torch, dtype))
    got = tl.rms_norm(tx, _t(scale), 1e-5)
    assert got.dtype == tx.dtype
    _close(got, jl.rms_norm(jx, scale, 1e-5),
           ATOL if dtype == "float32" else BF16_ATOL)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope_and_sinusoids_match_reference(theta):
    rng = _rng(1)
    x = _normal(rng, 2, 6, 3, 8)
    pos = np.arange(6, dtype=np.int32)
    _close(tl.rope(_t(x), _t(pos), theta), jl.rope(x, pos, theta))
    pos2 = rng.integers(0, 4096, (2, 6)).astype(np.int32)
    _close(tl.rope(_t(x), _t(pos2), theta), jl.rope(x, pos2, theta))
    _close(tl.sinusoidal_positions(10, 16), jl.sinusoidal_positions(10, 16))


@pytest.mark.parametrize("kind,window", [("full", 0), ("swa", 3),
                                         ("chunked", 4), ("bidir", 0)])
def test_attn_mask_matches_reference(kind, window):
    want = jl._attn_mask(11, kind, window)
    got = tl._attn_mask(11, kind, window)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind,window", [("full", 0), ("swa", 5),
                                         ("chunked", 4), ("bidir", 0)])
@pytest.mark.parametrize("bias", [False, True])
def test_attention_train_matches_reference(kind, window, bias):
    rcfg, pcfg = _cfgs(qkv_bias=bias, **ATTN)
    rng = _rng(2)
    p = _attn_params(rng, rcfg, bias)
    x = _normal(rng, 2, 12, rcfg.d_model)
    pos = np.arange(12, dtype=np.int32)
    want = jl.attention_train(p, x, rcfg, jmc.LayerSpec(kind, window), pos)
    got = tl.attention_train({k: _t(v) for k, v in p.items()}, _t(x), pcfg,
                             tmc.LayerSpec(kind, window), _t(pos))
    _close(got, want)


def test_attention_train_bf16_matches_reference():
    """bf16 operands, fp32 scores (the reference's preferred_element_type)."""
    rcfg, pcfg = _cfgs(**{**ATTN, "compute_dtype": "bfloat16"})
    rng = _rng(3)
    p = _attn_params(rng, rcfg, False)
    x = _normal(rng, 2, 12, rcfg.d_model)
    pos = np.arange(12, dtype=np.int32)
    want = jl.attention_train(p, jnp.asarray(x, jnp.bfloat16), rcfg,
                              jmc.LayerSpec(), pos)
    got = tl.attention_train({k: _t(v) for k, v in p.items()},
                             _t(x).bfloat16(), pcfg, tmc.LayerSpec(), _t(pos))
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_ATOL)


def test_gqa_scores_are_fp32_from_bf16_operands():
    """bf16 q, k, v at score magnitudes near 20: the scores are formed in
    fp32 as the reference's ``preferred_element_type=float32`` einsum forms
    them (a bf16 score would be off by up to 2^-9 of 20, e^0.04 in a
    probability, and fail the bound)."""
    rng = _rng(12)
    q = _normal(rng, 2, 16, 4, 8, scale=1.6)
    k = _normal(rng, 2, 16, 2, 8, scale=1.6)
    v = _normal(rng, 2, 16, 2, 8)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jl._gqa_scores_and_out(jq, jk, jv, None, 1.0)
    got = tl._gqa_scores_and_out(*(_t(a).bfloat16() for a in (q, k, v)),
                                 None, 1.0)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_ATOL)


def test_cross_attention_train_matches_reference():
    rcfg, pcfg = _cfgs(**ATTN)
    rng = _rng(4)
    p = _attn_params(rng, rcfg, False)
    x, enc = _normal(rng, 2, 6, 32), _normal(rng, 2, 9, 32)
    want = jl.cross_attention_train(p, x, enc, rcfg)
    got = tl.cross_attention_train({k: _t(v) for k, v in p.items()}, _t(x),
                                   _t(enc), pcfg)
    _close(got, want)


# --------------------------------------------------------------------------
# FFN: dense and MoE
# --------------------------------------------------------------------------
def _ffn_params(rng, d, f, act, lead=()):
    names = ("wi_gate", "wi_up", "wo") if act == "swiglu" else ("wi", "wo")
    return {n: _normal(rng, *lead, *((f, d) if n == "wo" else (d, f)),
                       scale=(f if n == "wo" else d) ** -0.5) for n in names}


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_reference(act):
    rcfg, pcfg = _cfgs(d_model=16, d_ff=40, mlp_activation=act,
                       compute_dtype="float32")
    rng = _rng(5)
    p = _ffn_params(rng, 16, 40, act)
    x = _normal(rng, 2, 7, 16, scale=2.0)
    _close(tl.mlp({k: _t(v) for k, v in p.items()}, _t(x), pcfg),
           jl.mlp(p, x, rcfg))


MOE_CASES = {
    # mixtral-like top-2 over 4 experts
    "top2": dict(moe=dict(num_experts=4, top_k=2), single=True, seq=32),
    # llama4-scout's SMOKE shape: top-1 over 4 experts with the shared
    # expert; routed weights are all exactly 1.0, and expert 0 overflows
    "top1_shared_overflow": dict(
        moe=dict(num_experts=4, top_k=1, shared_expert=True), single=True,
        seq=64),
    # the per-expert scatter (the reference's A/B baseline)
    "top2_per_expert_scatter": dict(moe=dict(num_experts=4, top_k=2),
                                    single=False, seq=32),
}


def _moe_inputs(case):
    spec = MOE_CASES[case]
    d, f = 64, 128
    rcfg, pcfg = _cfgs(d_model=d, d_ff=f, moe=spec["moe"],
                       moe_single_scatter=spec["single"],
                       compute_dtype="float32")
    rng = _rng(6)
    e = spec["moe"]["num_experts"]
    p = _ffn_params(rng, d, f, "swiglu", lead=(e,))
    p["router"] = _normal(rng, d, e, scale=d ** -0.5)
    if spec["moe"].get("shared_expert"):
        for k, v in _ffn_params(rng, d, f, "swiglu").items():
            p["shared_" + k] = v
    x = _normal(rng, 2, spec["seq"], d)
    if case == "top1_shared_overflow":
        x[..., :8] += 1.5  # tilt the router so one expert overflows
    return rcfg, pcfg, p, x


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_ffn_matches_reference(case):
    rcfg, pcfg, p, x = _moe_inputs(case)
    want = jl.moe_ffn(p, x, rcfg)
    got = tl.moe_ffn({k: _t(v) for k, v in p.items()}, _t(x), pcfg)
    _close(got, want)


def test_moe_ffn_bf16_routes_in_fp32():
    """bf16 compute: the router's logits and softmax in fp32 as the
    reference's. The router is scaled to logits near 20, where a bf16 logit
    (off by up to 2^-9 of 20) would move the top-2 weights of close pairs
    by about 1 % and fail the bound."""
    rcfg, pcfg, p, x = _moe_inputs("top2")
    p["router"] = p["router"] * 20.0
    rcfg = dataclasses.replace(rcfg, compute_dtype="bfloat16")
    pcfg = dataclasses.replace(pcfg, compute_dtype="bfloat16")
    want = jl.moe_ffn(p, jnp.asarray(x, jnp.bfloat16), rcfg)
    got = tl.moe_ffn({k: _t(v) for k, v in p.items()}, _t(x).bfloat16(),
                     pcfg)
    _close(got, want, BF16_ATOL)


def test_moe_top1_overflow_drops_the_reference_tokens():
    """At top-1 every routed token weighs exactly 1.0, so which tokens an
    overflowing expert keeps is a tie-break: the reference keeps the lower
    positions (XLA's TopK). The case's expert does overflow, and keeping the
    higher positions instead changes the output, so the parity above holds
    the order and not only the values."""
    rcfg, pcfg, p, x = _moe_inputs("top1_shared_overflow")
    logits = x @ p["router"]
    routed = np.bincount(logits.argmax(-1).ravel(), minlength=4)
    cap = math.ceil(64 * 1 * pcfg.moe.capacity_factor / 4)
    assert routed.max() > 2 * cap  # over capacity in each row's half

    def later_first(values, k):
        flipped = torch.flip(values, dims=(-1,))
        vals, idx = torch.sort(flipped, dim=-1, descending=True, stable=True)
        return vals[..., :k], values.shape[-1] - 1 - idx[..., :k]

    want = np.asarray(jl.moe_ffn(p, x, rcfg))
    tp = {k: _t(v) for k, v in p.items()}
    original = tl.top_k_ordered
    try:
        tl.top_k_ordered = later_first
        flipped = tl.moe_ffn(tp, _t(x), pcfg).numpy()
    finally:
        tl.top_k_ordered = original
    assert np.abs(flipped - want).max() > 1e-2 * np.abs(want).max()


# --------------------------------------------------------------------------
# SSD and the Mamba2 block
# --------------------------------------------------------------------------
def test_ssd_chunked_matches_reference():
    rng = _rng(7)
    b, l, h, p, n = 2, 32, 3, 4, 5
    x = _normal(rng, b, l, h, p)
    dt = np.log1p(np.exp(_normal(rng, b, l, h) - 1.0)).astype(np.float32)
    a = -np.exp(_normal(rng, h, scale=0.5))
    bm, cm = _normal(rng, b, l, n), _normal(rng, b, l, n)
    want = jssm._ssd_chunked(x, dt, a, bm, cm, 8)
    got = tssm._ssd_chunked(*map(_t, (x, dt, a, bm, cm)), 8)
    _close(got, want)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_mamba_train_matches_reference(compute):
    """mamba2's SMOKE widths, chunk 16 < seq 64."""
    rcfg = dataclasses.replace(jconfigs.get_config("mamba2-780m", smoke=True),
                               compute_dtype=compute)
    pcfg = dataclasses.replace(tconfigs.get_config("mamba2-780m", smoke=True),
                               compute_dtype=compute)
    ssm, d = rcfg.ssm, rcfg.d_model
    d_in, nh = ssm.d_inner(d), ssm.num_heads(d)
    conv_dim = d_in + 2 * ssm.d_state
    rng = _rng(8)
    p = {"in_proj": _normal(rng, d, 2 * d_in + 2 * ssm.d_state + nh,
                            scale=d ** -0.5),
         "conv_w": _normal(rng, ssm.conv_width, conv_dim, scale=0.5),
         "conv_b": _normal(rng, conv_dim, scale=0.1),
         "A_log": np.log1p(np.arange(nh, dtype=np.float32)),
         "D": np.ones(nh, np.float32),
         "dt_bias": _normal(rng, nh, scale=0.5) - 3.0,
         "norm": _normal(rng, d_in, scale=0.1),
         "out_proj": _normal(rng, d_in, d, scale=d_in ** -0.5)}
    x = _normal(rng, 2, 64, d)
    want = jssm.mamba_train(p, jnp.asarray(x), rcfg)
    got = tssm.mamba_train({k: _t(v) for k, v in p.items()}, _t(x), pcfg)
    _close(got, want, ATOL if compute == "float32" else BF16_BLOCK_ATOL)


def test_ssd_gradient_stays_finite_where_exp_overflows():
    """Above the diagonal the segment sums grow with the chunk; where
    ``exp`` overflows there, the reference's masked ``exp`` gives a NaN
    gradient (0 * inf) and the port's ``exp`` of the masked sums does not.
    The values agree."""
    rng = _rng(9)
    b, l, h, p, n = 1, 64, 2, 4, 3
    x, bm, cm = _normal(rng, b, l, h, p), _normal(rng, b, l, n), \
        _normal(rng, b, l, n)
    dt = np.full((b, l, h), 0.5, np.float32)
    a = np.array([-1.0, -8.0], np.float32)  # 8 * 0.5 * 63 > 88: overflow
    want = jssm._ssd_chunked(x, dt, a, bm, cm, 64)
    j_grad = jax.grad(lambda d: jnp.sum(jssm._ssd_chunked(x, d, a, bm, cm,
                                                          64)))(dt)
    td = _t(dt).requires_grad_(True)
    got = tssm._ssd_chunked(_t(x), td, _t(a), _t(bm), _t(cm), 64)
    got.sum().backward()
    _close(got, want)
    assert not np.all(np.isfinite(np.asarray(j_grad)))
    assert torch.isfinite(td.grad).all()


# --------------------------------------------------------------------------
# Loss, Adam
# --------------------------------------------------------------------------
def test_lm_loss_with_mask_matches_reference():
    rng = _rng(10)
    logits = _normal(rng, 2, 9, 48, scale=3.0)
    labels = rng.integers(0, 40, (2, 9)).astype(np.int32)
    mask = (rng.uniform(size=(2, 9)) > 0.3).astype(np.float32)
    _close(lm_loss(_t(logits), _t(labels), _t(mask)),
           j_lm_loss(logits, labels, mask))
    zero = np.zeros_like(mask)
    assert float(lm_loss(_t(logits), _t(labels), _t(zero))) == 0.0


def test_adam_update_on_a_dict_tree_matches_reference():
    """Three steps with the global-norm clip and weight decay on a nested
    dict (the LM layout); the moments and params against the reference's."""
    rng = _rng(11)
    params = {"embed": _normal(rng, 6, 4),
              "layers": {"block_0": {"ln": _normal(rng, 2, 4),
                                     "wq": _normal(rng, 2, 4, 4)}}}
    cfg_kw = dict(learning_rate=1e-2, grad_clip_norm=1.0, weight_decay=0.1)
    jcfg, tcfg = jadam.AdamConfig(**cfg_kw), tadam.AdamConfig(**cfg_kw)
    jp, jst = params, jadam.adam_init(params)
    tp = lm_params_from_numpy(params)
    tst = tadam.adam_init(tp)
    for step in range(3):
        grads = jax.tree.map(lambda a: _normal(rng, *a.shape, scale=2.0),
                             params)
        jp, jst = jadam.adam_update(grads, jst, jp, jcfg)
        tp, tst = tadam.adam_update(lm_params_from_numpy(grads), tst, tp,
                                    tcfg)
        assert tst.step == int(jst.step)
    for want, got in ((jp, tp), (jst.mu, tst.mu), (jst.nu, tst.nu)):
        for (path, a), (_, b) in zip(
                leaves_with_paths(jax.tree.map(np.asarray, want)),
                leaves_with_paths(lm_params_to_numpy(got))):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7,
                                       err_msg=path)
    norm = tadam.global_norm(lm_params_from_numpy(params))
    np.testing.assert_allclose(float(norm), float(jadam.global_norm(params)),
                               rtol=1e-6)


# --------------------------------------------------------------------------
# Configs, registry, batches, round trip
# --------------------------------------------------------------------------
def _as_dict(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("smoke", [False, True])
def test_every_lm_config_matches_reference(smoke):
    """Every field of the ten CONFIGs (or SMOKEs), nested configs included,
    the classes' names, and the derived properties."""
    assert tconfigs.LM_ARCHS == jconfigs.LM_ARCHS
    assert tconfigs.ALL_ARCHS == jconfigs.ALL_ARCHS
    for arch in jconfigs.LM_ARCHS:
        ref = jconfigs.get_config(arch, smoke=smoke)
        got = tconfigs.get_config(arch, smoke=smoke)
        assert type(got).__name__ == type(ref).__name__
        assert _as_dict(got) == _as_dict(ref), arch
        assert [type(s).__name__ for s in got.pattern] == \
            [type(s).__name__ for s in ref.pattern]
        for prop in ("padded_vocab", "q_dim", "kv_dim", "num_periods",
                     "is_encdec", "has_subquadratic_path"):
            assert getattr(got, prop) == getattr(ref, prop), (arch, prop)
        assert got.active_params_per_token_layers() == \
            ref.active_params_per_token_layers()
        assert got.total_params() == ref.total_params()
        if ref.ssm is not None:
            assert got.ssm.d_inner(got.d_model) == ref.ssm.d_inner(ref.d_model)
            assert got.ssm.num_heads(got.d_model) == \
                ref.ssm.num_heads(ref.d_model)


def test_registry_and_shapes_match_reference():
    assert tconfigs.runnable_cells() == jconfigs.runnable_cells()
    assert tconfigs.runnable_cells(include_skips=True) == \
        jconfigs.runnable_cells(include_skips=True)
    for name in ("LM_SHAPES", "SMOKE_SHAPES", "GP_SHAPES"):
        got, want = getattr(tconfigs, name), getattr(jconfigs, name)
        assert {k: _as_dict(v) for k, v in got.items()} == \
            {k: _as_dict(v) for k, v in want.items()}
    assert _as_dict(tconfigs.get_config("gp-iterative")) == \
        _as_dict(jconfigs.get_config("gp-iterative"))
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("llama5")


def test_make_lm_batch_shapes_and_shift():
    gen = torch.Generator().manual_seed(3)
    batch = make_lm_batch(gen, 3, 17, 100, device="cpu")
    assert batch["tokens"].shape == batch["labels"].shape == (3, 17)
    assert batch["tokens"].dtype == torch.int64
    assert torch.equal(batch["tokens"][:, 1:], batch["labels"][:, :-1])
    assert 0 <= int(batch["tokens"].min()) and int(batch["labels"].max()) < 100
    assert torch.equal(batch["mask"], torch.ones(3, 17))
    again = make_lm_batch(torch.Generator().manual_seed(3), 3, 17, 100,
                          device="cpu")
    assert torch.equal(again["tokens"], batch["tokens"])


def test_lm_params_and_adam_round_trip_bitwise():
    rcfg = jconfigs.get_config("llama4-scout-17b-a16e", smoke=True)
    tree = reference_params(rcfg)
    back = lm_params_to_numpy(lm_params_from_numpy(tree))
    pairs = list(zip(leaves_with_paths(tree), leaves_with_paths(back)))
    assert len(pairs) == len(jax.tree.leaves(tree))
    for (pa, a), (pb, b) in pairs:
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    state = {"step": np.int32(3), "mu": tree, "nu": tree}
    got = lm_adam_to_numpy(lm_adam_from_numpy(state))
    assert int(got["step"]) == 3
    for (_, a), (_, b) in zip(leaves_with_paths(tree),
                              leaves_with_paths(got["nu"])):
        np.testing.assert_array_equal(a, b)
