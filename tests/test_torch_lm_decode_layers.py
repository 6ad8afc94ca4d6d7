"""The port's one-token decode blocks against the reference's, on numpy
inputs from fixed seeds: ``attention_decode`` for full, SWA and chunked
layers with ``pos`` before, at and past the window, and at ``max_len``
(the clamped slot write), with QKV bias and with a bf16 cache at fp32
compute; ``cross_attention_decode``; ``mamba_decode`` from a random state
(fp32 and bf16 conv window); ``_sinusoidal_at``; ``init_cache`` for all
ten architectures; the numpy round trip of a cache; the in-place cache
update; and the GQA product without a group-broadcast copy of K or V.

Bounds: fp32 outputs and caches within ``ATOL`` of the largest reference
magnitude (the products' summation order differs); ``_sinusoidal_at``
within ``SIN_ATOL`` of the reference (XLA's and torch's sin/cos differ in
the last bit) and bitwise equal to the port's ``sinusoidal_positions``
row; the cache round trip bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import LM_ARCHS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import config as jmc  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import (lm_cache_from_numpy,  # noqa: E402
                                 lm_cache_to_numpy, lm_params_from_numpy)
from repro_torch.models import config as tmc  # noqa: E402
from repro_torch.models import init_cache, make_serve_step  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from torch_lm_parity import (configs, leaves_with_paths,  # noqa: E402
                             reference_params)

ATOL = 1e-5
SIN_ATOL = 1e-6


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    """A port tensor or a reference array as fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, atol=ATOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= atol * scale


def _cfgs(ssm=None, **kw):
    ref = jmc.ModelConfig(ssm=jmc.SSMConfig(**ssm) if ssm else None, **kw)
    port = tmc.ModelConfig(ssm=tmc.SSMConfig(**ssm) if ssm else None, **kw)
    return ref, port


ATTN = dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
            compute_dtype="float32")


def _attn_params(rng, bias=False):
    d, q, kv = 32, 32, 16
    p = {"wq": _normal(rng, d, q, scale=d ** -0.5),
         "wk": _normal(rng, d, kv, scale=d ** -0.5),
         "wv": _normal(rng, d, kv, scale=d ** -0.5),
         "wo": _normal(rng, q, d, scale=q ** -0.5)}
    if bias:
        p.update(bq=_normal(rng, q, scale=0.1), bk=_normal(rng, kv, scale=0.1),
                 bv=_normal(rng, kv, scale=0.1))
    return p


# (kind, window, cache slots, positions): SWA and chunked rings of 8 slots
# before, at and past the window; an SWA cache longer than its window (not
# a ring: slot = pos); full attention at pos = max_len (the clamped write).
DECODE_CASES = [
    ("full", 0, 16, (0, 7, 15, 16, 20)),
    ("swa", 8, 8, (3, 8, 13)),
    ("chunked", 8, 8, (3, 8, 13)),
    ("swa", 8, 12, (5, 12)),
]


@pytest.mark.parametrize("kind,window,slots,positions", DECODE_CASES)
@pytest.mark.parametrize("bias", [False, True])
def test_attention_decode_matches_reference(kind, window, slots, positions,
                                            bias):
    rng = np.random.default_rng(slots + window + bias)
    rcfg, pcfg = _cfgs(qkv_bias=bias, rope_theta=500.0, **ATTN)
    rspec = jmc.LayerSpec(kind=kind, window=window)
    pspec = tmc.LayerSpec(kind=kind, window=window)
    p = _attn_params(rng, bias)
    tp = {k: _t(v) for k, v in p.items()}
    for pos in positions:
        x = _normal(rng, 2, 1, 32)
        k = _normal(rng, 2, slots, 2, 8)
        v = _normal(rng, 2, slots, 2, 8)
        want, wc = jl.attention_decode(p, jnp.asarray(x), {"k": k, "v": v},
                                       jnp.asarray(pos, jnp.int32), rcfg,
                                       rspec)
        got, gc = tl.attention_decode(tp, _t(x), {"k": _t(k), "v": _t(v)},
                                      pos, pcfg, pspec)
        _close(got, want)
        _close(gc["k"], wc["k"])
        _close(gc["v"], wc["v"])


def test_attention_decode_bf16_cache_at_fp32_compute():
    """K/V written in the cache's dtype, read back through it, and the
    bf16 output promoted for the output projection, as the reference."""
    rng = np.random.default_rng(7)
    rcfg, pcfg = _cfgs(**ATTN)
    p = _attn_params(rng)
    tp = {k: _t(v) for k, v in p.items()}
    x = _normal(rng, 2, 1, 32)
    k = jnp.asarray(_normal(rng, 2, 16, 2, 8), jnp.bfloat16)
    v = jnp.asarray(_normal(rng, 2, 16, 2, 8), jnp.bfloat16)
    tk, tv = _t(_np(k)).bfloat16(), _t(_np(v)).bfloat16()
    want, wc = jl.attention_decode(p, jnp.asarray(x), {"k": k, "v": v},
                                   jnp.asarray(9, jnp.int32), rcfg,
                                   jmc.LayerSpec())
    got, gc = tl.attention_decode(tp, _t(x), {"k": tk, "v": tv}, 9, pcfg,
                                  tmc.LayerSpec())
    assert got.dtype == torch.float32 and gc["k"].dtype == torch.bfloat16
    # one bf16 rounding of the probabilities and of the product (2^-7)
    _close(got, want, atol=2.0 ** -7)
    assert np.array_equal(_np(gc["k"]), _np(wc["k"]))
    assert np.array_equal(_np(gc["v"]), _np(wc["v"]))


def test_attention_decode_takes_a_tensor_position():
    rng = np.random.default_rng(3)
    _, pcfg = _cfgs(**ATTN)
    tp = {k: _t(v) for k, v in _attn_params(rng).items()}
    x = _t(_normal(rng, 2, 1, 32))
    spec = tmc.LayerSpec(kind="swa", window=8)
    outs = []
    for pos in (11, torch.tensor(11, dtype=torch.int32)):
        cache = {"k": torch.zeros(2, 8, 2, 8), "v": torch.zeros(2, 8, 2, 8)}
        outs.append(tl.attention_decode(tp, x, cache, pos, pcfg, spec))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1]["k"], outs[1][1]["k"])


def test_cross_attention_decode_matches_reference():
    rng = np.random.default_rng(11)
    rcfg, pcfg = _cfgs(**ATTN)
    p = _attn_params(rng)
    x = _normal(rng, 2, 1, 32)
    ck, cv = _normal(rng, 2, 12, 2, 8), _normal(rng, 2, 12, 2, 8)
    want = jl.cross_attention_decode(p, jnp.asarray(x), {"ck": ck, "cv": cv},
                                     rcfg)
    got = tl.cross_attention_decode({k: _t(v) for k, v in p.items()}, _t(x),
                                    {"ck": _t(ck), "cv": _t(cv)}, pcfg)
    _close(got, want)


SSM = dict(d_state=8, head_dim=8, expand=2, conv_width=4, chunk=8)


def _mamba_params(rng):
    d, d_in, nh, n = 32, 64, 8, 8
    conv_dim = d_in + 2 * n
    return {"in_proj": _normal(rng, d, 2 * d_in + 2 * n + nh, scale=d ** -0.5),
            "conv_w": _normal(rng, 4, conv_dim, scale=0.5),
            "conv_b": _normal(rng, conv_dim, scale=0.1),
            "A_log": np.log(1.0 + np.arange(nh, dtype=np.float32)),
            "D": _normal(rng, nh, scale=0.5) + 1.0,
            "dt_bias": _normal(rng, nh, scale=0.5) - 2.0,
            "norm": _normal(rng, d_in, scale=0.1),
            "out_proj": _normal(rng, d_in, d, scale=d_in ** -0.5)}


@pytest.mark.parametrize("conv_dtype", ["float32", "bfloat16"])
def test_mamba_decode_from_a_random_state(conv_dtype):
    """Three steps from a handed-over random state; with a bf16 conv cache
    the window is rounded through bf16 every step, as in the reference."""
    rng = np.random.default_rng(5)
    rcfg, pcfg = _cfgs(ssm=SSM, d_model=32, compute_dtype="float32")
    p = _mamba_params(rng)
    tp = {k: _t(v) for k, v in p.items()}
    jdt = jnp.float32 if conv_dtype == "float32" else jnp.bfloat16
    conv = jnp.asarray(_normal(rng, 2, 3, 80), jdt)
    state = _normal(rng, 2, 8, 8, 8, scale=0.5)
    jc = {"conv": conv, "ssm": jnp.asarray(state)}
    tc = {"conv": _t(_np(conv)).to(getattr(torch, conv_dtype)),
          "ssm": _t(state)}
    for _ in range(3):
        x = _normal(rng, 2, 1, 32)
        want, jc = jssm.mamba_decode(p, jnp.asarray(x), jc, rcfg)
        got, tc = tssm.mamba_decode(tp, _t(x), tc, pcfg)
        _close(got, want)
        _close(tc["ssm"], jc["ssm"])
        _close(tc["conv"], jc["conv"])
    assert tc["conv"].dtype == getattr(torch, conv_dtype)
    assert tc["ssm"].dtype == torch.float32


@pytest.mark.parametrize("pos", [0, 5, 63, 1000])
def test_sinusoidal_at_is_a_row_of_sinusoidal_positions(pos):
    got = tt._sinusoidal_at(torch.tensor(pos), 64, torch.float32)
    assert torch.equal(got, tl.sinusoidal_positions(pos + 1, 64)[pos])
    want = jt._sinusoidal_at(jnp.asarray(pos, jnp.int32), 64, jnp.float32)
    assert float(np.abs(_np(got) - _np(want)).max()) <= SIN_ATOL


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_cache_shapes_dtypes_and_zeros(arch):
    rcfg, pcfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    enc = 16 if rcfg.is_encdec else 0
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        want = jax.eval_shape(
            lambda: j_init_cache(rcfg, 2, 40, enc_len=enc, dtype=jdt))
        got = init_cache(pcfg, 2, 40, enc_len=enc, dtype=tdt, device="cpu")
        w, g = leaves_with_paths(want), leaves_with_paths(got)
        assert [p for p, _ in w] == [p for p, _ in g]
        for (path, a), (_, b) in zip(w, g):
            assert tuple(b.shape) == tuple(a.shape), path
            assert str(b.dtype).split(".")[1] == str(a.dtype), path
            assert not bool(b.any()), path


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-large-v3"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cache_numpy_round_trip_is_bitwise(arch, dtype):
    """A reference cache filled with random values (bf16 leaves as numpy's
    ``bfloat16``) into the port and back, bit for bit."""
    cfg = j_get_config(arch, smoke=True)
    cache = j_init_cache(cfg, 2, 24, enc_len=8 if cfg.is_encdec else 0,
                         dtype=getattr(jnp, dtype))
    leaves, treedef = jax.tree.flatten(cache)
    keys = jax.random.split(jax.random.PRNGKey(0), len(leaves))
    filled = jax.tree.map(np.asarray, jax.tree.unflatten(treedef, [
        jax.random.normal(k, a.shape).astype(a.dtype)
        for k, a in zip(keys, leaves)]))
    port = lm_cache_from_numpy(filled)
    back = lm_cache_to_numpy(port)
    for (path, a), (_, t), (_, b) in zip(leaves_with_paths(filled),
                                         leaves_with_paths(port),
                                         leaves_with_paths(back)):
        assert str(t.dtype).split(".")[1] == a.dtype.name, path
        if a.dtype.name == "bfloat16":
            assert b.dtype == np.uint16, path
            assert np.array_equal(a.view(np.uint16), b), path
        else:
            assert b.dtype == a.dtype and np.array_equal(a, b), path


def test_decode_updates_the_callers_cache_in_place():
    """``decode_step`` and the serve step write into the caller's tensors
    and return the same dict; a clone keeps the state from before."""
    _, pcfg = configs("jamba-v0.1-52b", "float32")
    rcfg, _ = configs("jamba-v0.1-52b", "float32")
    params = lm_params_from_numpy(reference_params(rcfg))
    cache = init_cache(pcfg, 2, 8, device="cpu")
    ptrs = {p: t.data_ptr() for p, t in leaves_with_paths(cache)}
    before = {p: t.clone() for p, t in leaves_with_paths(cache)}
    step = make_serve_step(pcfg)
    toks = torch.tensor([3, 7], dtype=torch.int32)
    for pos in range(3):
        _, out = step(params, cache, toks, pos)
        assert out is cache
    after = leaves_with_paths(cache)
    assert {p: t.data_ptr() for p, t in after} == ptrs
    assert all(not torch.equal(t, before[p]) for p, t in after)
    _, out = tt.decode_step(params, pcfg, cache, toks, torch.tensor(3))
    assert out is cache


def test_gqa_product_makes_no_group_broadcast_copy():
    """At a GQA shape (G = 3 query heads per KV head) no op of the product
    sees a tensor of G x |K| elements: the group axis is folded into the
    query rows, not broadcast over K and V."""
    from torch.profiler import ProfilerActivity, profile

    b, s, t, kv, g, hd = 2, 5, 24, 2, 3, 8
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(b, s, kv * g, hd, generator=gen)
    k = torch.randn(b, t, kv, hd, generator=gen).bfloat16()
    v = torch.randn(b, t, kv, hd, generator=gen).bfloat16()
    mask = torch.zeros(s, t)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        out = tl._gqa_scores_and_out(q, k, v, mask, 0.3)
    assert out.shape == (b, s, kv * g, hd)
    broadcast = g * k.numel()
    seen = [(e.name, shp) for e in prof.events()
            for shp in e.input_shapes if shp and np.prod(shp) >= broadcast]
    assert not seen, seen
    # and the values are the reference's
    want = jl._gqa_scores_and_out(
        jnp.asarray(q.numpy()), jnp.asarray(_np(k), jnp.bfloat16),
        jnp.asarray(_np(v), jnp.bfloat16), jnp.asarray(mask.numpy()), 0.3)
    _close(out, want, atol=2.0 ** -7)
