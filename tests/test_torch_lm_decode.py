"""The port's LM decoding against the reference's at SMOKE, on the
reference's ``init_params`` handed over as numpy: ``decode_step`` for all
ten architectures over 24 teacher-forced steps (2 rows, a 32-slot cache,
so the 8- and 16-slot ring buffers of gemma3, mixtral and llama4 wrap;
whisper's cross cache from ``prefill_cross_cache``), logits and the whole
cache after every step; ``prefill_cross_cache``; the reference's two
invariants on the port alone (decode equals ``forward_lm`` at T = 48 for
the nine decoder-only architectures, and whisper's decode equals
``forward_encdec``); and the entry points' twins: ``serve_lm`` and the
demo's greedy decode against the reference's loop (``make_serve_step`` +
argmax) on the same params, and the serve CLI's dispatch.

Bounds:
- fp32 compute and cache, the port's own cache carried across steps:
  logits within ``LOGITS_RTOL`` x max(1, max |ref|), every cache leaf
  within ``CACHE_RTOL`` x max(1, its max |ref|). K/V reach magnitudes near
  4, where 1e-6 is two fp32 ulps, and XLA's and torch's sin/cos in the
  rotary embedding differ in the last bit: the worst K/V difference
  measured is 4.5e-6 (1.3e-6 of the leaf's largest value).
- bf16 (the configs' defaults, bf16 cache): each step starts from the
  reference's cache, handed over bit for bit, so rounding differences do
  not compound across steps. The two packages round bf16 op by op
  differently (XLA on the CPU keeps some fused intermediates in fp32), a
  step moves the logits by up to 2.8 % of their largest magnitude, a bf16
  cache leaf by up to 3.3 bf16 ulps of its largest value, and the fp32
  SSM state, driven by bf16-rounded dt, x and B, by up to 16.2 (jamba;
  all measured). Each (step, row) is held to ``BF16_LOGITS_RTOL`` x max
  |ref|, bf16 leaves to ``BF16_CACHE_ULPS`` and the SSM state to
  ``BF16_STATE_ULPS`` ulps of the leaf's largest value; under MoE a
  near-tie of two experts' router weights can choose another expert for a
  row (mixtral, llama4 and jamba each do once or twice within 24 steps),
  so MoE configs may have ``BF16_MOE_SHARE`` of their (step, row) pairs
  beyond these bounds, still finite.
- invariants: ``INVARIANT_ATOL`` (the reference's own, fp32, MoE capacity
  raised to E / k so that the forward drops no token).
- greedy tokens at fp32 compute: identical.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import LM_ARCHS  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models.transformer import \
    prefill_cross_cache as j_prefill  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import (lm_cache_from_numpy,  # noqa: E402
                                 lm_cache_to_numpy, lm_params_from_numpy)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import (decode_step, forward_encdec,  # noqa: E402
                                forward_lm, init_cache, init_params)
from repro_torch.models.transformer import prefill_cross_cache  # noqa: E402
from torch_lm_parity import (configs, leaves_with_paths,  # noqa: E402
                             reference_params, reference_serve_step)

REPO = Path(__file__).resolve().parents[1]
ROWS, MAX_LEN, STEPS, ENC_LEN = 2, 32, 24, 16
LOGITS_RTOL = 1e-5
CACHE_RTOL = 1e-5
BF16_LOGITS_RTOL = 2.0 ** -4
BF16_CACHE_ULPS = 8
BF16_STATE_ULPS = 32
BF16_MOE_SHARE = 1 / 8
INVARIANT_ATOL = 1e-3
DECODER_ONLY = [a for a in LM_ARCHS if a != "whisper-large-v3"]


def _tokens(cfg, steps=STEPS, rows=ROWS, seed=3) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (steps, rows)).astype(np.int32)


def _both_caches(arch, compute, cache_dtype):
    """Configs, params (numpy and port) and empty caches of both packages,
    whisper's cross cache filled from the same numpy frames."""
    rcfg, pcfg = configs(arch, compute)
    p0 = reference_params(rcfg)
    tp = lm_params_from_numpy(p0)
    enc = ENC_LEN if rcfg.is_encdec else 0
    jc = j_init_cache(rcfg, ROWS, MAX_LEN, enc_len=enc,
                      dtype=getattr(jnp, cache_dtype))
    tc = init_cache(pcfg, ROWS, MAX_LEN, enc_len=enc,
                    dtype=getattr(torch, cache_dtype), device="cpu")
    if rcfg.is_encdec:
        frames = (np.random.default_rng(5).normal(
            size=(ROWS, enc, rcfg.d_model)) * 0.3).astype(np.float32)
        jc = j_prefill(p0, rcfg, frames, jc)
        tc = prefill_cross_cache(tp, pcfg, torch.from_numpy(frames), tc)
    return rcfg, pcfg, p0, tp, jc, tc


def _leaves(jcache, tcache) -> list:
    """(path, reference, port) of every cache leaf as fp32 numpy, the path
    ending in ``:bf16`` for a bf16 leaf."""
    ref = leaves_with_paths(jax.tree.map(np.asarray, jcache))
    got = leaves_with_paths(lm_cache_to_numpy(tcache))
    assert [p for p, _ in ref] == [p for p, _ in got]
    out = []
    for (path, a), (_, b) in zip(ref, got):
        if a.dtype.name == "bfloat16":
            b = b.view(a.dtype)
            path += ":bf16"
        assert a.shape == b.shape and a.dtype == b.dtype, path
        out.append((path, a.astype(np.float32), b.astype(np.float32)))
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_steps_match_reference_fp32(arch):
    rcfg, pcfg, p0, tp, jc, tc = _both_caches(arch, "float32", "float32")
    step = reference_serve_step(rcfg)
    toks = _tokens(rcfg)
    for t in range(STEPS):
        want, jc = step(p0, jc, toks[t], jnp.asarray(t, jnp.int32))
        got, out = decode_step(tp, pcfg, tc, torch.from_numpy(toks[t]), t)
        assert out is tc and got.dtype == torch.float32
        want = np.asarray(want)
        assert got.shape == want.shape
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got.numpy() - want).max()) <= LOGITS_RTOL * scale
        for path, a, b in _leaves(jc, tc):
            err = float(np.abs(a - b).max())
            assert err <= CACHE_RTOL * max(1.0, float(np.abs(a).max())), \
                (t, path, err)


def _ulp(a: np.ndarray) -> float:
    """One bf16 ulp at ``a``'s largest magnitude."""
    top = max(float(np.abs(a).max()), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_steps_match_reference_bf16(arch):
    rcfg, pcfg, p0, tp, jc, _ = _both_caches(arch, "bfloat16", "bfloat16")
    step = reference_serve_step(rcfg)
    toks = _tokens(rcfg)
    beyond, worst = 0, 0.0
    for t in range(STEPS):
        tc = lm_cache_from_numpy(jax.tree.map(np.asarray, jc))
        want, jc = step(p0, jc, toks[t], jnp.asarray(t, jnp.int32))
        got, _ = decode_step(tp, pcfg, tc, torch.from_numpy(toks[t]), t)
        want, got = np.asarray(want), got.numpy()
        assert np.all(np.isfinite(got))
        row_err = np.abs(got - want).max(-1) / float(np.abs(want).max())
        row_ulps = np.zeros(ROWS)  # per row, as a share of its bound
        for path, a, b in _leaves(jc, tc):
            assert np.all(np.isfinite(b))
            diff = np.abs(a - b).reshape(a.shape[0], ROWS, -1)
            limit = (BF16_CACHE_ULPS if path.endswith(":bf16")
                     else BF16_STATE_ULPS)
            row_ulps = np.maximum(row_ulps,
                                  diff.max(axis=(0, 2)) / _ulp(a) / limit)
        bad = (row_err > BF16_LOGITS_RTOL) | (row_ulps > 1.0)
        beyond += int(bad.sum())
        worst = max(worst, float(row_err[~bad].max(initial=0.0)))
    allowed = (BF16_MOE_SHARE * STEPS * ROWS if rcfg.moe is not None
               else 0)
    assert beyond <= allowed, (beyond, allowed)
    assert worst <= BF16_LOGITS_RTOL


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_prefill_cross_cache_matches_reference(compute):
    _, _, _, _, jc, tc = _both_caches("whisper-large-v3", compute, compute)
    for path, a, b in _leaves(jc, tc):
        if compute == "float32":
            tol = CACHE_RTOL * max(1.0, float(np.abs(a).max()))
        else:
            tol = BF16_CACHE_ULPS * _ulp(a)
        assert float(np.abs(a - b).max()) <= tol, path


def _fp32_no_drops(arch: str):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype="float32")
    if cfg.moe is not None:  # no capacity drops in the forward
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)
            / cfg.moe.top_k))
    return cfg


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_decode_matches_own_forward_lm(arch):
    """The reference's ``test_decode_matches_train_forward`` on the port:
    token-by-token decode reproduces the train forward's logits (fp32)."""
    t_len = 48
    cfg = _fp32_no_drops(arch)
    gen = torch.Generator().manual_seed(0)
    params = init_params(gen, cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, t_len), generator=gen)
    with torch.no_grad():
        ref = forward_lm(params, cfg, toks)
        cache = init_cache(cfg, 2, t_len, dtype=torch.float32, device="cpu")
        errs = []
        for t in range(t_len):
            logits, cache = decode_step(params, cfg, cache, toks[:, t], t)
            errs.append(float((logits - ref[:, t]).abs().max()))
    assert max(errs) < INVARIANT_ATOL, (arch, max(errs))


def test_whisper_decode_matches_own_forward_encdec():
    cfg = _fp32_no_drops("whisper-large-v3")
    gen = torch.Generator().manual_seed(0)
    params = init_params(gen, cfg)
    b, t_enc, t_dec = 2, 32, 12
    frames = torch.randn(b, t_enc, cfg.d_model, generator=gen) * 0.3
    toks = torch.randint(0, cfg.vocab_size, (b, t_dec), generator=gen)
    with torch.no_grad():
        ref = forward_encdec(params, cfg, frames, toks)
        cache = init_cache(cfg, b, t_dec, enc_len=t_enc, dtype=torch.float32,
                           device="cpu")
        cache = prefill_cross_cache(params, cfg, frames, cache)
        errs = []
        for t in range(t_dec):
            logits, cache = decode_step(params, cfg, cache, toks[:, t],
                                        torch.tensor(t))
            errs.append(float((logits - ref[:, t]).abs().max()))
    assert max(errs) < INVARIANT_ATOL


def _reference_greedy(rcfg, p0, rows, steps, max_len, enc_len, frames):
    """The reference CLI's loop (``serve.py:35-41``) on handed-over
    params: greedy tokens (steps, rows) from token 0."""
    cache = j_init_cache(rcfg, rows, max_len, enc_len=enc_len)
    if rcfg.is_encdec:
        cache = j_prefill(p0, rcfg, frames, cache)
    step = reference_serve_step(rcfg)
    toks = jnp.zeros((rows,), jnp.int32)
    out = []
    for pos in range(steps):
        logits, cache = step(p0, cache, toks, jnp.asarray(pos, jnp.int32))
        toks = jnp.argmax(logits[:, : rcfg.vocab_size], axis=-1).astype(
            jnp.int32)
        out.append(np.asarray(toks))
    return np.stack(out)


def _first_frames(cfg, rows, enc_len, seed=0) -> np.ndarray:
    """The frames the port's loops draw first from a fresh CPU generator."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((rows, enc_len, cfg.d_model), generator=gen)
            * 0.3).numpy()


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-780m",
                                  "whisper-large-v3", "mixtral-8x22b"])
def test_serve_lm_greedy_tokens_match_reference(arch, monkeypatch, capsys):
    """``serve_lm`` at fp32 compute (the bf16 cache as in the CLI) with the
    reference's params handed over: the same 16 greedy tokens per row."""
    rcfg, pcfg = configs(arch, "float32")
    p0 = reference_params(rcfg)
    monkeypatch.setattr(serve_cli, "get_config", lambda name, smoke: pcfg)
    args = serve_cli.build_parser().parse_args(
        ["--arch", arch, "--device", "cpu", "--batch", "2", "--tokens",
         "16", "--max-len", "32"])
    got = serve_cli.serve_lm(args, params=lm_params_from_numpy(p0))
    enc = 32 if rcfg.is_encdec else 0
    frames = _first_frames(pcfg, 2, enc) if enc else None
    want = _reference_greedy(rcfg, p0, 2, 16, 32, enc, frames)
    assert np.array_equal(got.numpy(), want)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"[serve] {arch}: 16 steps x batch 2 in ")
    assert line.endswith(f"sample row: {want[:16, 0].tolist()}")


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "whisper-large-v3"])
def test_demo_greedy_decode_matches_reference(arch):
    """The decode half of ``examples/torch_lm_substrate_demo.py`` against
    the reference demo's loop (2 rows, 32 slots, whisper's 16 frames, 8
    tokens) on the same params, at fp32 compute."""
    spec = importlib.util.spec_from_file_location(
        "torch_lm_substrate_demo", REPO / "examples/torch_lm_substrate_demo.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    rcfg, pcfg = configs(arch, "float32")
    p0 = reference_params(rcfg)
    got = demo.greedy_decode(arch, pcfg, lm_params_from_numpy(p0),
                             torch.Generator().manual_seed(0), "cpu")
    enc = 16 if rcfg.is_encdec else 0
    frames = _first_frames(pcfg, 2, enc) if enc else None
    want = _reference_greedy(rcfg, p0, 2, 8, 32, enc, frames)
    assert got == want[:, 0].tolist()


def test_serve_cli_dispatch_and_device_default(monkeypatch, capsys):
    args = serve_cli.build_parser().parse_args([])
    assert (args.arch, args.device, args.batch, args.tokens,
            args.max_len) == ("gp-iterative", "cuda", 4, 32, 128)
    seen = []
    monkeypatch.setattr(serve_cli, "serve_gp",
                        lambda a: seen.append(("gp", a.arch)))
    serve_cli.main(["--arch", "gp-iterative", "--device", "cpu"])
    assert seen == [("gp", "gp-iterative")]
    tokens = serve_cli.main(["--arch", "llama3-8b", "--device", "cpu",
                             "--tokens", "3", "--batch", "2"])
    assert tuple(tokens.shape) == (3, 2)
    assert "[serve] llama3-8b: 3 steps x batch 2" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve_cli.main(["--arch", "llama3-8b"])
