"""The port's LM models against the reference's at SMOKE, on the
reference's ``init_params`` handed over as numpy and numpy batches:
``forward_lm`` logits for the nine decoder-only architectures (internvl2
with its patch prefix) and ``forward_encdec`` (and ``encode``) for whisper,
at ``compute_dtype="float32"``; the prefill step; then one bf16 train case
per family (the configs' own compute dtype): transformer (llama3), vision
prefix (internvl2), MoE (mixtral), SSM (mamba2) and encoder-decoder
(whisper), 3 ``make_train_step`` steps each; and the
``examples/torch_lm_substrate_demo.py`` twin on the CPU.

Bounds: fp32 logits within ``LOGITS_ATOL`` of the largest logit magnitude;
bf16 train steps: each loss within ``BF16_LOSS_RTOL``, each Adam moment
within ``BF16_MOMENT_RTOL`` of the tree's largest moment, every parameter
within 6 lr (the most three sign-flipped Adam updates can part an
element) and at most ``BF16_PARAM_SHARE`` of a model's parameters beyond
1e-4. bf16 rounds each matmul in both packages, but their accumulation
orders differ, and under MoE a rounded router weight can move a token
across an expert's capacity."""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import LM_ARCHS  # noqa: E402
from repro.models import encode as j_encode  # noqa: E402
from repro.models import forward_encdec as j_forward_encdec  # noqa: E402
from repro.models import forward_lm as j_forward_lm  # noqa: E402
from torch_lm_parity import (LR, check_moments, check_params,  # noqa: E402
                             configs, numpy_batch, reference_params,
                             train_both)
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.models import (encode, forward_encdec, forward_lm,  # noqa: E402
                                make_prefill_step)

REPO = Path(__file__).resolve().parents[1]
LOGITS_ATOL = 1e-5
BF16_LOSS_RTOL = 5e-3
BF16_MOMENT_RTOL = 0.3
BF16_PARAM_SHARE = 0.1
DECODER_ONLY = [a for a in LM_ARCHS if a != "whisper-large-v3"]


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _close(got, want, atol_rel=LOGITS_ATOL):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= atol_rel * scale, (err, scale)


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_forward_lm_logits_match_reference(arch):
    rcfg, pcfg = configs(arch, "float32")
    p = reference_params(rcfg)
    batch = numpy_batch(rcfg, 7)
    patch = batch.get("patch_embeds")
    want = jax.jit(lambda p, t, e: j_forward_lm(p, rcfg, t, patch_embeds=e))(
        p, batch["tokens"], patch)
    got = forward_lm(lm_params_from_numpy(p), pcfg,
                     torch.from_numpy(batch["tokens"]),
                     None if patch is None else torch.from_numpy(patch))
    assert got.shape[-1] == pcfg.padded_vocab
    _close(got, want)


def test_forward_encdec_and_encode_match_reference():
    rcfg, pcfg = configs("whisper-large-v3", "float32")
    p = reference_params(rcfg)
    batch = numpy_batch(rcfg, 8)
    tp = lm_params_from_numpy(p)
    frames = torch.from_numpy(batch["frames"])
    _close(encode(tp, pcfg, frames), j_encode(p, rcfg, batch["frames"]))
    want = jax.jit(lambda p, f, t: j_forward_encdec(p, rcfg, f, t))(
        p, batch["frames"], batch["tokens"])
    _close(forward_encdec(tp, pcfg, frames, torch.from_numpy(batch["tokens"])),
           want)


@pytest.mark.parametrize("arch", ["llama3-8b", "whisper-large-v3"])
def test_prefill_step_is_the_forward_without_grad(arch):
    _, pcfg = configs(arch, "float32")
    rcfg, _ = configs(arch, "float32")
    tp = lm_params_from_numpy(reference_params(rcfg))
    batch = _t(numpy_batch(rcfg, 9))
    tp["embed"].requires_grad_(True)
    logits = make_prefill_step(pcfg)(tp, batch)
    assert not logits.requires_grad
    want = (forward_encdec(tp, pcfg, batch["frames"], batch["tokens"])
            if pcfg.is_encdec else forward_lm(tp, pcfg, batch["tokens"]))
    assert torch.equal(logits, want.detach())


@pytest.mark.parametrize("arch", ["llama3-8b", "internvl2-2b",
                                  "mixtral-8x22b", "mamba2-780m",
                                  "whisper-large-v3"])
def test_three_train_steps_match_reference_bf16(arch):
    run = train_both(arch, "bfloat16")
    np.testing.assert_allclose(run["port_losses"], run["ref_losses"],
                               rtol=BF16_LOSS_RTOL)
    check_moments(run["ref_opt"], run["port_opt"], BF16_MOMENT_RTOL)
    check_params(run["ref_params"], run["port_params"], 1e-4, 6 * LR,
                 BF16_PARAM_SHARE)


def test_demo_twin_trains_on_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_lm_substrate_demo", REPO / "examples/torch_lm_substrate_demo.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    losses = demo.demo("mamba2-780m", steps=2, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == [
        "  [mamba2-780m] train step 0", "  [mamba2-780m] train step 1",
        "  [mamba2-780m] greedy decode"]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
