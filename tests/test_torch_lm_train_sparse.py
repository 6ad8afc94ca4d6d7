"""The port's LM train step against the reference's, MoE and SSM
architectures: mixtral (top-2 MoE, SWA), llama4-scout (top-1 MoE with a
shared expert, chunked attention), mamba2 (SSD) and jamba (SSD + attention
+ MoE) at SMOKE, 3 ``make_train_step`` steps from the reference's
``init_params`` on numpy batches at ``compute_dtype="float32"``, with the
bounds of ``test_torch_lm_train_dense.py``; and the selective ``"dots"``
checkpoint policy against the full one."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch_lm_parity import (check_fp32_run, configs, numpy_batch,  # noqa: E402
                             reference_params, train_both)
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.models.steps import _loss_and_grads  # noqa: E402

ARCHS = ["mixtral-8x22b", "llama4-scout-17b-a16e", "mamba2-780m",
         "jamba-v0.1-52b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference_fp32(arch):
    check_fp32_run(train_both(arch, "float32"))


@pytest.mark.parametrize("policy", ["dots", "none"])
def test_remat_policies_give_the_full_remat_gradient(policy):
    """jamba's gradient with the ``"dots"`` selective checkpoint, and with
    no checkpoint at all, is bitwise the gradient under ``"full"``."""
    rcfg, pcfg = configs("jamba-v0.1-52b", "float32")
    params = lm_params_from_numpy(reference_params(rcfg))
    batch = {k: torch.from_numpy(v) for k, v in numpy_batch(rcfg, 1).items()}
    other = (dataclasses.replace(pcfg, remat_policy="dots")
             if policy == "dots" else dataclasses.replace(pcfg, remat=False))
    loss_full, g_full = _loss_and_grads(params, pcfg, batch)
    loss, g = _loss_and_grads(params, other, batch)
    assert torch.equal(loss, loss_full)
    for a, b in zip(g, g_full):
        assert torch.equal(a, b)
