"""The port's LM train step against the reference's, dense-FFN
architectures: llama3, qwen2.5, starcoder2, gemma3, internvl2 (vision
prefix) and whisper (encoder-decoder) at SMOKE, 3 ``make_train_step`` steps
from the reference's ``init_params`` on numpy batches, at
``compute_dtype="float32"``; and llama3 with ``num_microbatches=2``. The
MoE and SSM architectures are in ``test_torch_lm_train_sparse.py``.

Bounds (float32, ``torch_lm_parity.check_fp32_run``): each step's loss
within 1e-5 relative; each Adam moment leaf within 1e-4 of the tree's
largest moment; every parameter within lr / 3 and all but 0.5 % of a
model's parameters within 1e-6."""
import pytest

torch = pytest.importorskip("torch")

from torch_lm_parity import check_fp32_run, train_both  # noqa: E402

ARCHS = ["llama3-8b", "qwen2.5-3b", "starcoder2-3b", "gemma3-4b",
         "internvl2-2b", "whisper-large-v3"]


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference_fp32(arch):
    check_fp32_run(train_both(arch, "float32"))


def test_microbatched_train_steps_match_reference_fp32():
    """Two microbatches of one row: the fp32 gradient accumulators and the
    mean of the microbatch losses, as the reference's scan."""
    check_fp32_run(train_both("llama3-8b", "float32", num_microbatches=2))
