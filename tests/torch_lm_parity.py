"""Shared set-up of the LM substrate's parity tests (``test_torch_lm_*.py``):
the reference's SMOKE params handed over as numpy, batches drawn with numpy
from a seed, a few train steps through both packages, and the reference's
jitted serve step."""
import dataclasses
import functools

import jax
import numpy as np
import torch

from repro.configs import SMOKE_SHAPES
from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init_params
from repro.models import make_serve_step as j_make_serve_step
from repro.models import make_train_step as j_make_train_step
from repro.train.adam import adam_init as j_adam_init
from repro_torch.configs import get_config
from repro_torch.interop import (lm_adam_to_numpy, lm_params_from_numpy,
                                 lm_params_to_numpy)
from repro_torch.models import make_train_step
from repro_torch.train.adam import adam_init

# Adam's first steps move an element by about +-lr whatever its gradient's
# size, so an element whose gradient is at rounding level (a top-1 router,
# a token's rare embedding entry) can move differently in the two packages;
# its bound is lr / 3 of the 3 steps' 3 lr. Every other element is held to
# PARAM_TIGHT_ATOL, and at most PARAM_LOOSE_SHARE of a model's elements may
# use the looser bound.
LR = 3e-4  # make_train_step's default Adam learning rate
PARAM_LOOSE_ATOL = LR / 3
PARAM_TIGHT_ATOL = 1e-6
PARAM_LOOSE_SHARE = 5e-3
# float32 train steps: each step's loss relative, and each Adam moment leaf
# against the tree's largest moment.
LOSS_RTOL = 1e-5
MOMENT_RTOL = 1e-4


def configs(arch: str, compute: str, **over):
    """(reference SMOKE config, port SMOKE config), both with ``compute``
    as the compute dtype and the same overrides."""
    ref = dataclasses.replace(j_get_config(arch, smoke=True),
                              compute_dtype=compute, **over)
    port = dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype=compute, **over)
    return ref, port


def reference_params(cfg, seed: int = 0) -> dict:
    """The reference's ``init_params`` as a numpy tree (drawn once per
    config and seed in a process: the draw takes seconds; the compute dtype
    does not enter it)."""
    return _reference_params(
        dataclasses.replace(cfg, compute_dtype="float32"), seed)


@functools.lru_cache(maxsize=None)
def _reference_params(cfg, seed: int) -> dict:
    return jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(seed),
                                                  cfg))


@functools.lru_cache(maxsize=None)
def reference_serve_step(cfg):
    """The reference's ``jax.jit(make_serve_step(cfg))``, one per config in
    a process (its compiles are cached by shape)."""
    return jax.jit(j_make_serve_step(cfg))


def numpy_batch(cfg, seed: int, rows: int = None, seq: int = None) -> dict:
    """A train batch of the reference's ``input_specs`` layout at
    ``SMOKE_SHAPES["train_4k"]`` (tokens, labels and mask; whisper's frames
    cut to the decoder length, internvl2's patch prefix), from numpy."""
    shape = SMOKE_SHAPES["train_4k"]
    b, s = rows or shape.global_batch, seq or shape.seq_len
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        sd = cfg.decoder_len
        tokens = rng.integers(0, cfg.vocab_size, (b, sd + 1), dtype=np.int32)
        return {"frames": rng.normal(size=(b, s, cfg.d_model))
                .astype(np.float32) * 0.3,
                "tokens": tokens[:, :-1], "labels": tokens[:, 1:],
                "mask": np.ones((b, sd), np.float32)}
    st = s - cfg.frontend.num_prefix if cfg.frontend.kind == "vision" else s
    tokens = rng.integers(0, cfg.vocab_size, (b, st + 1), dtype=np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "mask": np.ones((b, st), np.float32)}
    if cfg.frontend.kind == "vision":
        batch["patch_embeds"] = rng.normal(
            size=(b, cfg.frontend.num_prefix, cfg.frontend.embed_dim)
        ).astype(np.float32) * 0.3
    return batch


def train_both(arch: str, compute: str, steps: int = 3,
               num_microbatches: int = 1, seed: int = 0, **over) -> dict:
    """``steps`` train steps of the reference and of the port from the same
    params on the same batches (one per step); losses, params and Adam
    states of both as numpy."""
    rcfg, pcfg = configs(arch, compute, **over)
    p0 = reference_params(rcfg, seed)
    batches = [numpy_batch(rcfg, seed + 1 + i) for i in range(steps)]

    j_step = jax.jit(j_make_train_step(rcfg, num_microbatches=num_microbatches))
    jp = jax.tree.map(np.asarray, p0)
    jopt = j_adam_init(jp)
    t_step = make_train_step(pcfg, num_microbatches=num_microbatches)
    tp = lm_params_from_numpy(p0)
    topt = adam_init(tp)
    ref_losses, port_losses = [], []
    for batch in batches:
        jp, jopt, loss = j_step(jp, jopt, batch)
        ref_losses.append(float(loss))
        tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
        tp, topt, tloss = t_step(tp, topt, tb)
        port_losses.append(float(tloss))
    ref_opt = {"step": np.asarray(jopt.step),
               "mu": jax.tree.map(np.asarray, jopt.mu),
               "nu": jax.tree.map(np.asarray, jopt.nu)}
    return {"ref_losses": ref_losses, "port_losses": port_losses,
            "p0": p0, "ref_params": jax.tree.map(np.asarray, jp),
            "port_params": lm_params_to_numpy(tp), "ref_opt": ref_opt,
            "port_opt": lm_adam_to_numpy(topt)}


def leaves_with_paths(tree: dict, prefix: str = "") -> list:
    """(path, array) pairs of a numpy tree, keys sorted at every level."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        path = f"{prefix}/{key}"
        out.extend(leaves_with_paths(value, path) if isinstance(value, dict)
                   else [(path, value)])
    return out


def check_params(ref: dict, got: dict, tight: float, loose: float,
                 loose_share: float) -> None:
    """Every leaf of ``got`` within ``loose`` of ``ref`` elementwise, and
    all but ``loose_share`` of the model's elements within ``tight``."""
    r, g = leaves_with_paths(ref), leaves_with_paths(got)
    assert [p for p, _ in r] == [p for p, _ in g]
    beyond, total = 0, 0
    for (path, a), (_, b) in zip(r, g):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        err = np.abs(a.astype(np.float64) - b.astype(np.float64))
        assert err.max() <= loose, (path, float(err.max()))
        beyond += int((err > tight).sum())
        total += err.size
    assert beyond <= loose_share * total, (beyond, total)


def check_moments(ref_opt: dict, got_opt: dict, rtol: float) -> None:
    """Adam's step count equal, and each moment leaf within ``rtol`` of the
    largest moment of the whole tree (a leaf whose gradient is rounding
    noise, such as a top-1 router's, is held to the tree's scale)."""
    assert int(got_opt["step"]) == int(ref_opt["step"])
    for name in ("mu", "nu"):
        r = leaves_with_paths(ref_opt[name])
        g = leaves_with_paths(got_opt[name])
        scale = max(float(np.abs(a).max()) for _, a in r)
        for (path, a), (_, b) in zip(r, g):
            err = float(np.abs(a - b).max())
            assert err <= rtol * scale, (name, path, err, scale)


def check_fp32_run(run: dict) -> None:
    """A float32 :func:`train_both` run: the losses within ``LOSS_RTOL``,
    the moments within ``MOMENT_RTOL``, the params as
    :func:`check_params` with the module's bounds."""
    np.testing.assert_allclose(run["port_losses"], run["ref_losses"],
                               rtol=LOSS_RTOL)
    assert np.all(np.isfinite(run["port_losses"]))
    check_moments(run["ref_opt"], run["port_opt"], MOMENT_RTOL)
    check_params(run["ref_params"], run["port_params"], PARAM_TIGHT_ATOL,
                 PARAM_LOOSE_ATOL, PARAM_LOOSE_SHARE)
