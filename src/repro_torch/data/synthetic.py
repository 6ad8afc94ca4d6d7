"""GP-regression datasets at the UCI (n, d) signatures of the paper.

Port of ``repro.data.synthetic``. A real UCI CSV in ``data/uci/<name>.csv``
(last column = target) takes precedence; otherwise targets are drawn from an
RFF Matérn-3/2 prior sample at the dataset's exact shape, from a seeded
``torch.Generator`` (the numbers differ from the reference's JAX draws).
Inputs and targets are z-scored on a deterministic 90/10 split.
``make_lm_batch`` draws the LM substrate's synthetic token batches.
"""
from __future__ import annotations

import os
import zlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.gp.hyperparams import HyperParams
from repro_torch.gp.rff import init_rff, prior_sample_at

# Paper datasets: name -> (n, d)  [Appendix B]
UCI_SHAPES = {
    "pol": (13_500, 26),
    "elevators": (14_940, 18),
    "bike": (15_642, 17),
    "protein": (41_157, 9),
    "keggdirected": (43_945, 20),
    "3droad": (391_387, 3),
    "song": (463_811, 90),
    "buzz": (524_925, 77),
    "houseelectric": (1_844_352, 11),
}


class Dataset(NamedTuple):
    """Train/test split of one dataset (tensors on the requested device)."""

    x_train: torch.Tensor
    y_train: torch.Tensor
    x_test: torch.Tensor
    y_test: torch.Tensor
    name: str = "synthetic"


def make_gp_regression(
    generator: Optional[torch.Generator],
    n: int,
    d: int,
    noise: float = 0.1,
    lengthscale: Optional[float] = None,
    num_features: int = 512,
    dtype=torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw (x, y) on the CPU with y an RFF Matérn-3/2 prior sample + noise.

    The default lengthscale grows with sqrt(d) so the latent function has
    learnable structure at any input dimension. The sample is evaluated in
    row chunks (:func:`repro_torch.gp.rff.prior_sample_at`), so the draw
    holds O(n d) host memory at the paper's 1.8 M rows, not n x 1024
    features.
    """
    if lengthscale is None:
        lengthscale = 1.6 * float(d) ** 0.5
    x = torch.rand((n, d), generator=generator, dtype=dtype) * 4.0 - 2.0
    params = HyperParams.create(d, lengthscale=lengthscale, signal=1.0,
                                noise=noise, dtype=dtype)
    rff = init_rff(generator, num_features, d, 1, dtype=dtype)
    f = prior_sample_at(x, rff, params)[:, 0]
    y = f + noise * torch.randn((n,), generator=generator, dtype=dtype)
    return x, y


def standardise(train: np.ndarray, *others: np.ndarray):
    """z-score every array by the train split's mean and std."""
    mu = train.mean(axis=0, keepdims=True)
    sd = train.std(axis=0, keepdims=True) + 1e-8
    return tuple((a - mu) / sd for a in (train, *others))


def load_dataset(
    name: str,
    seed: Optional[int] = None,
    split: int = 0,
    train_frac: float = 0.9,
    max_n: Optional[int] = None,
    uci_dir: str = "data/uci",
    dtype=torch.float32,
    device="cuda",
) -> Dataset:
    """Load ``name`` (UCI CSV if present, else synthetic at the UCI shape).

    ``split`` selects one of the deterministic shuffles; ``max_n`` (0 or
    None = no cap) truncates the rows. ``seed`` defaults to a CRC of the
    name, so every process draws the same data.
    """
    dev = resolve_device(device)
    if name not in UCI_SHAPES:
        raise KeyError(f"unknown dataset {name!r}; options: {sorted(UCI_SHAPES)}")
    n, d = UCI_SHAPES[name]
    csv = os.path.join(uci_dir, f"{name}.csv")
    if os.path.exists(csv):
        xy = np.loadtxt(csv, delimiter=",", skiprows=1)
    else:
        if seed is None:
            seed = zlib.crc32(name.encode()) % (2**31)
        gen = torch.Generator().manual_seed(seed)
        x, y = make_gp_regression(gen, min(n, max_n) if max_n else n, d,
                                  dtype=dtype)
        xy = np.concatenate([x.numpy(), y.numpy()[:, None]], axis=1)
    if max_n:
        xy = xy[:max_n]
    rng = np.random.RandomState(1000 + split)
    xy = xy[rng.permutation(xy.shape[0])]
    n_train = int(train_frac * xy.shape[0])
    xtr, xte = standardise(xy[:n_train, :-1], xy[n_train:, :-1])
    ytr, yte = standardise(xy[:n_train, -1:], xy[n_train:, -1:])

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    return Dataset(x_train=put(xtr), y_train=put(ytr[:, 0]),
                   x_test=put(xte), y_test=put(yte[:, 0]), name=name)


def pad_to_block_multiple(x: torch.Tensor, y: torch.Tensor, block: int,
                          far: float = 1e6
                          ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Pad (x, y) so n is a multiple of ``block``; returns
    (x_pad, y_pad, n_real), on ``x``'s device.

    Phantom points sit at ``far * (1 + k)`` in every coordinate with y = 0,
    so their kernel against every other point is exactly zero: H is block
    diagonal between the real and phantom sets, and the real rows' solution
    does not see them (the reference's padding).
    """
    n, d = x.shape
    rem = (-n) % block
    if rem == 0:
        return x, y, n
    offsets = far * (1.0 + torch.arange(rem, dtype=x.dtype, device=x.device))
    x_pad = torch.cat([x, offsets[:, None].expand(rem, d)])
    y_pad = torch.cat([y, torch.zeros((rem,), dtype=y.dtype, device=y.device)])
    return x_pad, y_pad, n


def make_lm_batch(generator: torch.Generator, batch: int, seq_len: int,
                  vocab: int, device="cuda") -> dict:
    """Synthetic LM token batch: inputs + next-token labels + mask.

    Tokens are drawn uniformly from ``[0, vocab)`` on ``generator``'s device
    and placed on ``device`` (int64, the port's index type; the model also
    takes the reference's int32 ids).
    """
    dev = resolve_device(device)
    tokens = torch.randint(0, vocab, (batch, seq_len + 1), generator=generator,
                           device=generator.device, dtype=torch.int64).to(dev)
    return {
        "tokens": tokens[:, :-1],
        "labels": tokens[:, 1:],
        "mask": torch.ones((batch, seq_len), dtype=torch.float32, device=dev),
    }
