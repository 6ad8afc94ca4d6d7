"""GP hyperparameters with softplus reparameterisation (paper Appendix B).

Port of ``repro.gp.hyperparams``: each positive hyperparameter is stored as
an unconstrained raw value ``nu`` with ``theta = softplus(nu)``; the kernel
name rides along as a plain (non-tensor) field.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch


def softplus(nu: torch.Tensor) -> torch.Tensor:
    """Numerically stable log(1 + exp(nu)) (``logaddexp(0, nu)``)."""
    return torch.logaddexp(torch.zeros_like(nu), nu)


def softplus_inverse(theta: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`softplus`: nu = log(exp(theta) - 1), stable form."""
    theta = torch.as_tensor(theta)
    small = theta < 20.0
    safe = torch.where(small, theta, torch.ones_like(theta))
    return torch.where(
        small, torch.log(torch.expm1(safe)),
        theta + torch.log1p(-torch.exp(-theta)),
    )


class HyperParams(NamedTuple):
    """Unconstrained GP hyperparameters (raw tensors + static kernel name).

    Attributes:
      raw_lengthscales: shape (d,), one per input dimension.
      raw_signal: scalar signal scale (sqrt of kernel variance).
      raw_noise: scalar observation noise scale sigma.
      kernel: registered kernel name; the default ``kind`` everywhere.
    """

    raw_lengthscales: torch.Tensor
    raw_signal: torch.Tensor
    raw_noise: torch.Tensor
    kernel: str = "matern32"

    @property
    def lengthscales(self) -> torch.Tensor:
        """Constrained per-dimension lengthscales."""
        return softplus(self.raw_lengthscales)

    @property
    def signal(self) -> torch.Tensor:
        """Constrained signal scale."""
        return softplus(self.raw_signal)

    @property
    def noise(self) -> torch.Tensor:
        """Constrained noise scale sigma."""
        return softplus(self.raw_noise)

    @property
    def num_params(self) -> int:
        """The number of hyperparameters of one system: d lengthscales,
        signal and noise (a lane-stacked set counts one lane's)."""
        return int(self.raw_lengthscales.shape[-1]) + 2

    def constrained(self) -> dict:
        """The constrained hyperparameters by name (lane-stacked sets keep
        their leading B axis)."""
        return {
            "lengthscales": self.lengthscales,
            "signal": self.signal,
            "noise": self.noise,
        }

    @property
    def leaves(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The three raw tensors, in pytree-leaf order of the reference."""
        return (self.raw_lengthscales, self.raw_signal, self.raw_noise)

    def with_leaves(self, leaves) -> "HyperParams":
        """A copy holding ``leaves`` (same order as :attr:`leaves`)."""
        return HyperParams(*leaves, kernel=self.kernel)

    @staticmethod
    def create(
        d: int,
        lengthscale: float = 1.0,
        signal: float = 1.0,
        noise: float = 1.0,
        dtype=torch.float32,
        kernel: str = "matern32",
        device: Union[str, torch.device] = "cpu",
    ) -> "HyperParams":
        """Constrained-space constructor (paper initialises at 1.0)."""
        def raw(val, shape=()):
            return softplus_inverse(
                torch.full(shape, val, dtype=dtype, device=device))

        return HyperParams(
            raw_lengthscales=raw(lengthscale, (d,)),
            raw_signal=raw(signal),
            raw_noise=raw(noise),
            kernel=kernel,
        )

    def flat(self) -> torch.Tensor:
        """All constrained hyperparameters as one vector (for logging);
        (B, d + 2) for lane-stacked leaves."""
        return torch.cat(
            [self.lengthscales, self.signal[..., None], self.noise[..., None]],
            dim=-1)

    @property
    def lanes(self) -> Optional[int]:
        """The lane count of lane-stacked leaves ((B,) signal), or None for
        one system's (scalar signal)."""
        return self.raw_signal.shape[0] if self.raw_signal.ndim else None

    def lane(self, index: int) -> "HyperParams":
        """Lane ``index`` of lane-stacked leaves as one system's."""
        return self.with_leaves([p[index] for p in self.leaves])

    def lifted(self) -> "HyperParams":
        """Lane-stacked leaves: these with B = 1 when they are one system's."""
        if self.lanes is not None:
            return self
        return self.with_leaves([p[None] for p in self.leaves])


def stack_params(params: list) -> HyperParams:
    """Stack one-system `HyperParams` (one kernel name) on a lane axis."""
    kernels = {p.kernel for p in params}
    if len(kernels) != 1:
        raise ValueError(f"lanes must share one kernel, got {sorted(kernels)}")
    return params[0].with_leaves(
        [torch.stack(leaves) for leaves in zip(*(p.leaves for p in params))])


def resolve_kind(kind: Optional[str], params: HyperParams) -> str:
    """The effective kernel name: an explicit ``kind`` wins over the params'."""
    return kind if kind is not None else params.kernel
