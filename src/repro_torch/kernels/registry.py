"""Registry of stationary kernel profiles shared by every MVM backend.

Port of ``repro.kernels.registry``. Each :class:`KernelSpec` bundles the
unit profile ``kappa(r^2)`` of the lengthscale-scaled squared distance, its
derivative ``dkappa/dr^2``, and the spectral mixture sampler behind RFF
prior draws (Matérn-nu spectra are Student-t with 2*nu degrees of freedom:
``omega = z * sqrt(2 nu / u)`` with ``u ~ chi^2_{2 nu}``; RBF has ``u = 1``).

The sqrt floor is applied as ``maximum(r2, floor)`` (never ``r2 + floor``)
so autograd sees an exactly-zero derivative below it; Matérn-1/2 uses the
larger floor and its ``dkappa`` is exactly zero on the clamped region.
The CUDA kernels (``csrc/kernel_mvm.cu``, ``csrc/kernel_mvm_bwd.cu``)
evaluate the same formulas and floors; ``KIND_CODES`` is the integer they
take for each name.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

SQRT3 = 1.7320508075688772
SQRT5 = 2.23606797749979

_R2_FLOOR = 1e-30
_R2_FLOOR_M12 = 1e-12


class KernelSpec(NamedTuple):
    """One stationary kernel's contribution to every compute backend.

    Attributes:
      name: registry key (e.g. ``"matern32"``).
      nu: Matérn smoothness, or None for RBF.
      kappa_from_r2: unit profile ``kappa(r2)`` with ``kappa(0) = 1``.
      dkappa_dr2: ``d kappa / d r2``.
      mixture_sample: ``(generator, num_pairs, dtype, device) -> u`` base
        mixture draws of shape (num_pairs,).
      mixture_scale: ``u -> per-frequency scale`` of the normal directions.
    """

    name: str
    nu: Optional[float]
    kappa_from_r2: Callable[[torch.Tensor], torch.Tensor]
    dkappa_dr2: Callable[[torch.Tensor], torch.Tensor]
    mixture_sample: Callable[..., torch.Tensor]
    mixture_scale: Callable[[torch.Tensor], torch.Tensor]


KERNELS: dict[str, KernelSpec] = {}

# Integer kind the CUDA kernels switch on (csrc/*.cu, enum Kind).
KIND_CODES = {"rbf": 0, "matern12": 1, "matern32": 2, "matern52": 3}


def register_kernel(spec: KernelSpec) -> KernelSpec:
    """Register (or override) a kernel for all backends; returns the spec."""
    KERNELS[spec.name] = spec
    return spec


def get_kernel(name: str) -> KernelSpec:
    """The registered spec for ``name``; raises ValueError listing names."""
    try:
        return KERNELS[name]
    except KeyError:
        raise ValueError(
            f"unknown kernel {name!r}; registered: {sorted(KERNELS)}"
        ) from None


def available_kernels() -> tuple[str, ...]:
    """The registered kernel names, sorted."""
    return tuple(sorted(KERNELS))


# -- profiles ---------------------------------------------------------------


def _floored_sqrt(r2: torch.Tensor, floor: float) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(r2, floor))


def _rbf_kappa(r2):
    return torch.exp(-0.5 * r2)


def _rbf_dkappa(r2):
    return -0.5 * torch.exp(-0.5 * r2)


def _m12_kappa(r2):
    return torch.exp(-_floored_sqrt(r2, _R2_FLOOR_M12))


def _m12_dkappa(r2):
    """Matérn-1/2 slope, exactly zero on the clamped region (r2 <= floor)."""
    r = _floored_sqrt(r2, _R2_FLOOR_M12)
    slope = -torch.exp(-r) / (2.0 * r)
    return torch.where(r2 > _R2_FLOOR_M12, slope, torch.zeros_like(slope))


def _m32_kappa(r2):
    r = _floored_sqrt(r2, _R2_FLOOR)
    return (1.0 + SQRT3 * r) * torch.exp(-SQRT3 * r)


def _m32_dkappa(r2):
    r = _floored_sqrt(r2, _R2_FLOOR)
    return -1.5 * torch.exp(-SQRT3 * r)


def _m52_kappa(r2):
    r = _floored_sqrt(r2, _R2_FLOOR)
    return (1.0 + SQRT5 * r + (5.0 / 3.0) * r2) * torch.exp(-SQRT5 * r)


def _m52_dkappa(r2):
    r = _floored_sqrt(r2, _R2_FLOOR)
    return -(5.0 / 6.0) * (1.0 + SQRT5 * r) * torch.exp(-SQRT5 * r)


# -- spectral mixtures ------------------------------------------------------


def _ones_sample(generator, num_pairs, dtype=torch.float32, device="cpu"):
    return torch.ones((num_pairs,), dtype=dtype, device=device)


def _chi2_sample(dof: float):
    # chi^2_k = 2 * Gamma(shape=k/2, scale=1)
    def sample(generator, num_pairs, dtype=torch.float32, device="cpu"):
        conc = torch.full((num_pairs,), dof / 2.0, dtype=dtype, device=device)
        return 2.0 * torch._standard_gamma(conc, generator=generator)

    return sample


def _chi2_1_sample_stratified(generator, num_pairs, dtype=torch.float32,
                              device="cpu"):
    """Stratified chi^2_1 draws: one jittered inverse-CDF draw per stratum.

    The Cauchy spectrum of Matérn-1/2 has a tail that iid draws cover
    poorly at practical feature counts; ``u = Phi^{-1}((1+p)/2)^2`` with
    one ``p`` per probability bin covers it by construction.
    """
    jitter = torch.rand((num_pairs,), generator=generator, dtype=dtype,
                        device=device)
    p = (torch.arange(num_pairs, dtype=dtype, device=device) + jitter) / num_pairs
    epsneg = torch.finfo(dtype).eps / 2.0
    q = torch.clamp_max((1.0 + p) / 2.0, 1.0 - epsneg)
    z = torch.special.ndtri(q)
    return torch.clamp_min(z * z, torch.finfo(dtype).tiny)


def _student_scale(dof: float):
    def scale(u):
        return torch.sqrt(dof / u)

    return scale


register_kernel(KernelSpec(
    name="rbf",
    nu=None,
    kappa_from_r2=_rbf_kappa,
    dkappa_dr2=_rbf_dkappa,
    mixture_sample=_ones_sample,
    mixture_scale=lambda u: torch.ones_like(u),
))

register_kernel(KernelSpec(
    name="matern12",
    nu=0.5,
    kappa_from_r2=_m12_kappa,
    dkappa_dr2=_m12_dkappa,
    mixture_sample=_chi2_1_sample_stratified,
    mixture_scale=_student_scale(1.0),
))

register_kernel(KernelSpec(
    name="matern32",
    nu=1.5,
    kappa_from_r2=_m32_kappa,
    dkappa_dr2=_m32_dkappa,
    mixture_sample=_chi2_sample(3.0),
    mixture_scale=_student_scale(3.0),
))

register_kernel(KernelSpec(
    name="matern52",
    nu=2.5,
    kappa_from_r2=_m52_kappa,
    dkappa_dr2=_m52_dkappa,
    mixture_sample=_chi2_sample(5.0),
    mixture_scale=_student_scale(5.0),
))
