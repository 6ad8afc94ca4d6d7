"""Plain float32 GP arithmetic: the Matérn-3/2 kernel, pathwise targets,
kernel products in row blocks, the pathwise hyper-gradient and Adam.

Hyperparameters are raw (unconstrained) leaves ``[lengthscales (d,),
signal (), noise ()]`` with ``theta = softplus(raw)`` (paper App. B).
Inputs are scaled by sqrt(3) / lengthscale; kernel products take their
squared distances in the expanded form (exact on coincident rows). Every matrix product goes through :meth:`Arith.mm`: in
float32 with TF32 off, or, for the control, with both operands rounded to
TF32 (10 mantissa bits) as the tensor cores take them.
"""
from __future__ import annotations

import contextlib
import math

import torch

SQRT3 = math.sqrt(3.0)
R2_FLOOR = 1e-30
NORM_EPS = 1e-10
# Entries of one row block of a kernel matrix (512 MB of float32).
BLOCK_ENTRIES = 2**27
# Rows of one chunk of the RFF features (as wide as 2 x 1000 pairs).
FEATURE_ROWS = 4096


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10 mantissa bits, to nearest."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Arith:
    """Where the reference's products run: float32 (``lower=False``) or
    the control's TF32 (``lower=True``)."""

    def __init__(self, lower: bool = False):
        self.lower = lower

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.lower:
            return tf32(a) @ tf32(b)
        return a @ b

    @contextlib.contextmanager
    def flags(self):
        """TF32 off (float32) or on (control) for the block, restored after."""
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.lower
        torch.backends.cudnn.allow_tf32 = self.lower
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved


def softplus(nu: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(torch.zeros_like(nu), nu)


def constrained(raw: list) -> tuple:
    """(lengthscales, signal, noise) of raw leaves."""
    return softplus(raw[0]), softplus(raw[1]), softplus(raw[2])


def scaled(x: torch.Tensor, ell: torch.Tensor) -> torch.Tensor:
    """Inputs scaled by sqrt(3) / lengthscale, so that a squared distance
    between them is 3 r^2 and its root the Matérn-3/2 argument sqrt(3) r."""
    return x * (SQRT3 / ell)


def matern32(r2: torch.Tensor) -> torch.Tensor:
    """kappa = (1 + q) exp(-q), q = sqrt(3 r^2), in place on ``r2`` (3 r^2,
    floored as the program floors r^2 at 1e-30)."""
    q = r2.clamp_min_(3.0 * R2_FLOOR).sqrt_()
    e = q.neg().exp_()
    return e.addcmul_(q, e)


def sqdist(ua: torch.Tensor, ub: torch.Tensor) -> torch.Tensor:
    """(len(ua), len(ub)) squared distances by direct differences."""
    r2 = torch.zeros((ua.shape[0], ub.shape[0]), dtype=ua.dtype,
                     device=ua.device)
    for k in range(ua.shape[1]):
        r2.add_((ua[:, k, None] - ub[None, :, k]).square_())
    return r2


def sqdist_expanded(ua: torch.Tensor, ub: torch.Tensor, diag) -> torch.Tensor:
    """Squared distances as |a|^2 + |b|^2 - 2 a.b, one product of the rows
    ``[|a|^2, 1, -2a]`` and ``[1, |b|^2, b]``, clamped at 0: one pass over
    the block. Row r of ``ua`` is row r + ``diag`` of ``ub`` (None: no row
    of both), and those entries are set to exactly 0, as the direct
    differences give: elsewhere the form's absolute error, ~1e-7 |u|^2,
    moves the Matérn-3/2 profile (smooth in r^2) by ~1e-6, and it keeps
    every pair of rows far apart (the padding's phantom rows) far apart."""
    na = torch.sum(ua * ua, dim=1, keepdim=True)
    nb = torch.sum(ub * ub, dim=1, keepdim=True)
    r2 = torch.cat([na, torch.ones_like(na), -2.0 * ua], dim=1) @ \
        torch.cat([torch.ones_like(nb), nb, ub], dim=1).T
    r2.clamp_min_(0.0)
    if diag is not None:
        r2.diagonal(diag).zero_()
    return r2


def block_rows(cols: int) -> int:
    return max(1, BLOCK_ENTRIES // max(cols, 1))


def kernel_product(ar: Arith, ua: torch.Tensor, ub: torch.Tensor,
                   v: torch.Tensor, diag=None) -> torch.Tensor:
    """kappa(ua, ub) @ v for ``scaled`` inputs, in row blocks of ``ua``;
    ``diag`` as in :func:`sqdist_expanded`."""
    rows = block_rows(ub.shape[0])
    return torch.cat([
        ar.mm(matern32(sqdist_expanded(
            ua[i:i + rows], ub, None if diag is None else diag + i)), v)
        for i in range(0, ua.shape[0], rows)])


def h_product(ar: Arith, x: torch.Tensor, v: torch.Tensor, raw: list,
              rows: slice = slice(None)) -> torch.Tensor:
    """(H v)[rows] with H = s^2 K(x, x) + sigma^2 I."""
    ell, sig, noise = constrained(raw)
    u = scaled(x, ell)
    start = rows.start or 0
    return (sig * sig) * kernel_product(ar, u[rows], u, v, diag=start) \
        + (noise * noise) * v[rows]


def targets(ar: Arith, x: torch.Tensor, y: torch.Tensor, draws: dict,
            raw: list) -> torch.Tensor:
    """[y | f_1..f_s + sigma eps_1..eps_s] (n, 1 + s): RFF prior samples
    of the Matérn-3/2 kernel (Student-t spectrum, 3 degrees of freedom)
    from the fixed base draws ``z`` (m, d), ``u`` (m,), ``w`` (2m, s) and
    ``w_eps`` (n, s)."""
    ell, sig, noise = constrained(raw)
    z, u, w = draws["z"], draws["u"], draws["w"]
    omega = z * torch.sqrt(3.0 / u)[:, None] / ell
    amp = sig * math.sqrt(1.0 / z.shape[0])
    f = []
    for i in range(0, x.shape[0], FEATURE_ROWS):
        proj = ar.mm(x[i:i + FEATURE_ROWS], omega.T)
        f.append(ar.mm(amp * torch.cat([torch.cos(proj), torch.sin(proj)],
                                       dim=1), w))
    b = torch.cat(f) + noise * draws["w_eps"]
    return torch.cat([y[:, None], b], dim=1)


def pathwise_weights(t: int, dtype, device) -> torch.Tensor:
    """c = [1/2, -1/(2s), ..., -1/(2s)] of the surrogate (paper eq. 5)."""
    s = t - 1
    c = torch.full((t,), -0.5 / s, dtype=dtype, device=device)
    c[0] = 0.5
    return c


def grad(ar: Arith, x: torch.Tensor, v: torch.Tensor, raw: list,
         real: int = None) -> list:
    """Gradient of the pathwise surrogate ``S = sum_t c_t v_t^T H v_t``
    with respect to the raw leaves, the solutions ``v`` held fixed.

    With ``W = (V c) V^T``: ``dS/ds = 2 s sum W kappa``, ``dS/dl_k =
    -(2 s^2 / l_k) sum_ij W kappa'(r^2) (x_ik - x_jk)^2 / l_k^2``
    (``kappa'(r^2) = -1.5 exp(-sqrt(3) r)``), ``dS/dsigma = 2 sigma sum_t
    c_t |v_t|^2``, each times softplus' = sigmoid(raw). With ``A = W
    exp(-sqrt(3) r)`` and ``w = x / l``, the sum over pairs is ``sum_i
    (w_ik^2 (A 1)_i - 2 w_ik (A w_k)_i + (A w_k^2)_i)``, one float64 product
    per row block. Rows from ``real`` on (the padding's phantom rows, whose
    kernel against every other row is 0 and whose own difference is 0) add
    nothing to it and are left out of it. Sums are accumulated in float64.
    """
    ell, sig, noise = constrained(raw)
    n, d = x.shape
    real = n if real is None else real
    u = scaled(x, ell)
    w = (x[:real] / ell).double()
    w2 = torch.cat([w, w * w], dim=1)
    c = pathwise_weights(v.shape[1], v.dtype, v.device)
    vc = v * c
    acc_k = torch.zeros((), dtype=torch.float64, device=x.device)
    acc_l = torch.zeros((d,), dtype=torch.float64, device=x.device)
    rows = block_rows(n)
    for i in range(0, n, rows):
        a = ar.mm(vc[i:i + rows], v.T)
        q = sqdist_expanded(u[i:i + rows], u, i).clamp_min_(
            3.0 * R2_FLOOR).sqrt_()
        a.mul_(q.neg().exp_())
        acc_k += torch.sum(a, dtype=torch.float64) \
            + torch.sum(q.mul_(a), dtype=torch.float64)
        del q
        if i < real:
            ar_ = a[:real - i, :real].double()
            m = ar_ @ w2
            wi = w[i:i + ar_.shape[0]]
            acc_l += torch.sum(wi * wi * torch.sum(ar_, dim=1, keepdim=True)
                               - 2.0 * wi * m[:, :d] + m[:, d:], dim=0)
    sig64, ell64 = sig.double(), ell.double()
    noise64 = noise.double()
    g_sig = 2.0 * sig64 * acc_k
    g_ell = -(2.0 * sig64 * sig64 / ell64) * (-1.5 * acc_l)
    g_noise = 2.0 * noise64 * torch.sum(
        c.double() * torch.sum(v.double() ** 2, dim=0))
    return [(g * torch.sigmoid(p.double())).float()
            for g, p in zip((g_ell, g_sig, g_noise), raw)]


def adam(raw: list, mu: list, nu: list, step: int, g: list, lr: float,
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> tuple:
    """One Adam ascent step on the raw leaves (Kingma & Ba); returns
    (raw, mu, nu) after it."""
    t = torch.tensor(float(step + 1), dtype=torch.float32)
    b1t = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
    b2t = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)
    out = ([], [], [])
    for p, m, s, gi in zip(raw, mu, nu, g):
        gi = -gi
        m = b1 * m + (1.0 - b1) * gi
        s = b2 * s + (1.0 - b2) * gi * gi
        out[0].append(p - lr * (m / b1t) / (torch.sqrt(s / b2t) + eps))
        out[1].append(m)
        out[2].append(s)
    return out


def residuals(ar: Arith, x: torch.Tensor, b: torch.Tensor, v: torch.Tensor,
              raw: list, rows: int) -> tuple:
    """Over the first ``rows`` rows: |b_j - (H v)_j| / |b_j| per column, and
    |B - H V|_F / |B|_F."""
    r = (b[:rows] - h_product(ar, x, v, raw, slice(0, rows))).double()
    b = b[:rows].double()
    cols = torch.linalg.vector_norm(r, dim=0) / torch.linalg.vector_norm(b, dim=0)
    return cols, float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))
