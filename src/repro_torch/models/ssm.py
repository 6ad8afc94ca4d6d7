"""Mamba2 / SSD (state-space duality) block — arXiv:2405.21060; port of
``repro.models.ssm``.

The SSD *chunked* path: within a chunk the recurrence becomes dense
(masked) matmuls; across chunks a short loop carries the (heads, head_dim,
d_state) state. The reference's three-operand einsums are written as
pairwise products, in an order that never forms a (B, NC, T, S, H, P)
tensor: at mamba2-780m's widths (chunk 256, 48 heads, head_dim 64) the
largest intermediate is the (B, NC, T, S, H) decay, 0.2 GB per sequence of
4096.

One difference from the reference: the intra-chunk decay takes ``exp`` of
the masked segment sums (``exp(where(causal, seg, -inf))``) instead of
masking ``exp(seg)``. The values are the same; the reference's gradient
becomes NaN once an above-diagonal ``seg`` overflows ``exp`` (0 * inf),
which full-width chunks reach, while the port's stays finite.

Decode is the O(1) recurrence: h' = h * exp(dt*A) + dt * (B outer x);
y = C . h + D*x, plus a rolling depthwise-conv state.

Single B/C group (n_groups=1), following mamba2-780m.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _to_compute


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    """in_proj output -> (z, xbc, dt) with xbc = [x | B | C]."""
    ssm = cfg.ssm
    d_in = ssm.d_inner(cfg.d_model)
    nh = ssm.num_heads(cfg.d_model)
    conv_dim = d_in + 2 * ssm.d_state
    z, xbc, dt = torch.split(proj, [d_in, conv_dim, proj.shape[-1] - d_in
                                    - conv_dim], dim=-1)
    assert dt.shape[-1] == nh
    return z, xbc, dt


def _ssd_chunked(x, dt, a, bmat, cmat, chunk):
    """SSD scan over chunks.

    x: (B,L,H,P); dt: (B,L,H); a: (H,) negative; bmat/cmat: (B,L,N).
    Returns y: (B,L,H,P).
    """
    b, l, h, p = x.shape
    n = bmat.shape[-1]
    q = min(chunk, l)
    assert l % q == 0, f"seq {l} % chunk {q} != 0"
    nc = l // q

    xd = x * dt[..., None]  # fold dt into inputs (B,L,H,P)
    la = dt * a  # (B,L,H) log-decay per step (negative)

    xc = xd.reshape(b, nc, q, h, p)
    lac = la.reshape(b, nc, q, h)
    bc = bmat.reshape(b, nc, q, n)
    cc = cmat.reshape(b, nc, q, n)

    cum = torch.cumsum(lac, dim=2)  # (B,NC,Q,H) inclusive
    total = cum[:, :, -1, :]  # (B,NC,H)

    # Intra-chunk: Y[t] += sum_{s<=t} C_t.B_s exp(cum_t - cum_s) xd_s
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,NC,T,S,H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                                  torch.tensor(float("-inf"),
                                               device=x.device)))
    scores = torch.matmul(cc, bc.transpose(-1, -2))  # (B,NC,T,S)
    # "bcts,bctsh,bcshp->bcthp" as (scores * decay) then a product over s
    # per (b, c, h): (T,S) @ (S,P).
    m = (scores[..., None] * decay.to(scores.dtype)).permute(0, 1, 4, 2, 3)
    y_intra = torch.matmul(m, xc.to(scores.dtype).permute(0, 1, 3, 2, 4))
    y_intra = y_intra.permute(0, 1, 3, 2, 4)  # (B,NC,T,H,P)

    # Chunk summary state: S_c = sum_s exp(total - cum_s) B_s (x) xd_s
    decay_out = torch.exp(total[:, :, None, :] - cum)  # (B,NC,Q,H)
    # "bcsn,bcsh,bcshp->bchpn" as (decay_out * x) then, per (b, c), a
    # product over s: (H*P, S) @ (S, N).
    xw = decay_out.to(bc.dtype)[..., None] * xc.to(bc.dtype)  # (B,NC,S,H,P)
    s_chunk = torch.matmul(xw.reshape(b, nc, q, h * p).transpose(-1, -2), bc)
    s_chunk = s_chunk.reshape(b, nc, h, p, n)  # (B,NC,H,P,N)

    # Inter-chunk recurrence: H_{c+1} = H_c * exp(total_c) + S_c
    hstate = torch.zeros((b, h, p, n), dtype=s_chunk.dtype, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(hstate)  # state entering this chunk
        hstate = hstate * torch.exp(total[:, c])[:, :, None, None] \
            + s_chunk[:, c]
    h_enter = torch.stack(entering, dim=1)  # (B,NC,H,P,N)

    # Inter-chunk output: Y[t] += C_t . (exp(cum_t) * H_enter), as
    # exp(cum_t) * (C_t . H_enter) per (b, c, h): (T,N) @ (N,P).
    ch = torch.matmul(cc.to(h_enter.dtype)[:, :, None],
                      h_enter.transpose(-1, -2))  # (B,NC,H,T,P)
    y_inter = torch.exp(cum).to(cc.dtype)[..., None] * ch.permute(0, 1, 3, 2, 4)
    return (y_intra + y_inter).reshape(b, l, h, p)


def mamba_train(params: dict, x: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """Full-sequence Mamba2 block. x: (B, L, D) -> (B, L, D)."""
    ssm = cfg.ssm
    b, l, d = x.shape
    d_in = ssm.d_inner(d)
    nh = ssm.num_heads(d)
    hd = ssm.head_dim
    n = ssm.d_state
    xc = _to_compute(x, cfg)

    def w(name):
        return params[name].to(xc.dtype)

    proj = xc @ w("in_proj")  # (B,L, 2*d_in + 2N + NH)
    z, xbc, dt_raw = _split_proj(proj, cfg)

    # Depthwise causal conv over the (x|B|C) streams, width W.
    wt = params["conv_w"].to(xc.dtype)  # (W, conv_dim)
    width = wt.shape[0]
    pads = F.pad(xbc, (0, 0, width - 1, 0))
    conv = sum(pads[:, i: i + l, :] * wt[i][None, None, :]
               for i in range(width))
    xbc = F.silu(conv + params["conv_b"].to(xc.dtype))

    xs, bmat, cmat = torch.split(xbc, [d_in, n, xbc.shape[-1] - d_in - n],
                                 dim=-1)
    xs = xs.reshape(b, l, nh, hd)
    dt_in = dt_raw.float() + params["dt_bias"].float()
    dt = torch.logaddexp(dt_in, torch.zeros_like(dt_in))  # softplus (B,L,NH)
    a = -torch.exp(params["A_log"].float())  # (NH,)

    y = _ssd_chunked(xs.float(), dt, a, bmat.float(), cmat.float(), ssm.chunk)
    y = y + params["D"].float()[None, None, :, None] * xs.float()
    y = y.reshape(b, l, d_in).to(xc.dtype)
    y = y * F.silu(z)  # gated
    y = rms_norm_gated(y, params["norm"], cfg.norm_eps)
    return (y @ w("out_proj")).to(x.dtype)


def rms_norm_gated(x: torch.Tensor, scale: torch.Tensor, eps: float
                   ) -> torch.Tensor:
    """RMS norm of the gated SSD output (fp32, ``1 + scale`` gain)."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def mamba_decode(params: dict, x: torch.Tensor, cache: dict,
                 cfg: ModelConfig) -> tuple:
    """O(1) per-token Mamba2 recurrence. x: (B, 1, D); cache {"conv": (B,
    W-1, conv_dim), "ssm": (B, NH, HD, N)}.

    The conv window is read through the cache's dtype (bf16 by default, so
    rounded every step even at fp32 compute, as in the reference); the
    state update is fp32. The new conv window and state are written into
    the caller's cache tensors in place, and ``(out, cache)`` returns
    those same tensors.
    """
    ssm = cfg.ssm
    b, _, d = x.shape
    d_in = ssm.d_inner(d)
    nh = ssm.num_heads(d)
    hd = ssm.head_dim
    n = ssm.d_state
    xc = _to_compute(x, cfg)

    def w(name):
        return params[name].to(xc.dtype)

    proj = (xc @ w("in_proj"))[:, 0]  # (B, ...)
    z, xbc, dt_raw = _split_proj(proj, cfg)

    # Rolling conv state: window = [cache | current]. The reference's
    # einsum "bwc,wc->bc" is fp32 products of the compute-dtype operands
    # summed over w, rounded once.
    wt = params["conv_w"].to(xc.dtype)  # (W, conv_dim)
    window = torch.cat([cache["conv"].to(xc.dtype), xbc[:, None, :]],
                       dim=1)  # (B, W, conv_dim)
    conv = (window.float() * wt.float()[None]).sum(1).to(xc.dtype)
    xbc_act = F.silu(conv + params["conv_b"].to(xc.dtype))

    xs, bvec, cvec = torch.split(xbc_act, [d_in, n, xbc_act.shape[-1]
                                           - d_in - n], dim=-1)
    xs = xs.reshape(b, nh, hd)
    dt_in = dt_raw.float() + params["dt_bias"].float()
    dt = torch.logaddexp(dt_in, torch.zeros_like(dt_in))  # softplus (B, NH)
    a = -torch.exp(params["A_log"].float())  # (NH,)

    h = cache["ssm"].float()  # (B,NH,HD,N)
    decay = torch.exp(dt * a)[:, :, None, None]
    upd = (dt[:, :, None, None] * xs.float()[:, :, :, None]
           * bvec.float()[:, None, None, :])
    h_new = h * decay + upd
    y = torch.matmul(h_new, cvec.float()[:, None, :, None])[..., 0]  # B,NH,HD
    y = y + params["D"].float()[None, :, None] * xs.float()
    y = y.reshape(b, d_in).to(xc.dtype)
    y = y * F.silu(z)
    y = rms_norm_gated(y, params["norm"], cfg.norm_eps)
    out = (y @ w("out_proj"))[:, None, :].to(x.dtype)
    cache["conv"].copy_(window[:, 1:, :])
    cache["ssm"].copy_(h_new)
    return out, {"conv": cache["conv"], "ssm": cache["ssm"]}
