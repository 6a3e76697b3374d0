"""Integer LayerNorm / RMSNorm — the cluster's auxiliary operators, torch port.

Mean and variance in int32, ``1/sigma`` through a fixed 20-step integer
Newton square root, the normalized value in Q.10 fixed point, then the
affine fold and a standard requantize to int8.  Every division floors
(numerators can be negative), as ``jnp.floor_divide`` does.
"""

from __future__ import annotations

import torch

from repro_torch.core.itamax import floor_div
from repro_torch.quant.qparams import i32, make_qparams, requantize

NORM_BITS = 10
NORM_SCALE = 2.0 ** (-NORM_BITS)

_ISQRT_ITERS = 20


def isqrt(v: torch.Tensor) -> torch.Tensor:
    """floor(sqrt(v)) for int32 v >= 0 via fixed-iteration Newton descent."""
    v = i32(v)
    x = torch.full_like(v, 1 << 16)
    for _ in range(_ISQRT_ITERS):
        x_safe = torch.clamp(x, min=1)
        y = (x_safe + floor_div(v, x_safe)) >> 1
        x = torch.minimum(x, y)
    x = torch.clamp(x, 1, 46340)  # keeps x*x inside int32
    x = torch.where(x * x > v, x - 1, x)
    x = torch.where(x * x > v, x - 1, x)
    return torch.clamp(x, min=1)


def _normalize_q(x_i8: torch.Tensor, center: bool) -> torch.Tensor:
    """int8 row -> Q.NORM_BITS fixed-point normalized value (int32)."""
    x = i32(x_i8)
    n = x.shape[-1]
    if center:
        mu = x.sum(dim=-1, keepdim=True, dtype=torch.int32)
        mu = torch.where(mu >= 0, floor_div(mu + n // 2, n), -floor_div(-mu + n // 2, n))
        xc = x - mu
    else:
        xc = x
    ss = (xc * xc).sum(dim=-1, keepdim=True, dtype=torch.int32)
    var = floor_div(ss, n)
    sigma = isqrt(var)
    return floor_div(xc << NORM_BITS, sigma)


def ilayernorm_i8(x_i8, gamma_q, beta_q, s_gamma: float, out_scale: float) -> torch.Tensor:
    """Full integer LayerNorm: int8 in, int8 out (``beta_q`` pre-folded)."""
    norm_q = _normalize_q(x_i8, center=True)
    acc = norm_q * i32(gamma_q, norm_q.device) + i32(beta_q, norm_q.device)
    qp = make_qparams(NORM_SCALE, s_gamma, out_scale)
    return requantize(acc, qp.mult, qp.shift)


def ilayernorm_np_i8(x_i8, out_scale: float) -> torch.Tensor:
    """Non-parametric LayerNorm (OLMo): normalize, requantize."""
    norm_q = _normalize_q(x_i8, center=True)
    qp = make_qparams(NORM_SCALE, 1.0, out_scale)
    return requantize(norm_q, qp.mult, qp.shift)


def irmsnorm_i8(x_i8, gamma_q, s_gamma: float, out_scale: float) -> torch.Tensor:
    """Integer RMSNorm (no centering)."""
    norm_q = _normalize_q(x_i8, center=False)
    acc = norm_q * i32(gamma_q, norm_q.device)
    qp = make_qparams(NORM_SCALE, s_gamma, out_scale)
    return requantize(acc, qp.mult, qp.shift)


# Float references ----------------------------------------------------------


def layernorm_f32(x: torch.Tensor, gamma=None, beta=None, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma
    if beta is not None:
        y = y + beta
    return y


def rmsnorm_f32(x: torch.Tensor, gamma=None, eps: float = 1e-5) -> torch.Tensor:
    ms = (x * x).mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(ms + eps)
    if gamma is not None:
        y = y * gamma
    return y
