"""i-GeLU — ITA's integer-only GeLU activation (I-BERT polynomial), torch port.

    GeLU(x) = x/2 * (1 + erf(x / sqrt(2)))
    erf(x) ~= sgn(x) * [a * (clip(|x|, max=-b) + b)^2 + c]
    a = -0.2888, b = -1.769, c = 1

evaluated in int32 on the int8-requantized pre-activation.  ``igelu_int``
returns the raw int32 polynomial output; its scale is
``IGeluParams.out_scale``.  ``igelu_i8`` is the fused int8-in / int8-out
op (the plain version of the ``igelu`` kernel); ``gelu_f32`` (erf form)
and ``igelu_f32`` are the float references.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.quant.qparams import (  # noqa: F401  (QParams: the reference's name)
    QParams,
    i32,
    make_qparams,
    requantize,
)

ERF_A = -0.2888
ERF_B = -1.769
ERF_C = 1.0

MIN_GELU_SCALE = 1e-3


class IGeluParams(NamedTuple):
    """Static integer constants for one i-GeLU site (input scale baked in)."""

    q_b: int
    q_c: int
    q_1: int
    out_scale: float


def make_igelu_params(in_scale: float) -> IGeluParams:
    if in_scale < MIN_GELU_SCALE:
        raise ValueError(
            f"i-GeLU input scale {in_scale:.2e} < {MIN_GELU_SCALE:.0e}; "
            "int32 overflow risk — clamp the calibrated activation range."
        )
    s_erf = in_scale / math.sqrt(2.0)
    s_l = ERF_A * s_erf * s_erf  # negative
    q_b = int(math.floor(ERF_B / s_erf))
    q_c = int(math.floor(ERF_C / s_l))
    q_1 = int(math.floor(1.0 / s_l))
    out_scale = in_scale * (-s_l) / 2.0
    return IGeluParams(q_b=q_b, q_c=q_c, q_1=q_1, out_scale=out_scale)


def igelu_int(q: torch.Tensor, p: IGeluParams) -> torch.Tensor:
    """int8/int16 ``q`` -> int32 i-GeLU output with scale ``p.out_scale``."""
    q = i32(q)
    sgn = torch.sign(q)
    q_abs = torch.clamp(torch.abs(q), max=-p.q_b)
    q_l = (q_abs + p.q_b) * (q_abs + p.q_b) + p.q_c
    q_erf = sgn * q_l
    return -(q * (q_erf + p.q_1))


def igelu_i8(q: torch.Tensor, in_scale: float, out_scale: float) -> torch.Tensor:
    """Fused int8 -> int8 i-GeLU (requantization folded)."""
    p = make_igelu_params(in_scale)
    qp = make_qparams(p.out_scale, 1.0, out_scale)
    return requantize(igelu_int(q, p), qp.mult, qp.shift)


def gelu_f32(x: torch.Tensor) -> torch.Tensor:
    """Exact float GeLU (erf form) — accuracy reference.  ``torch.erf`` and
    XLA's erf differ in the last bits, so the two packages agree within a
    float32 tolerance, not bit for bit."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def igelu_f32(x: torch.Tensor) -> torch.Tensor:
    """Float evaluation of the I-BERT polynomial (approximation target)."""
    s = torch.sign(x)
    xa = torch.clamp(torch.abs(x) / math.sqrt(2.0), max=-ERF_B)
    poly = ERF_A * (xa + ERF_B) ** 2 + ERF_C
    return 0.5 * x * (1.0 + s * poly)


def irelu_i8(q: torch.Tensor, in_scale: float, out_scale: float) -> torch.Tensor:
    """Integer ReLU with requantization (ITA activation unit mode 1)."""
    qp = make_qparams(in_scale, 1.0, out_scale)
    return requantize(torch.clamp(i32(q), min=0), qp.mult, qp.shift)
