"""Shared model layers of the port: float init and the integer (w8a8) helpers.

Activations are int8 tensors threaded between ops, with static python
float scales carried by a :class:`QuantConfig`.  Engine mapping (the
paper's heterogeneous split): the accelerator runs qlinear (GEMM + act)
and the quantized attention; the cluster runs norms, residual adds and
the classifier.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core import ilayernorm as iln
from repro_torch.core.quant_linear import (
    ACT_IDENTITY,
    QLinearParams,
    make_qlinear_params,
    qlinear_i8,
)
from repro_torch.quant.qparams import make_qparams, requantize_wide

# ---------------------------------------------------------------------------
# Quantization configuration (static scales)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class QuantConfig:
    """Static per-site activation scales for the integer path."""

    s_act: float = 0.05
    s_res: float = 0.08
    s_w: float = 0.01


# ---------------------------------------------------------------------------
# Float init (torch.Generator; the JAX package's numbers are not reproduced)
# ---------------------------------------------------------------------------


def init_linear(gen: torch.Generator, d_in: int, d_out: int, bias: bool,
                dtype=torch.float32, device=None) -> dict:
    w = torch.randn((d_in, d_out), generator=gen, dtype=dtype) / math.sqrt(d_in)
    p = {"w": w.to(device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def init_norm(kind: str, d: int, dtype=torch.float32, device=None) -> dict:
    if kind == "np_layernorm":
        return {}
    if kind == "rmsnorm":
        return {"g": torch.ones((d,), dtype=dtype, device=device)}
    return {"g": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32, device=None) -> dict:
    """The encoders' GELU MLP (up and down projections, with biases)."""
    return {
        "up": init_linear(gen, d_model, d_ff, True, dtype, device),
        "down": init_linear(gen, d_ff, d_model, True, dtype, device),
    }


# ---------------------------------------------------------------------------
# Integer ("cluster") helpers
# ---------------------------------------------------------------------------


def norm_apply_i8(kind: str, pq: dict, x_q: torch.Tensor, s_gamma: float, s_out: float):
    if kind == "rmsnorm":
        return iln.irmsnorm_i8(x_q, pq["g_q"], s_gamma, s_out)
    if kind == "np_layernorm":
        return iln.ilayernorm_np_i8(x_q, s_out)
    return iln.ilayernorm_i8(x_q, pq["g_q"], pq["beta_q"], s_gamma, s_out)


def iadd_i8(a_q, b_q, mult_a, shift_a, mult_b, shift_b) -> torch.Tensor:
    """Residual add on a common grid: requant each operand, saturating add."""
    a = requantize_wide(a_q, mult_a, shift_a, out_bits=16)
    b = requantize_wide(b_q, mult_b, shift_b, out_bits=16)
    return torch.clamp(a + b, -128, 127).to(torch.int8)


def make_iadd_params(s_a: float, s_b: float, s_out: float):
    qa = make_qparams(s_a, 1.0, s_out)
    qb = make_qparams(s_b, 1.0, s_out)
    return (qa.mult, qa.shift, qb.mult, qb.shift)


#: |int8 x int8| summed over K stays below 2^24 — exact in float32 — while
#: K * 128 * 127 < 2^24, i.e. K <= 1032.
_F32_EXACT_K = (1 << 24) // (128 * 127)


def classifier_f32(h_q: torch.Tensor, table_q: torch.Tensor, scale: float) -> torch.Tensor:
    """Tied MLM head: ``float32(h_q @ table_q.T) * scale``, exact on any device.

    CUDA has no int32 matmul, and the vocabulary (30522) is no multiple of
    8 as ``torch._int_mm`` needs.  The product runs in float32 instead:
    every partial sum is an integer below 2^24 while K <= 1032, so float32
    holds it exactly in any summation order (TF32 too, whose 10-bit
    mantissa holds int8 operands exactly), and the result equals the int32
    accumulator cast to float32.
    """
    k = h_q.shape[-1]
    if k > _F32_EXACT_K:
        raise ValueError(f"K={k} > {_F32_EXACT_K}: float32 no longer holds the int8 dot exactly")
    acc = torch.matmul(h_q.to(torch.float32), table_q.to(torch.float32).T)
    return acc * scale


# ---------------------------------------------------------------------------
# Quantized linear plumbing
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class QLinearSite:
    """Static description of one quantized linear site."""

    s_in: float
    s_w: float
    s_out: float
    act: int = ACT_IDENTITY
    s_preact: float | None = None

    def params(self) -> QLinearParams:
        return make_qlinear_params(self.s_in, self.s_w, self.s_out, self.act, self.s_preact)


def qlinear(pq: dict, x_q: torch.Tensor, site: QLinearSite) -> torch.Tensor:
    return qlinear_i8(x_q, pq["w_q"], pq.get("b_q"), site.params())
