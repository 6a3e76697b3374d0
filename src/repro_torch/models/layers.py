"""Shared model layers of the port: float init and the integer (w8a8) helpers.

Activations are int8 tensors threaded between ops, with static python
float scales carried by a :class:`QuantConfig`.  Engine mapping (the
paper's heterogeneous split): the accelerator runs qlinear (GEMM + act)
and the quantized attention; the cluster runs norms, residual adds, the
classifier, and the decoder's integer RoPE and SiLU.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import ilayernorm as iln
from repro_torch.core import itamax as im
from repro_torch.core.quant_linear import (
    ACT_IDENTITY,
    QLinearParams,
    make_qlinear_params,
    qlinear_i8,
)
from repro_torch.quant.qparams import i32, make_qparams, requantize, requantize_wide

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
             dtype=torch.float32, device=None, kind: str = "gelu") -> dict:
    """The GELU MLP (up and down projections, with biases) or, for
    ``kind="swiglu"``, the gated MLP (gate, up, down; no biases)."""
    if kind == "swiglu":
        return {
            "gate": init_linear(gen, d_model, d_ff, False, dtype, device),
            "up": init_linear(gen, d_model, d_ff, False, dtype, device),
            "down": init_linear(gen, d_ff, d_model, False, dtype, device),
        }
    return {
        "up": init_linear(gen, d_model, d_ff, True, dtype, device),
        "down": init_linear(gen, d_ff, d_model, True, dtype, device),
    }


def init_qlinear(gen: torch.Generator, d_in: int, d_out: int, bias: bool) -> dict:
    """Shape-only int8 init (weights uniform in [-127, 127], zero bias)."""
    p = {"w_q": torch.randint(-127, 128, (d_in, d_out), generator=gen, dtype=torch.int8)}
    if bias:
        p["b_q"] = torch.zeros((d_out,), dtype=torch.int32)
    return p


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


# ---------------------------------------------------------------------------
# Decoder helpers: integer RoPE and SiLU (cluster ops)
# ---------------------------------------------------------------------------

_ROPE_BITS = 7  # Q0.7 trig tables


def rope_cos_sin(positions, head_dim: int, theta: float):
    """float32 ``cos``/``sin`` [..., head_dim // 2] of ``positions``, on the CPU.

    The JAX package computes ``theta ** (-arange(half) / half)`` in float32;
    torch's float32 power differs from XLA's in the last bit of a few
    frequencies (3 of 64 at head_dim 128), so the power runs in float64 on
    the float32 exponent and is cast to float32, which gives XLA's
    frequencies.  The angles are float32 products as in the reference, and
    ``cos``/``sin`` are torch's float32 functions on the CPU (CUDA's
    ``sinf``/``cosf`` are another implementation: never build them there).
    """
    half = head_dim // 2
    expo = -torch.arange(0, half, dtype=torch.float32) / half
    freqs = torch.pow(float(theta), expo.to(torch.float64)).to(torch.float32)
    pos = torch.as_tensor(np.asarray(positions)).to(torch.float32)
    ang = pos[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


@functools.lru_cache(maxsize=32)
def _rope_table(n: int, head_dim: int, theta: float, device: torch.device):
    """Q0.7 ``cos``/``sin`` tables of positions ``[0, n)``, int32 [n, half],
    built on the host and moved to ``device`` once per key."""
    cos, sin = rope_cos_sin(np.arange(n), head_dim, theta)
    scale = 1 << _ROPE_BITS
    c_q = torch.clamp(torch.round(cos * scale), -127, 127).to(torch.int32)
    s_q = torch.clamp(torch.round(sin * scale), -127, 127).to(torch.int32)
    return c_q.to(device), s_q.to(device)


def rope_tables_i8(positions, head_dim: int, theta: float, device=None):
    """Q0.7 tables [..., head_dim // 2] (int32) of integer ``positions``.

    ``positions`` are host data (an int, a numpy array or a CPU tensor):
    the rows are gathered from a table of every position below the next
    power of two past the largest one, built once per (size, head_dim,
    theta, device) by :func:`_rope_table`.
    """
    pos = torch.as_tensor(np.asarray(positions), dtype=torch.int64)
    top = int(pos.max()) + 1 if pos.numel() else 1
    n = max(64, 1 << (top - 1).bit_length())
    c_tab, s_tab = _rope_table(n, head_dim, float(theta), torch.device(device or "cpu"))
    idx = pos.to(c_tab.device)
    return c_tab[idx], s_tab[idx]


def apply_rope_i8(x_q: torch.Tensor, c_q: torch.Tensor, s_q: torch.Tensor) -> torch.Tensor:
    """Integer rotary embedding (cluster op): Q0.7 rotation, scale preserved.

    ``x_q`` int8 [B, H, S, D]; tables [S, D/2] or broadcastable.  The int32
    ``>>`` is arithmetic (floor), as XLA's, after adding 2^6 to round.
    """
    x = i32(x_q)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = c_q[None, None] if c_q.dim() == 2 else c_q
    s = s_q[None, None] if s_q.dim() == 2 else s_q
    r = 1 << (_ROPE_BITS - 1)
    y1 = (x1 * c - x2 * s + r) >> _ROPE_BITS
    y2 = (x1 * s + x2 * c + r) >> _ROPE_BITS
    return torch.clamp(torch.cat([y1, y2], dim=-1), -128, 127).to(torch.int8)


def isilu_i8(x_q: torch.Tensor, s_in: float, s_out: float) -> torch.Tensor:
    """Integer SiLU (cluster op — ITA's activation unit has no SiLU mode).

    sigma(x) = 2^(x log2 e) / (1 + 2^(x log2 e)) with the ITAMax exp2
    machinery: requantize x onto the log2 grid, exponentiate with the
    8-bit table, one integer division per element (both dividends and the
    divisor are positive, so torch's floor division is the reference's).
    """
    qp = make_qparams(s_in, 1.0, im.ITAMAX_LOGIT_SCALE)
    v = requantize_wide(x_q, qp.mult, qp.shift, out_bits=14)  # log-grid value
    t = torch.clamp(torch.abs(v), 0, 1 << 13)
    e = im._exp2_int(t, im.exp_lut(v.device), im.EXP_LUT_BITS)  # ~256 * e^-|x|
    denom = 256 + e
    sig_pos = (256 * 256) // denom  # x >= 0 branch, Q8 in [128, 256]
    sig_neg = (256 * e) // denom  # x < 0 branch, Q8 in [0, 128]
    sig = torch.where(v >= 0, sig_pos, sig_neg)
    acc = i32(x_q) * sig  # scale s_in / 256
    qo = make_qparams(s_in, 1.0 / 256.0, s_out)
    return requantize(acc, qo.mult, qo.shift)


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
