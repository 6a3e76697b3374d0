"""Integer arithmetic of the ITA deployment flow, frozen for the benchmark.

A plain PyTorch copy of the arithmetic that the program under test is
defined by (requantization, integer LayerNorm, the residual add,
flash-ITAMax, integer RoPE and SiLU), so that the reference in this
folder holds the program to it without importing the program.  Every
integer product is exact: it runs in float64, whose 53-bit mantissa holds
each int8 x int8 dot product of the models here (K <= 8192), and converts
back through int64.

``Prec`` selects the precision: ``bits=8`` is the configuration's own,
``bits=4`` the control that ``correct`` has to reject (every int8 weight
and activation snapped onto the 4-bit grid, 16 int8 steps apart).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

INT8_MIN, INT8_MAX = -128, 127

# -- requantization (15-bit multiplier, shift >= 10, base-1024 decomposition)
MULT_MAX = (1 << 15) - 1
SHIFT_MIN, SHIFT_MAX = 10, 31
_DECOMP_BITS = 10
_DECOMP_MASK = (1 << _DECOMP_BITS) - 1


@dataclass(frozen=True)
class Prec:
    """Operand precision: int8 as configured, or fewer bits for a control."""

    bits: int = 8

    def snap(self, t: torch.Tensor) -> torch.Tensor:
        """An int8 tensor onto the ``bits``-bit grid (round half up, clamp),
        kept in int8 units."""
        if self.bits >= 8:
            return t
        sh = 8 - self.bits
        lo, hi = -(1 << (self.bits - 1)), (1 << (self.bits - 1)) - 1
        q = torch.clamp((t.to(torch.int32) + (1 << (sh - 1))) >> sh, lo, hi)
        return torch.clamp(q << sh, INT8_MIN, INT8_MAX).to(torch.int8)


INT8 = Prec(8)


def quantize_multiplier(real_mult: float) -> tuple[int, int]:
    if real_mult <= 0:
        return 0, SHIFT_MIN
    shift = int(math.floor(math.log2(MULT_MAX / real_mult)))
    shift = max(SHIFT_MIN, min(SHIFT_MAX, shift))
    mult = int(round(real_mult * (1 << shift)))
    if mult > MULT_MAX:
        mult = MULT_MAX
    if mult == 0:
        shift = SHIFT_MAX
        mult = max(0, int(round(real_mult * (1 << shift))))
    return mult, shift


def make_qparams(s_in: float, s_w: float, s_out: float) -> tuple[int, int]:
    """(mult, shift) that requantize an accumulator of scale s_in*s_w to s_out."""
    return quantize_multiplier((s_in * s_w) / s_out)


def np_multiplier(real: float) -> tuple[int, int]:
    """The vectorised form of :func:`quantize_multiplier` the linear sites use
    (``floor(log2)`` and ``rint`` on float64 numpy values)."""
    r = np.maximum(np.asarray([real], np.float64), 1e-30)
    shift = np.clip(np.floor(np.log2(MULT_MAX / r)).astype(np.int32), SHIFT_MIN, SHIFT_MAX)
    mult = np.clip(np.rint(r * (2.0 ** shift)).astype(np.int64), 0, MULT_MAX)
    return int(mult[0]), int(shift[0])


def i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_left_shift(torch.ones_like(e), e)


def _requant_core(acc: torch.Tensor, mult: int, shift: int) -> torch.Tensor:
    acc = i32(acc)
    hi = acc >> _DECOMP_BITS
    lo = acc & _DECOMP_MASK
    c = lo * mult + (1 << (shift - 1))
    return (hi * mult + (c >> _DECOMP_BITS)) >> (shift - _DECOMP_BITS)


def requantize(acc: torch.Tensor, mult: int, shift: int, prec: Prec = INT8) -> torch.Tensor:
    """int32 -> int8: ``clip(round(acc * mult / 2^shift))``."""
    out = _requant_core(acc, mult, shift).clamp(INT8_MIN, INT8_MAX).to(torch.int8)
    return prec.snap(out)


def requantize_wide(acc: torch.Tensor, mult: int, shift: int, out_bits: int) -> torch.Tensor:
    lim = 1 << (out_bits - 1)
    return _requant_core(acc, mult, shift).clamp(-lim, lim - 1).to(torch.int32)


def floor_div(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def imatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer ``a @ b`` as an int32 accumulator (float64 inside)."""
    acc = torch.matmul(a.to(torch.float64), b.to(torch.float64))
    return acc.to(torch.int64).to(torch.int32)


# -- quantized linear with the activation unit's epilogue -------------------

def qlinear(x_q: torch.Tensor, w_q: torch.Tensor, b_q: torch.Tensor | None,
            s_in: float, s_w: float, s_out: float, *, prec: Prec = INT8) -> torch.Tensor:
    """int8 -> int8 linear: exact product, bias, requantization."""
    acc = imatmul(x_q, prec.snap(w_q))
    if b_q is not None:
        acc = acc + i32(b_q)
    mult, shift = np_multiplier(s_in * s_w / s_out)
    return requantize(acc, mult, shift, prec=prec)


# -- integer LayerNorm and the residual add ---------------------------------

NORM_BITS = 10
NORM_SCALE = 2.0 ** (-NORM_BITS)


def isqrt(v: torch.Tensor) -> torch.Tensor:
    v = i32(v)
    x = torch.full_like(v, 1 << 16)
    for _ in range(20):
        x_safe = torch.clamp(x, min=1)
        y = (x_safe + floor_div(v, x_safe)) >> 1
        x = torch.minimum(x, y)
    x = torch.clamp(x, 1, 46340)
    x = torch.where(x * x > v, x - 1, x)
    x = torch.where(x * x > v, x - 1, x)
    return torch.clamp(x, min=1)


def _normalize(x_i8: torch.Tensor) -> torch.Tensor:
    x = i32(x_i8)
    n = x.shape[-1]
    mu = x.sum(dim=-1, keepdim=True, dtype=torch.int32)
    mu = torch.where(mu >= 0, floor_div(mu + n // 2, n), -floor_div(-mu + n // 2, n))
    xc = x - mu
    var = floor_div((xc * xc).sum(dim=-1, keepdim=True, dtype=torch.int32), n)
    return floor_div(xc << NORM_BITS, isqrt(var))


def layernorm_np(x_i8, s_out: float, prec: Prec = INT8):
    """OLMo's non-parametric LayerNorm."""
    return requantize(_normalize(x_i8), *make_qparams(NORM_SCALE, 1.0, s_out), prec=prec)


def iadd(a_q, b_q, s_a: float, s_b: float, s_out: float, prec: Prec = INT8):
    """Residual add: each operand onto the output grid (16-bit), saturating sum."""
    a = requantize_wide(a_q, *make_qparams(s_a, 1.0, s_out), 16)
    b = requantize_wide(b_q, *make_qparams(s_b, 1.0, s_out), 16)
    return prec.snap(torch.clamp(a + b, INT8_MIN, INT8_MAX).to(torch.int8))


# -- flash-ITAMax -------------------------------------------------------------

ITAMAX_B = 5
_FRAC_MASK = (1 << ITAMAX_B) - 1
ITAMAX_LOGIT_SCALE = math.log(2.0) / (1 << ITAMAX_B)
_EXP_LUT = np.round(256 * 2.0 ** (-np.arange(32) / 32.0)).astype(np.int32)
_EXP_LUT7 = np.minimum(np.round(128 * 2.0 ** (-np.arange(32) / 32.0)), 127).astype(np.int32)
_RENORM_LUT = np.round(1024 * 2.0 ** (-np.arange(32) / 32.0)).astype(np.int32)
RESCALE_THRESH, RESCALE_BITS = 1 << 21, 8
A_BITS = 7
M_SENTINEL = -(1 << 15)


def _exp2_int(t: torch.Tensor, lut: np.ndarray) -> torch.Tensor:
    """``round(2^lut_bits * 2^(-t / 32))`` for non-negative int32 ``t``."""
    t = i32(t)
    q = torch.clamp(t >> ITAMAX_B, max=31)
    r = t & _FRAC_MASK
    bias = torch.where(q > 0, _pow2(torch.clamp(q - 1, min=0)), torch.zeros_like(q))
    lut_t = torch.as_tensor(lut, dtype=torch.int32, device=t.device)
    return (lut_t[r.long()] + bias) >> q


def _shift_safe(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    bias = torch.where(shift > 0, _pow2(torch.clamp(shift - 1, min=0)), torch.zeros_like(shift))
    return (x + bias) >> shift


def _renorm(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """``x * 2^(-delta / 32)`` by the 10-bit table, exactly as int32."""
    q = torch.clamp(delta >> ITAMAX_B, max=31)
    r = delta & _FRAC_MASK
    mult = torch.as_tensor(_RENORM_LUT, dtype=torch.int32, device=x.device)[r.long()]
    x = _shift_safe(x, q)
    hi, lo = x >> 10, x & 1023
    return hi * mult + ((lo * mult + 512) >> 10)


def flash_attention(q_q, k_q, v_q, s_q: float, s_k: float, s_v: float, s_out: float,
                    blocks, q_rows: torch.Tensor | None, prec: Prec = INT8) -> torch.Tensor:
    """Flash-ITAMax over the key blocks ``blocks`` (a list of (j0, j1)), in order.

    ``q_q`` int8 [..., Sq, D], ``k_q``/``v_q`` int8 [..., Sk, D]; ``q_rows``
    (int [Sq]) are the queries' global rows for a causal mask (key j is
    seen by the query at row r when j <= r), or None for no mask.
    """
    d = q_q.shape[-1]
    lm, ls = make_qparams(s_q, s_k / math.sqrt(d), ITAMAX_LOGIT_SCALE)
    om, osh = make_qparams(2.0 ** (-A_BITS), s_v, s_out)
    dev = q_q.device
    rows = q_q.shape[:-1]
    m = torch.full(rows + (1,), M_SENTINEL, dtype=torch.int32, device=dev)
    den = torch.zeros(rows + (1,), dtype=torch.int32, device=dev)
    acc = torch.zeros(rows + (d,), dtype=torch.int32, device=dev)
    for j0, j1 in blocks:
        logits = requantize(imatmul(q_q, k_q[..., j0:j1, :].transpose(-1, -2)), lm, ls)
        mask = None
        if q_rows is not None:
            kj = torch.arange(j0, j1, device=dev)
            mask = kj[None, :] <= q_rows[:, None]
            logits = torch.where(mask, logits, torch.full_like(logits, -128))
        x = i32(logits)
        new_m = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        delta = torch.clamp(new_m - m, 0, 1 << 12)
        den, acc = _renorm(den, delta), _renorm(acc, delta)
        val = _exp2_int(torch.clamp(new_m - x, 0, 1 << 20), _EXP_LUT7)
        if mask is not None:
            val = torch.where(mask, val, torch.zeros_like(val))
        den = den + val.sum(dim=-1, keepdim=True, dtype=torch.int32)
        acc = acc + imatmul(val, v_q[..., j0:j1, :])
        over = den > RESCALE_THRESH
        eight = torch.full_like(den, RESCALE_BITS)
        den, acc = (torch.where(over, _shift_safe(den, eight), den),
                    torch.where(over, _shift_safe(acc, eight), acc))
        m = new_m
    den = torch.clamp(den, min=1)
    r = floor_div(acc, den)
    frac = floor_div(((acc - r * den) << A_BITS) + (den >> 1), den)
    return requantize(r * (1 << A_BITS) + frac, om, osh, prec=prec)


# -- integer RoPE and SiLU (the decoder) ------------------------------------

ROPE_BITS = 7


def rope_tables(positions: np.ndarray, head_dim: int, theta: float, device):
    """Q0.7 cos/sin of ``positions`` [n], int32 [n, head_dim // 2], built on
    the CPU in float32 (the frequencies' power in float64)."""
    half = head_dim // 2
    expo = -torch.arange(0, half, dtype=torch.float32) / half
    freqs = torch.pow(float(theta), expo.to(torch.float64)).to(torch.float32)
    ang = torch.as_tensor(np.asarray(positions)).to(torch.float32)[:, None] * freqs
    scale = 1 << ROPE_BITS
    c = torch.clamp(torch.round(torch.cos(ang) * scale), -127, 127).to(torch.int32)
    s = torch.clamp(torch.round(torch.sin(ang) * scale), -127, 127).to(torch.int32)
    return c.to(device), s.to(device)


def rope(x_q: torch.Tensor, c: torch.Tensor, s: torch.Tensor, prec: Prec = INT8):
    """Rotate int8 [..., S, D] by Q0.7 tables [S, D/2]."""
    x = i32(x_q)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    r = 1 << (ROPE_BITS - 1)
    y1 = (x1 * c - x2 * s + r) >> ROPE_BITS
    y2 = (x1 * s + x2 * c + r) >> ROPE_BITS
    return prec.snap(torch.clamp(torch.cat([y1, y2], dim=-1), -128, 127).to(torch.int8))


def silu(x_q: torch.Tensor, s_in: float, s_out: float) -> torch.Tensor:
    """Integer SiLU: sigmoid from the ITAMax exp2 table, one division."""
    v = requantize_wide(x_q, *make_qparams(s_in, 1.0, ITAMAX_LOGIT_SCALE), 14)
    e = _exp2_int(torch.clamp(torch.abs(v), 0, 1 << 13), _EXP_LUT)
    denom = 256 + e
    sig = torch.where(v >= 0, (256 * 256) // denom, (256 * e) // denom)
    return requantize(i32(x_q) * sig, *make_qparams(s_in, 1.0 / 256.0, s_out))
