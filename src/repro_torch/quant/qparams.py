"""Integer quantization parameters and fixed-point requantization (torch).

Port of the JAX package's ``quant/qparams.py``: every integer path of the
port (the plain PyTorch versions, the CUDA kernels' epilogues) uses these
exact primitives, so agreement across backends is by construction.

Conventions (ITA / Deeploy):

* Symmetric int8: ``real = q * scale``; weights stay in [-127, 127].
* Requantization of an int32 accumulator uses ``mult * 2^-shift`` with a
  15-bit ``mult`` and ``shift`` in [SHIFT_MIN, 31], round-half-up.
* All arithmetic stays inside int32: the product ``acc * mult`` is split
  in base 2^10 (see :func:`requantize`) instead of widening to int64, so
  the overflow corners behave exactly as in the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

INT8_MIN = -128
INT8_MAX = 127

MULT_BITS = 15
MULT_MAX = (1 << MULT_BITS) - 1  # 32767
SHIFT_MIN = 10  # required by the exact base-1024 decomposition
SHIFT_MAX = 31

_DECOMP_BITS = 10
_DECOMP_MASK = (1 << _DECOMP_BITS) - 1


class QParams(NamedTuple):
    """Static (python-int) requantization parameters for one tensor edge."""

    mult: int
    shift: int
    zero_point: int
    scale: float


def quantize_multiplier(real_mult: float) -> tuple[int, int]:
    """Represent ``real_mult`` as ``mult * 2^-shift`` (15-bit ``mult``)."""
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


def make_qparams(s_in: float, s_w: float, s_out: float, zero_point: int = 0) -> QParams:
    """QParams for requantizing an accumulator with scale ``s_in*s_w`` to ``s_out``."""
    real = (s_in * s_w) / s_out
    mult, shift = quantize_multiplier(real)
    return QParams(mult=mult, shift=shift, zero_point=zero_point, scale=s_out)


def np_quantize_multiplier(real_mult: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized numpy version of :func:`quantize_multiplier` (PTQ time)."""
    real = np.asarray(real_mult, np.float64)
    real = np.maximum(real, 1e-30)
    shift = np.floor(np.log2(MULT_MAX / real)).astype(np.int32)
    shift = np.clip(shift, SHIFT_MIN, SHIFT_MAX)
    mult = np.rint(real * (2.0 ** shift)).astype(np.int64)
    mult = np.clip(mult, 0, MULT_MAX).astype(np.int32)
    return mult, shift


def i32(x, device=None) -> torch.Tensor:
    """``x`` (tensor, numpy array or python int) as an int32 tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(x), dtype=torch.int32, device=device)


def imatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer ``a @ b`` with int32 accumulation, wrapping as int32.

    ``int8 @ int8`` in torch returns int8 and wraps, so on the CPU both
    operands are widened to int32 first.  CUDA has no int32 matmul: there
    the product goes through :func:`imatmul_exact`.
    """
    if a.is_cuda or b.is_cuda:
        return imatmul_exact(a, b)
    return torch.matmul(i32(a), i32(b))


#: float64 holds every integer of magnitude <= 2^53 exactly
F64_EXACT_BITS = 53

#: ``b`` with ``|x| <= 2^b`` for every value ``x`` of the dtype
_DTYPE_BITS = {torch.bool: 0, torch.int8: 7, torch.uint8: 8, torch.int16: 15,
               torch.int32: 31, torch.int64: 63}


def _value_bits(t: torch.Tensor) -> int:
    """``b`` with ``|x| < 2^b`` for every value of ``t`` (one reduction)."""
    if t.numel() == 0:
        return 0
    return max(int(t.max()), -int(t.min())).bit_length()


#: ``torch._int_mm`` takes more than 16 rows; fewer are padded to this many
INT_MM_MIN_ROWS = 17
INT_MM_PAD_ROWS = 32
#: the shallowest product sent to ``torch._int_mm``: cuBLASLt finds no int8
#: kernel (CUBLAS_STATUS_NOT_SUPPORTED) for some shallower ones (a head's
#: partial output projection, M 1928, K 64, N 384, on an H100), so those
#: run in float64; ``chip_smoke.py`` checks the card's refusals against it
INT_MM_MIN_DEPTH = 128


def int_mm_padded(a2: torch.Tensor, b: torch.Tensor, mm=None) -> torch.Tensor:
    """``a2 [M, K] @ b [K, N]`` (int8, K and N multiples of 8) through
    ``mm`` (``torch._int_mm`` by default), as int32 [M, N].

    ``_int_mm`` needs more than 16 rows: a product with fewer (a decode
    step's M = batch) gets zero rows up to :data:`INT_MM_PAD_ROWS`, and
    they are sliced away after the product (exact: a zero row's dot is 0
    and touches no other row).  A ``b`` that is the transpose of a
    contiguous matrix (the tied LM head's ``table.T``) is not copied: the
    product runs as ``(b.T @ a2.T).T``, with ``a2``'s rows padded to a
    multiple of 8, so that the large operand is read where it lies.
    """
    mm = torch._int_mm if mm is None else mm
    m, k = a2.shape
    if not b.is_contiguous() and b.T.is_contiguous() and b.shape[1] >= INT_MM_MIN_ROWS:
        pad = -m % 8 if m >= 8 else 8 - m
        at = a2.T
        if pad:
            at = torch.cat([at, at.new_zeros((k, pad))], dim=1)
        return mm(b.T, at.contiguous())[:, :m].T.contiguous()
    pad = INT_MM_PAD_ROWS - m if m < INT_MM_MIN_ROWS else 0
    if pad:
        a2 = torch.cat([a2, a2.new_zeros((pad, k))])
    out = mm(a2.contiguous(), b.contiguous())
    return out[:m] if pad else out


def imatmul_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of integer tensors as the int32 accumulator of the JAX
    package's ``preferred_element_type=int32`` products, on any device.

    2-D-weight int8 products with K and N multiples of 8 and K at least
    :data:`INT_MM_MIN_DEPTH` go through ``torch._int_mm``
    (:func:`int_mm_padded`, which pads fewer than 17 rows).  Every other product runs in float64, exact while every partial
    sum stays within 2^53: ``K * max|a| * max|b| < 2^53``, checked from the
    dtypes (K below 2^39 for int8 x int8, 2^15 for int32 x int8) or, where
    the dtypes cannot show it, from the values (one reduction each; it
    raises beyond).  The float64 result converts through int64 to int32,
    so it wraps as an int32 accumulator does.  Not float32: its 2^24 limit
    is passed by a 1536-deep int8 product.
    """
    k = a.shape[-1]
    if b.shape[-2] != k:
        raise ValueError(f"imatmul: {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype == torch.int8 and b.dtype == torch.int8 and b.dim() == 2:
        a2 = a.reshape(-1, k)
        if a2.shape[0] > 0 and k % 8 == 0 and k >= INT_MM_MIN_DEPTH and b.shape[1] % 8 == 0:
            out = int_mm_padded(a2, b)
            return out.reshape(*a.shape[:-1], b.shape[1])
    k_bits = k.bit_length()  # K < 2^k_bits
    if k_bits + _DTYPE_BITS[a.dtype] + _DTYPE_BITS[b.dtype] > F64_EXACT_BITS:
        a_bits, b_bits = _value_bits(a), _value_bits(b)
        if k_bits + a_bits + b_bits > F64_EXACT_BITS:
            raise ValueError(
                f"imatmul: K={k} with |a| < 2^{a_bits} and |b| < 2^{b_bits} may pass "
                f"2^{F64_EXACT_BITS}, where float64 stops being exact"
            )
    acc = torch.matmul(a.to(torch.float64), b.to(torch.float64))
    return acc.to(torch.int64).to(torch.int32)


def _param(p, device):
    """Python ints stay python ints (scalar ops); arrays become int32 tensors."""
    if isinstance(p, (int, np.integer)):
        return int(p)
    return i32(p, device)


def _lshift1(shift):
    """``1 << shift`` for an int or an int32 tensor of shifts."""
    if isinstance(shift, int):
        return 1 << shift
    return torch.bitwise_left_shift(torch.ones_like(shift), shift)


def rounding_rshift(x, shift):
    """Round-half-up arithmetic right shift. int32-safe for |x| < 2^30."""
    x = i32(x)
    shift = i32(shift, x.device)
    bias = torch.where(shift > 0, _lshift1((shift - 1).clamp(min=0)), torch.zeros_like(shift))
    return (x + bias) >> shift


def _requant_core(acc, mult, shift):
    acc = i32(acc)
    mult = _param(mult, acc.device)
    shift = _param(shift, acc.device)
    hi = acc >> _DECOMP_BITS
    lo = acc & _DECOMP_MASK
    b = hi * mult
    c = lo * mult + _lshift1(shift - 1)
    return (b + (c >> _DECOMP_BITS)) >> (shift - _DECOMP_BITS)


def requantize(acc, mult, shift, zero_point=0, *, narrow=False) -> torch.Tensor:
    """Requantize int32 ``acc`` to int8: ``clip(round(acc * mult / 2^shift) + zp)``.

    Exact for ``|acc| < 2^21``, ``mult <= MULT_MAX`` and ``shift >=
    SHIFT_MIN`` with int32 arithmetic only: write ``acc = hi*2^10 + lo``
    with ``0 <= lo < 2^10``; then
    ``round(acc*mult / 2^shift) = (hi*mult + ((lo*mult + r) >> 10)) >> (shift-10)``
    with ``r = 2^(shift-1)``.
    """
    out = _requant_core(acc, mult, shift)
    qmin = INT8_MIN + 1 if narrow else INT8_MIN
    return (out + zero_point).clamp(qmin, INT8_MAX).to(torch.int8)


def requantize_wide(acc, mult, shift, zero_point=0, out_bits=16) -> torch.Tensor:
    """Like :func:`requantize` but clipping to a wider signed width (int32 out)."""
    out = _requant_core(acc, mult, shift)
    lim = 1 << (out_bits - 1)
    return (out + zero_point).clamp(-lim, lim - 1).to(torch.int32)
