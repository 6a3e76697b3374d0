"""ITAMax — ITA's streaming integer softmax, torch port.

The logit grid is fixed so that ``log2(e) * S_logit = 2^-B`` with
``B = 5``; then ``exp(real_i - real_m) = LUT[(m - q_i) & 31] >> ((m - q_i) >> 5)``.

* :func:`itamax_rowwise` — the paper-faithful two-pass form: 8-bit A with
  scale 2^-7 (the ``w8a8`` backend's attention).
* :class:`FlashItamaxState` + :func:`flash_block_update` +
  :func:`flash_finalize_q77` — the single-pass blocked form the fused
  attention kernel runs: un-normalized exponentials accumulate against V
  in int32, a max update renormalizes with a 10-bit LUT, a guard rescales
  ``d`` and ``acc`` by 2^-8 when ``d`` exceeds 2^21, and one exact floor
  division per row ends it.  The result depends on the block partition.
* :func:`flash_itamax_reference` — the blocked form over a whole row, one
  block at a time; :func:`itamax_rowwise_f32` — the float softmax that
  ITAMax approximates.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.quant.qparams import i32, imatmul, rounding_rshift

ITAMAX_B = 5
_FRAC_MASK = (1 << ITAMAX_B) - 1

ITAMAX_LOGIT_SCALE = math.log(2.0) / (1 << ITAMAX_B)

EXP_LUT_BITS = 8
_EXP_LUT_NP = np.round((1 << EXP_LUT_BITS) * 2.0 ** (-np.arange(32) / 32.0)).astype(np.int32)

EXP_LUT7_BITS = 7
_EXP_LUT7_NP = np.minimum(
    np.round((1 << EXP_LUT7_BITS) * 2.0 ** (-np.arange(32) / 32.0)), 127
).astype(np.int32)

RENORM_LUT_BITS = 10
_RENORM_LUT_NP = np.round(
    (1 << RENORM_LUT_BITS) * 2.0 ** (-np.arange(32) / 32.0)
).astype(np.int32)

RESCALE_THRESH = 1 << 21
RESCALE_BITS = 8

INV_BITS = 23
A_BITS = 7
A_SCALE = 2.0 ** (-A_BITS)

M_SENTINEL = -(1 << 15)


def exp_lut(device=None) -> torch.Tensor:
    return torch.as_tensor(_EXP_LUT_NP, dtype=torch.int32, device=device)


def exp_lut7(device=None) -> torch.Tensor:
    return torch.as_tensor(_EXP_LUT7_NP, dtype=torch.int32, device=device)


def renorm_lut(device=None) -> torch.Tensor:
    return torch.as_tensor(_RENORM_LUT_NP, dtype=torch.int32, device=device)


def floor_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer division rounding toward minus infinity (``jnp.floor_divide``)."""
    return torch.div(a, b, rounding_mode="floor")


def _pow2(e: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_left_shift(torch.ones_like(e), e)


def _exp2_int(t: torch.Tensor, lut: torch.Tensor, lut_bits: int) -> torch.Tensor:
    """``round(2^lut_bits * 2^(-t / 2^B))`` for non-negative int32 ``t``."""
    t = i32(t)
    q = torch.clamp(t >> ITAMAX_B, max=31)
    r = t & _FRAC_MASK
    bias = torch.where(q > 0, _pow2(torch.clamp(q - 1, min=0)), torch.zeros_like(q))
    return (lut.to(t.device)[r.long()] + bias) >> q


def itamax_rowwise(
    logits: torch.Tensor,
    mask: torch.Tensor | None = None,
    lut: torch.Tensor | None = None,
) -> torch.Tensor:
    """Paper-faithful ITAMax over the last axis of int8 ``logits``.

    Returns int8 attention weights in [0, 127] with scale 2^-7.  ``mask``
    (bool, True = keep) excludes positions from both max and sum.
    """
    x = i32(logits)
    neg = -(1 << 20)
    if mask is not None:
        x = torch.where(mask, x, torch.full_like(x, neg))
    m = x.amax(dim=-1, keepdim=True)
    t = torch.clamp(m - x, 0, 1 << 20)
    val = _exp2_int(t, exp_lut(x.device) if lut is None else lut, EXP_LUT_BITS)
    if mask is not None:
        val = torch.where(mask, val, torch.zeros_like(val))
    d = val.sum(dim=-1, keepdim=True, dtype=torch.int32)
    d = torch.clamp(d, min=1)
    inv = floor_div((1 << INV_BITS) + (d >> 1), d)
    a = rounding_rshift(val * inv, INV_BITS - A_BITS)
    return torch.clamp(a, 0, 127).to(torch.int8)


def itamax_rowwise_f32(logits_f32: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Float reference of what ITAMax approximates (plain softmax)."""
    x = logits_f32 - logits_f32.amax(dim=axis, keepdim=True)
    e = torch.exp(x)
    return e / e.sum(dim=axis, keepdim=True)


class FlashItamaxState(NamedTuple):
    """Carry for softmax rows processed block by block (all int32).

    m: running max, init -2^15; d: running denominator; acc: running
    un-normalized ``sum_i val_i * V[i, :]``.
    """

    m: torch.Tensor
    d: torch.Tensor
    acc: torch.Tensor


def flash_init(row_shape: tuple[int, ...], out_dim: int, device=None) -> FlashItamaxState:
    return FlashItamaxState(
        m=torch.full(row_shape + (1,), M_SENTINEL, dtype=torch.int32, device=device),
        d=torch.zeros(row_shape + (1,), dtype=torch.int32, device=device),
        acc=torch.zeros(row_shape + (out_dim,), dtype=torch.int32, device=device),
    )


def _mul_q10(x: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
    """Exact ``floor((x * mult + 512) / 1024)`` in int32 (mult <= 1024)."""
    hi = x >> RENORM_LUT_BITS
    lo = x & ((1 << RENORM_LUT_BITS) - 1)
    b = hi * mult
    c = lo * mult + (1 << (RENORM_LUT_BITS - 1))
    return b + (c >> RENORM_LUT_BITS)


def rounding_rshift_safe(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Round-half-up right shift that tolerates shift == 0..31."""
    bias = torch.where(shift > 0, _pow2(torch.clamp(shift - 1, min=0)), torch.zeros_like(shift))
    return (x + bias) >> shift


def _renorm_factor_apply(x: torch.Tensor, delta: torch.Tensor, rlut: torch.Tensor) -> torch.Tensor:
    """Multiply int32 ``x`` by ``2^(-delta / 2^B)`` (delta >= 0, broadcast)."""
    q = torch.clamp(delta >> ITAMAX_B, max=31)
    r = delta & _FRAC_MASK
    return _mul_q10(rounding_rshift_safe(x, q), rlut[r.long()])


def flash_block_update(
    state: FlashItamaxState,
    logits_block: torch.Tensor,  # int8/int32 [..., bk]
    v_block: torch.Tensor,  # int8 [..., bk, out_dim] (or [bk, out_dim])
    mask_block: torch.Tensor | None = None,
    luts: tuple | None = None,
) -> FlashItamaxState:
    """One denominator-accumulation step fused with ``A @ V`` over a KV block.
    ``luts`` = ``(exp_lut7, renorm_lut)`` as given (int32 on the block's
    device, as built here when None)."""
    device = logits_block.device
    if luts is None:
        lut7, rlut = exp_lut7(device), renorm_lut(device)
    else:
        lut7, rlut = (torch.as_tensor(t, dtype=torch.int32, device=device) for t in luts)
    if mask_block is not None and logits_block.dtype == torch.int8:
        # masked positions become -128: a real logit is >= -128, so the
        # row max cannot rise, and their exponentials are zeroed below
        logits_block = torch.where(
            mask_block, logits_block, torch.full_like(logits_block, -128)
        )
        x = i32(logits_block)
    else:
        x = i32(logits_block)
        if mask_block is not None:
            x = torch.where(mask_block, x, torch.full_like(x, -(1 << 20)))
    bm = x.amax(dim=-1, keepdim=True)
    new_m = torch.maximum(state.m, bm)
    delta_old = torch.clamp(new_m - state.m, 0, 1 << 12)
    d_r = _renorm_factor_apply(state.d, delta_old, rlut)
    acc_r = _renorm_factor_apply(state.acc, delta_old[..., 0:1], rlut)

    t = torch.clamp(new_m - x, 0, 1 << 20)
    val = _exp2_int(t, lut7, EXP_LUT7_BITS)
    if mask_block is not None:
        val = torch.where(mask_block, val, torch.zeros_like(val))
    d_new = d_r + val.sum(dim=-1, keepdim=True, dtype=torch.int32)

    acc_new = acc_r + imatmul(val, v_block)

    over = d_new > RESCALE_THRESH
    eight = torch.full_like(d_new, RESCALE_BITS)
    d_out = torch.where(over, rounding_rshift_safe(d_new, eight), d_new)
    acc_out = torch.where(over, rounding_rshift_safe(acc_new, eight), acc_new)
    return FlashItamaxState(m=new_m, d=d_out, acc=acc_out)


def flash_finalize_q77(state: FlashItamaxState) -> torch.Tensor:
    """Exact integer division to Q7.7: ``floor(acc * 2^7 / d)`` rounded half up."""
    d = torch.clamp(state.d, min=1)
    r = floor_div(state.acc, d)
    rem = state.acc - r * d
    frac = floor_div((rem << A_BITS) + (d >> 1), d)
    return r * (1 << A_BITS) + frac


def flash_itamax_reference(
    logits: torch.Tensor,  # int8 [..., n]
    v: torch.Tensor,  # int8 [..., n, out_dim]
    block: int,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Blocked single-pass oracle: Q7.7 int32 [..., out_dim], bit-exact with
    the fused attention kernel run with the same block size."""
    n = logits.shape[-1]
    if n % block:
        raise ValueError(f"row length {n} is not a multiple of block {block}")
    state = flash_init(tuple(logits.shape[:-1]), v.shape[-1], device=logits.device)
    for i in range(0, n, block):
        mb = None if mask is None else mask[..., i:i + block]
        state = flash_block_update(state, logits[..., i:i + block], v[..., i:i + block, :], mb)
    return flash_finalize_q77(state)
