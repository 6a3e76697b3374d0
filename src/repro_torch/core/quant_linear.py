"""Quantized linear layer — ITA's GEMM mode with fused activation, torch port.

int8 x int8 -> int32 accumulate, add the int32 bias, fixed-point
requantize, optional Identity / ReLU / i-GeLU epilogue.  This is the plain
(``w8a8``) form; ``repro_torch.kernels.int8_gemm`` is the CUDA kernel of
the same function.  ``linear_f32`` is the float reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.igelu import IGeluParams, gelu_f32, igelu_int, make_igelu_params
from repro_torch.quant.qparams import (
    _is_dtensor,
    i32,
    imatmul,
    make_qparams,
    np_quantize_multiplier,
    requantize,
)

ACT_IDENTITY = 0
ACT_RELU = 1
ACT_GELU = 2


class QLinearParams(NamedTuple):
    """Integer-side parameters of one quantized linear site.

    ``mult``/``shift`` are python ints (per-tensor) or int32 [N] tensors
    (per-channel).  For ACT_GELU, ``gelu`` holds the i-GeLU constants and
    ``gelu_mult``/``gelu_shift`` requantize its output to the int8 grid.
    """

    mult: torch.Tensor | int
    shift: torch.Tensor | int
    act: int
    gelu: IGeluParams | None = None
    gelu_mult: int = 0
    gelu_shift: int = 31


def make_qlinear_params(
    s_in: float,
    s_w,
    s_out: float,
    act: int = ACT_IDENTITY,
    s_preact: float | None = None,
) -> QLinearParams:
    """Integer params from float scales (host-side float64, as the reference)."""
    s_w_arr = np.asarray(s_w, np.float64).reshape(-1)
    if act == ACT_GELU:
        if s_preact is None:
            raise ValueError("ACT_GELU needs s_preact")
        real = s_in * s_w_arr / s_preact
    else:
        real = s_in * s_w_arr / s_out
    mult, shift = np_quantize_multiplier(real)
    if mult.size == 1:
        mult_v, shift_v = int(mult[0]), int(shift[0])
    else:
        mult_v, shift_v = torch.from_numpy(mult), torch.from_numpy(shift)
    if act == ACT_GELU:
        gp = make_igelu_params(s_preact)
        qp = make_qparams(gp.out_scale, 1.0, s_out)
        return QLinearParams(mult_v, shift_v, act, gp, qp.mult, qp.shift)
    return QLinearParams(mult_v, shift_v, act)


def qlinear_epilogue(acc: torch.Tensor, p: QLinearParams) -> torch.Tensor:
    """Bias-added int32 accumulator -> int8 output of the activation unit."""
    if _is_dtensor(acc):  # each rank's shard
        from repro_torch.runtime.activations import pointwise_local

        return pointwise_local(lambda a: qlinear_epilogue(a, p), acc)
    if p.act == ACT_IDENTITY:
        return requantize(acc, p.mult, p.shift)
    if p.act == ACT_RELU:
        return requantize(torch.clamp(acc, min=0), p.mult, p.shift)
    if p.act == ACT_GELU:
        pre = requantize(acc, p.mult, p.shift)
        raw = igelu_int(pre, p.gelu)
        return requantize(raw, p.gelu_mult, p.gelu_shift)
    raise ValueError(f"unknown act {p.act}")


def qlinear_i8(
    x_q: torch.Tensor,  # int8 [..., K]
    w_q: torch.Tensor,  # int8 [K, N]
    bias_q: torch.Tensor | None,  # int32 [N], scale s_in*s_w
    p: QLinearParams,
) -> torch.Tensor:
    """int8 -> int8 quantized linear with fused activation epilogue."""
    acc = imatmul(x_q, w_q)
    if bias_q is not None:
        acc = acc + i32(bias_q)
    return qlinear_epilogue(acc, p)


# Float reference -------------------------------------------------------------


def linear_f32(x: torch.Tensor, w: torch.Tensor, bias=None, act: int = ACT_IDENTITY):
    y = x @ w
    if bias is not None:
        y = y + bias
    if act == ACT_RELU:
        y = torch.clamp(y, min=0)
    elif act == ACT_GELU:
        y = gelu_f32(y)
    return y
