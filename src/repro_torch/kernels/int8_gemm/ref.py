"""Plain PyTorch version of the int8 GEMM kernel: the ``w8a8`` quantized linear."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import quant_linear as ql


def int8_gemm_ref(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    bias_q: torch.Tensor | None,
    *,
    s_in: float,
    s_w,
    s_out: float,
    act: int = ql.ACT_IDENTITY,
    s_preact: float | None = None,
) -> torch.Tensor:
    n = w_q.shape[1]
    s_w_arr = np.asarray(s_w, np.float64).reshape(-1)
    if s_w_arr.size == 1:
        s_w_arr = np.full((n,), s_w_arr[0])
    p = ql.make_qlinear_params(s_in, s_w_arr, s_out, act, s_preact=s_preact)
    return ql.qlinear_i8(x_q, w_q, bias_q, p)
