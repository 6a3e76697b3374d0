"""Plain PyTorch version of the standalone i-GeLU kernel."""

from __future__ import annotations

import torch

from repro_torch.core.igelu import igelu_int, make_igelu_params
from repro_torch.quant.qparams import make_qparams, requantize


def igelu_ref(x_q: torch.Tensor, *, in_scale: float, out_scale: float) -> torch.Tensor:
    """int8 -> int8 i-GeLU: ``igelu_int`` then the requant onto ``out_scale``."""
    gp = make_igelu_params(in_scale)
    qp = make_qparams(gp.out_scale, 1.0, out_scale)
    return requantize(igelu_int(x_q, gp), qp.mult, qp.shift)
