"""Plain PyTorch version of the standalone i-GeLU kernel."""

from __future__ import annotations

import torch

from repro_torch.core.igelu import igelu_i8


def igelu_ref(x_q: torch.Tensor, *, in_scale: float, out_scale: float) -> torch.Tensor:
    """int8 -> int8 i-GeLU: ``igelu_int`` then the requant onto ``out_scale``."""
    return igelu_i8(x_q, in_scale, out_scale)
