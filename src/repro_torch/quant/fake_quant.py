"""Fake quantization for QAT — straight-through estimator (torch port).

Training runs in float with quantization noise injected at every site the
int8 deployment quantizes (weights, activations, attention logits on the
ITAMax grid).  The forward value equals the dequantized int8 value; the
gradient passes through unchanged inside the representable range and is
zero outside it.  ``jax.lax.stop_gradient`` becomes ``.detach()``, so the
forward values are the JAX package's operation for operation.
"""

from __future__ import annotations

import torch

from repro_torch.core.itamax import ITAMAX_LOGIT_SCALE
from repro_torch.quant.qparams import INT8_MAX, INT8_MIN


def fake_quant(x: torch.Tensor, scale, qmin: int = INT8_MIN, qmax: int = INT8_MAX):
    """STE fake-quantize: forward = dequant(quant(x)), grad = 1 inside range."""
    scale = torch.as_tensor(scale, device=x.device).to(x.dtype)
    q = torch.clamp(torch.round(x / scale), qmin, qmax)
    y = q * scale
    inside = (x >= qmin * scale) & (x <= qmax * scale)
    y_ste = x + (y - x).detach()
    return torch.where(inside, y_ste, y.detach())


def fake_quant_weight(w: torch.Tensor, per_channel_axis: int | None = None) -> torch.Tensor:
    """Symmetric weight fake-quant with scale from the current absmax (no
    gradient flows through the scale); per channel along
    ``per_channel_axis`` when given (compared as given, as in the JAX
    package)."""
    if per_channel_axis is None:
        absmax = torch.amax(torch.abs(w))
    else:
        red = tuple(i for i in range(w.dim()) if i != per_channel_axis)
        absmax = torch.amax(torch.abs(w), dim=red, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    return fake_quant(w, scale.detach(), -127, 127)


def fake_quant_logits(logits: torch.Tensor) -> torch.Tensor:
    """Quantization noise on the ITAMax logit grid (B=5): the QAT model
    sees exactly the +-127 * ln2/32 dynamic range the ASIC sees."""
    return fake_quant(logits, ITAMAX_LOGIT_SCALE)
