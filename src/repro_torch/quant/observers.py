"""Calibration observers (QuantLib analogue), torch port.

An observer state is a small NamedTuple of tensors, updated per
calibration batch; the PTQ flow threads it through a tapped float forward
pass and turns the final state into activation scales.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.quant.qparams import INT8_MAX


class AbsMaxState(NamedTuple):
    absmax: torch.Tensor  # scalar float32

    @staticmethod
    def init(device=None) -> "AbsMaxState":
        return AbsMaxState(absmax=torch.zeros((), dtype=torch.float32, device=device))


def absmax_update(state: AbsMaxState, x: torch.Tensor) -> AbsMaxState:
    m = torch.amax(torch.abs(x)).to(torch.float32)
    return AbsMaxState(torch.maximum(state.absmax, m.to(state.absmax.device)))


def absmax_scale(state: AbsMaxState, qmax: int = INT8_MAX, margin: float = 1.0) -> torch.Tensor:
    return torch.clamp(state.absmax * margin, min=1e-8) / qmax


class EmaAbsMaxState(NamedTuple):
    """EMA of per-batch absmax — robust to single-batch outliers."""

    value: torch.Tensor
    initialized: torch.Tensor

    @staticmethod
    def init(device=None) -> "EmaAbsMaxState":
        return EmaAbsMaxState(torch.zeros((), dtype=torch.float32, device=device),
                              torch.zeros((), dtype=torch.bool, device=device))


def ema_absmax_update(state: EmaAbsMaxState, x: torch.Tensor,
                      decay: float = 0.9) -> EmaAbsMaxState:
    m = torch.amax(torch.abs(x)).to(torch.float32).to(state.value.device)
    new = torch.where(state.initialized, decay * state.value + (1 - decay) * m, m)
    return EmaAbsMaxState(new, torch.ones_like(state.initialized))


def percentile_scale(x: torch.Tensor, pct: float = 99.9, qmax: int = INT8_MAX) -> torch.Tensor:
    """One-shot percentile calibration (clips outliers).

    ``jnp.percentile``'s linear interpolation in float32: the rank ``pct /
    100 * (n - 1)``, the two order statistics around it (``kthvalue``: no
    size limit, where ``torch.quantile`` refuses more than 2^24 elements)
    and ``low * (1 - w) + high * w``.  XLA may round the rank one ulp
    apart, so the two packages agree within that, not bit for bit.
    """
    v = torch.abs(x).reshape(-1).to(torch.float32)
    n = v.numel()
    rank = (torch.tensor(pct, dtype=torch.float32) / 100) * (torch.tensor(n, dtype=torch.float32)
                                                             - 1)
    lo, hi = torch.floor(rank), torch.ceil(rank)
    w_hi = rank - lo
    w_lo = 1 - w_hi
    at = lambda r: torch.kthvalue(v, int(r.clamp(0, n - 1)) + 1).values.cpu()  # noqa: E731
    p = at(lo) * w_lo + at(hi) * w_hi
    return (torch.clamp(p, min=1e-8) / qmax).to(v.device)
