"""AdamW + schedules + gradient clipping — functional, over the port's params trees.

The optimizer state is a tree matching ``params`` (nested dicts and lists,
as ``convert.tree_map`` walks them) with the JAX package's layout:
``AdamWState(step, mu, nu)``, an int32 step and float32 moments, so a
checkpoint of ``(params, state)`` holds the same keys in either package.
``torch.optim.AdamW`` is not used: its state and its rounding order
differ.

One deliberate difference: the JAX package's training step donates its
params and state to ``jax.jit`` (``donate_argnums=(0, 1)``); here
:func:`apply` updates them in place under ``torch.no_grad()`` and returns
the same tensors it was given.  Each element goes through the
reference's operations in the reference's order (the clip scale cast to
the gradient's dtype first, float32 bias corrections, weight decay on
every leaf), one rounding per operation: no fused multiply-add.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.convert import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: dict
    nu: dict


def init(params) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    device = next(tree_leaves(params)).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device), mu=zeros,
                      nu=tree_map(torch.clone, zeros))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in tree_leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


@torch.no_grad()
def apply(
    grads,
    state: AdamWState,
    params,
    lr,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
):
    """One AdamW update. Returns (params, state, metrics): the same params
    and moment tensors, updated in place, and the incremented step."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_grad_norm)
    step = state.step.add_(1)
    b1c = 1.0 - b1 ** step.to(torch.float32)
    b2c = 1.0 - b2 ** step.to(torch.float32)
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu),
                          tree_leaves(params)):
        g = (g * scale.to(g.dtype)).to(torch.float32)  # clip_by_global_norm
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * (1 - b2) * g)
        delta = (m / b1c).div_(torch.sqrt(v / b2c).add_(eps))
        delta.add_(p.to(torch.float32) * weight_decay)
        p.copy_(p.to(torch.float32) - delta.mul_(lr))
    return params, state, {"grad_norm": gnorm}


# -- schedules ---------------------------------------------------------------

def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    step = step.to(torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)
