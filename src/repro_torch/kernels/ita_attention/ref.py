"""Plain PyTorch version of the fused attention kernel: the flash-ITAMax path."""

from __future__ import annotations

import torch

from repro_torch.core.attention import MhaQParams, attention_flash_i8


def ita_attention_ref(
    q_q: torch.Tensor,
    k_q: torch.Tensor,
    v_q: torch.Tensor,
    *,
    s_q: float,
    s_k: float,
    s_v: float,
    s_out: float,
    causal: bool = False,
    block_k: int = 512,
    kv_valid: int | None = None,
) -> torch.Tensor:
    d = q_q.shape[-1]
    p = MhaQParams.make_flash(s_q, s_k, s_v, s_out, d)
    block_k = min(block_k, k_q.shape[2])
    return attention_flash_i8(q_q, k_q, v_q, p, causal=causal, block_k=block_k, kv_len=kv_valid)
