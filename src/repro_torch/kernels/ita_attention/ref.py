"""Plain PyTorch versions of the fused attention kernels: the flash-ITAMax
path, and the same over a paged KV pool (the gathered cache)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.attention import MhaQParams, attention_decode_i8, attention_flash_i8


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


def paged_block_k(block_k: int, rows: int) -> int:
    """The KV block of a paged call over a table of ``rows`` rows:
    ``block_k`` clipped to the rows, or all of them where it does not divide
    them (the reference's fallback; the flash result depends on it)."""
    bk = min(block_k, rows)
    return rows if rows % bk else bk


def lane_offsets(pos, b: int) -> np.ndarray:
    """Host int32 [b]: each lane's offset (a scalar offsets every lane)."""
    pos = np.asarray(pos.cpu() if isinstance(pos, torch.Tensor) else pos, np.int64).reshape(-1)
    return np.ascontiguousarray(np.broadcast_to(pos, (b,)), dtype=np.int32)


def ita_attention_paged_ref(
    q_m: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    pos,
    table,
    *,
    heads: int,
    kv_heads: int,
    head_dim: int,
    s_q: float,
    s_k: float,
    s_v: float,
    s_out: float,
    block_k: int = 512,
) -> torch.Tensor:
    """Plain version of the paged kernel: each lane's blocks gathered in
    table order into a cache ``[B, Hkv, cols * block_size, D]``, under
    ``attention_decode_i8`` with a per-query bound."""
    b, s, _ = q_m.shape
    d = head_dim
    p = MhaQParams.make_flash(s_q, s_k, s_v, s_out, d)
    qh = q_m.reshape(b, s, heads, d).permute(0, 2, 1, 3)  # [B, H, S, D]
    tab = torch.as_tensor(table).to(device=k_pool.device, dtype=torch.long)
    tab = (tab[None] if tab.dim() == 1 else tab).expand(b, tab.shape[-1])
    # rows past the valid prefix (scratch or stale blocks) are masked below,
    # and a fully masked flash update is bit-neutral, so the gathered width
    # does not change the ints
    kg = k_pool[tab].permute(0, 2, 1, 3, 4).reshape(b, kv_heads, -1, d)
    vg = v_pool[tab].permute(0, 2, 1, 3, 4).reshape(b, kv_heads, -1, d)
    # query i sits at global row pos + i and attends rows [0, pos + i]:
    # causality at a chunk offset as a per-query kv_len bound, so decode
    # (S = 1) and chunked prefill share one runner
    rows = lane_offsets(pos, b)[:, None] + np.arange(1, s + 1, dtype=np.int32)
    kv_len = torch.from_numpy(rows).to(q_m.device)[:, None, :, None]
    out = attention_decode_i8(qh, kg, vg, kv_len, p, block_k=paged_block_k(block_k, kg.shape[2]))
    return out.permute(0, 2, 1, 3).reshape(b, s, heads * d)
