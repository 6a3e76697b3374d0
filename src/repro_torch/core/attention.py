"""Quantized multi-head attention assembled from ITA's primitives, torch port.

* :func:`attention_rowwise_i8` — the paper-faithful dataflow: int8
  ``Q K^T`` -> requant onto the ITAMax logit grid -> rowwise ITAMax
  (8-bit A) -> int8 ``A V`` -> requant (the ``w8a8`` backend).  The two
  products are exact integer products on any device (``imatmul``); the
  softmax stage is the ``itamax`` wrapper, which launches its kernel on
  the card and runs ``core.itamax.itamax_rowwise`` on the CPU.
* :func:`attention_flash_i8` — single pass over KV blocks with the
  flash-ITAMax state; the plain version of the ``ita_attention`` kernel,
  bit-exact with it at equal ``block_k``.
* :func:`attention_decode_i8` — the flash path against an int8 KV cache,
  masked per request past its valid rows (the decoder's cached attention).

GQA repeats KV heads; 1/sqrt(d_head) and all scales fold into the logit
requantization multiplier.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import itamax as im
from repro_torch.kernels.itamax import itamax
from repro_torch.quant.qparams import imatmul, make_qparams, requantize


class MhaQParams(NamedTuple):
    logit_mult: int
    logit_shift: int
    out_mult: int
    out_shift: int

    @staticmethod
    def make(s_q: float, s_k: float, s_v: float, s_out: float, d_head: int) -> "MhaQParams":
        lq = make_qparams(s_q, s_k / math.sqrt(d_head), im.ITAMAX_LOGIT_SCALE)
        oq = make_qparams(im.A_SCALE, s_v, s_out)
        return MhaQParams(lq.mult, lq.shift, oq.mult, oq.shift)

    @staticmethod
    def make_flash(s_q: float, s_k: float, s_v: float, s_out: float, d_head: int) -> "MhaQParams":
        lq = make_qparams(s_q, s_k / math.sqrt(d_head), im.ITAMAX_LOGIT_SCALE)
        # flash finalize yields Q7.7 in units of s_v
        oq = make_qparams(2.0 ** (-7), s_v, s_out)
        return MhaQParams(lq.mult, lq.shift, oq.mult, oq.shift)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=1)


def _causal_mask(sq: int, sk: int, q_offset: int, device) -> torch.Tensor:
    """True = attend. Query i attends keys j <= i + q_offset."""
    qi = torch.arange(sq, device=device)[:, None]
    kj = torch.arange(sk, device=device)[None, :]
    return kj <= qi + q_offset


def attention_rowwise_i8(
    q_q: torch.Tensor,  # int8 [B, H, Sq, D]
    k_q: torch.Tensor,  # int8 [B, Hkv, Sk, D]
    v_q: torch.Tensor,  # int8 [B, Hkv, Sk, D]
    p: MhaQParams,
    causal: bool = False,
    mask: torch.Tensor | None = None,  # bool, broadcastable to [B,H,Sq,Sk]
) -> torch.Tensor:
    """Paper-faithful ITA attention (full logits row). Returns int8.

    On CUDA tensors the softmax stage is the ``itamax`` kernel, which takes
    no mask: a causal or masked call raises there.
    """
    h, hkv = q_q.shape[1], k_q.shape[1]
    k_q = _repeat_kv(k_q, h // hkv)
    v_q = _repeat_kv(v_q, h // hkv)
    acc = imatmul(q_q, k_q.transpose(-1, -2))
    logits = requantize(acc, p.logit_mult, p.logit_shift)
    full_mask = None
    if causal:
        sq, sk = q_q.shape[2], k_q.shape[2]
        full_mask = _causal_mask(sq, sk, sk - sq, q_q.device)
    if mask is not None:
        full_mask = mask if full_mask is None else (full_mask & mask)
    a = itamax(logits, mask=full_mask)
    out = imatmul(a, v_q)
    return requantize(out, p.out_mult, p.out_shift)


def attention_flash_i8(
    q_q: torch.Tensor,  # int8 [B, H, Sq, D]
    k_q: torch.Tensor,  # int8 [B, Hkv, Sk, D]
    v_q: torch.Tensor,  # int8 [B, Hkv, Sk, D]
    p: MhaQParams,
    causal: bool = False,
    block_k: int = 512,
    kv_len=None,  # valid KV length: int, or int32 tensor broadcastable to [B,H,Sq,1]
) -> torch.Tensor:
    """Flash-ITAMax attention: KV blocks in order, ``block_k`` rows each."""
    b, h, sq, d = q_q.shape
    hkv, sk = k_q.shape[1], k_q.shape[2]
    k_q = _repeat_kv(k_q, h // hkv)
    v_q = _repeat_kv(v_q, h // hkv)
    if sk % block_k:
        raise ValueError(f"Sk={sk} is not a multiple of block_k={block_k}")
    dev = q_q.device
    state = im.flash_init((b, h, sq), d, device=dev)
    q_off = sk - sq  # causal alignment: query i is global position i + q_off
    k_t = k_q.transpose(-1, -2)
    for j0 in range(0, sk, block_k):
        acc = imatmul(q_q, k_t[..., j0 : j0 + block_k])
        logits = requantize(acc, p.logit_mult, p.logit_shift)
        mask = None
        if causal or kv_len is not None:
            kj = torch.arange(j0, j0 + block_k, device=dev)[None, :]
            mask = torch.ones((sq, block_k), dtype=torch.bool, device=dev)
            if causal:
                qi = torch.arange(sq, device=dev)[:, None]
                mask = mask & (kj <= qi + q_off)
            if kv_len is not None:
                mask = mask & (kj < kv_len)
            mask = torch.broadcast_to(mask, (b, h, sq, block_k))
        state = im.flash_block_update(state, logits, v_q[:, :, j0 : j0 + block_k], mask)
    q77 = im.flash_finalize_q77(state)
    return requantize(q77, p.out_mult, p.out_shift)


def attention_decode_i8(
    q_q: torch.Tensor,  # int8 [B, H, Sq, D]
    k_cache: torch.Tensor,  # int8 [B, Hkv, Smax, D]
    v_cache: torch.Tensor,  # int8 [B, Hkv, Smax, D]
    cache_len,  # valid cache rows: int, or int32 tensor [] / [B] / broadcastable
    p: MhaQParams,
    block_k: int = 2048,
) -> torch.Tensor:
    """Decode against an int8 KV cache: the flash path with the rows past
    ``cache_len`` masked (a [B] length is one per request)."""
    kv_len = cache_len
    if isinstance(cache_len, torch.Tensor):
        kv_len = cache_len.to(device=q_q.device, dtype=torch.int32)
        if kv_len.dim() == 1:
            kv_len = kv_len[:, None, None, None]
    return attention_flash_i8(q_q, k_cache, v_cache, p, causal=False, block_k=block_k,
                              kv_len=kv_len)
