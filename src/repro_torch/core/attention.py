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
* :func:`attention_f32` / :func:`attention_f32_chunked` — the float
  references (einsum and a float32 softmax, as the JAX package writes
  them; not ``scaled_dot_product_attention``, whose backend picks its own
  arithmetic).

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
from repro_torch.runtime.activations import constrain

try:
    from torch.distributed.tensor import DTensor
except ImportError:  # a torch built without distributed support
    DTensor = ()

NEG_MASK_I32 = -(1 << 20)


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
    *,
    q_offset: int | None = None,
) -> torch.Tensor:
    """Flash-ITAMax attention: KV blocks in order, ``block_k`` rows each.
    ``q_offset``: the global position of query 0 (default ``Sk - Sq``,
    causal alignment)."""
    b, h, sq, d = q_q.shape
    hkv, sk = k_q.shape[1], k_q.shape[2]
    if isinstance(q_q, DTensor) or isinstance(k_q, DTensor):
        # Head-parallel (sequence-parallel queries for heads that do not
        # divide the model axis), on each rank's shards: only q is split;
        # K/V's seq dim is the walked dim
        q_off = sk - sq if q_offset is None else q_offset
        per_row = isinstance(kv_len, torch.Tensor) and kv_len.dim() == 4 and kv_len.shape[0] == b
        return _on_local_heads(
            lambda q, k, v, q0, *lens: attention_flash_i8(
                q, k, v, p, causal=causal, block_k=block_k,
                kv_len=lens[0] if per_row else kv_len, q_offset=q_off + q0),
            q_q, k_q, v_q, extra=(kv_len,) if per_row else ())
    k_q = _repeat_kv(k_q, h // hkv)
    v_q = _repeat_kv(v_q, h // hkv)
    # Head-parallel (seq fallback for odd GQA). Only q: K/V's seq dim is
    # the walked dim — sharding it would gather per KV block.
    q_q = constrain(q_q, "heads")
    if sk % block_k:
        raise ValueError(f"Sk={sk} is not a multiple of block_k={block_k}")
    dev = q_q.device
    state = im.flash_init((b, h, sq), d, device=dev)
    # causal alignment: query i is global position i + q_off
    q_off = sk - sq if q_offset is None else q_offset
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


# Float reference -------------------------------------------------------------


def _on_local_heads(fn, q, k, v, extra=()):
    """``fn(q, k, v, q0, *extra)`` on each rank's shards of DTensor inputs
    (``activations.local_shards``), as GSPMD partitions the attention of
    the JAX package: batch rows over the data axes; query heads over
    "model" where it divides them, else query positions (``q0``: the
    global position of a rank's first query; ``extra``: [B, ...] tensors
    split by batch row); each rank holds the K/V heads that its own query
    heads use (shards where "model" divides the K/V heads too, else the
    whole K/V, from which it takes them: 8 K/V heads over 16 ranks give
    query heads 4r..4r+3 their K/V head r // 2).  The result equals the
    unsharded one, element for element.  (Run as DTensor ops, einsum's
    batched products view two sharded dims as one, which DTensor 2.11
    refuses.)"""
    from repro_torch.runtime.activations import active_mesh, fits, local_shards
    from repro_torch.runtime.sharding import P, axis_names, data_axes

    mesh = active_mesh() or next(t.device_mesh for t in (q, k, v) if isinstance(t, DTensor))
    names = axis_names(mesh)
    b, h, sq = q.shape[:3]
    hkv = k.shape[1]
    b_ax = data_axes(mesh)
    b_ax = b_ax if fits(b, b_ax, mesh) else None
    m = names.index("model") if "model" in names else None
    n = mesh.size(m) if m is not None else 1
    h_ax = "model" if n > 1 and fits(h, "model", mesh) else None
    s_ax = "model" if n > 1 and h_ax is None and fits(sq, "model", mesh) else None
    kv_ax = h_ax if h_ax and fits(hkv, "model", mesh) else None
    r = mesh.get_local_rank(m) if n > 1 else 0
    q0 = r * (sq // n) if s_ax else 0
    per, rep = h // n, h // hkv

    def run(q, k, v, *ex):
        if h_ax and not kv_ax:  # the K/V head of each local query head
            sel = torch.arange(r * per, (r + 1) * per, device=k.device) // rep
            k, v = k.index_select(1, sel), v.index_select(1, sel)
        return fn(q, k, v, q0, *ex)

    q_spec = P(b_ax, h_ax, s_ax, None)
    kv_spec = P(b_ax, kv_ax, None, None)
    ex_specs = tuple(P(b_ax, *([None] * (t.dim() - 1))) for t in extra)
    return local_shards(run, (q, k, v, *extra), (q_spec, kv_spec, kv_spec, *ex_specs), q_spec,
                        mesh=mesh)


def attention_f32_chunked(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Sk, D]
    v: torch.Tensor,
    causal: bool = False,
    block_q: int = 1024,
    logit_clip: float | None = None,
    *,
    q_offset: int | None = None,
) -> torch.Tensor:
    """Float attention one block of ``block_q`` queries at a time (a full
    softmax row per query): never holds the S x S logits at once.
    ``q_offset``: the global position of query 0 (default ``Sk - Sq``)."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    q_off = sk - sq if q_offset is None else q_offset
    if isinstance(q, DTensor):
        return _on_local_heads(lambda q, k, v, q0: attention_f32_chunked(
            q, k, v, causal=causal, block_q=block_q, logit_clip=logit_clip,
            q_offset=q_off + q0), q, k, v)
    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    if sq % block_q:
        return attention_f32(q, k, v, causal=causal, logit_clip=logit_clip, q_offset=q_off)
    scale = 1.0 / math.sqrt(d)
    outs = []
    for i0 in range(0, sq, block_q):
        logits = torch.einsum("bhqd,bhkd->bhqk", q[:, :, i0:i0 + block_q], k) * scale
        if logit_clip is not None:
            logits = torch.clamp(logits, -logit_clip, logit_clip)
        if causal:
            keep = _causal_mask(block_q, sk, i0 + q_off, q.device)
            logits = torch.where(keep, logits, torch.finfo(logits.dtype).min)
        a = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", a, v))
    return torch.cat(outs, dim=2)


def attention_f32(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Sk, D]
    v: torch.Tensor,
    causal: bool = False,
    mask: torch.Tensor | None = None,
    logit_clip: float | None = None,
    *,
    q_offset: int | None = None,
) -> torch.Tensor:
    """Standard float attention; ``logit_clip`` mimics the int8 logit range
    (+- 127 * ITAMAX_LOGIT_SCALE) for QAT parity with the integer path.
    ``q_offset``: the global position of query 0 (default ``Sk - Sq``)."""
    sq, sk = q.shape[2], k.shape[2]
    q_off = sk - sq if q_offset is None else q_offset
    if isinstance(q, DTensor) and mask is None:
        return _on_local_heads(lambda q, k, v, q0: attention_f32(
            q, k, v, causal=causal, logit_clip=logit_clip, q_offset=q_off + q0), q, k, v)
    h, hkv = q.shape[1], k.shape[1]
    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if logit_clip is not None:
        logits = torch.clamp(logits, -logit_clip, logit_clip)
    neg = torch.finfo(logits.dtype).min
    if causal:
        logits = torch.where(_causal_mask(sq, sk, q_off, q.device), logits, neg)
    if mask is not None:
        logits = torch.where(mask, logits, neg)
    a = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", a, v)
