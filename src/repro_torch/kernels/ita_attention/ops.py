"""Public wrappers of the fused ITA attention kernel.

On CUDA tensors they launch ``csrc/ita_attention.cu``; on CPU tensors
they run the plain flash-ITAMax version, and only there.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import itamax as im
from repro_torch.core.attention import MhaQParams
from repro_torch.kernels import _build
from repro_torch.kernels.ita_attention.ref import ita_attention_ref

_LUTS: dict[torch.device, torch.Tensor] = {}


def _luts(device: torch.device) -> torch.Tensor:
    """The kernel's tables, int32 [96] on ``device``: the 7-bit exponential
    at every t = m - l that int8 logits give (t in [0, 255], values in [0,
    127]), four bytes to a word, then the 10-bit renorm LUT."""
    t = _LUTS.get(device)
    if t is None:
        exp_t = im._exp2_int(torch.arange(256, dtype=torch.int32), im.exp_lut7(),
                             im.EXP_LUT7_BITS)
        words = exp_t.to(torch.uint8).view(torch.int32)
        t = torch.cat([words, im.renorm_lut()]).to(device)
        _LUTS[device] = t
    return t


#: the kernel's geometry (csrc/ita_attention.cu): keys per staged K/V
#: sub-tile, output columns per block, the deepest sub-tile ring, and the
#: dynamic shared bytes a block may take
KV_SUBTILE, OUT_COLS, RING_SLOTS = 128, 64, 4
SMEM_MAX = 227 * 1024 - 384


def attn_smem(groups: int, block_k: int, d: int, slots: int) -> int:
    """Dynamic shared bytes of a block of ``groups`` row groups with a ring
    of ``slots`` sub-tiles (mirrors the kernel's ``make_layout``): the Q
    tile, one int8 logits row of the padded KV block per query row, one
    sub-tile of P per row group, the row max / row sum exchange, the ring."""
    dp = -(-d // 32) * 32
    bkp = -(-block_k // KV_SUBTILE) * KV_SUBTILE
    rows = 16 * groups
    return (rows * dp + rows * (bkp + 16) + rows * KV_SUBTILE + groups * 256
            + slots * KV_SUBTILE * max(dp, OUT_COLS))


def attn_grid(bh: int, sq: int, d: int, block_k: int) -> tuple[int, int, int, int, int]:
    """(row groups per block, warps per row group, ring slots, grid_x,
    grid_y) of a launch.  A row group is 16 query rows; block x computes
    row groups [(x % T) * G, +G) of head x // T (T = ceil(Sq / 16G)), block
    y output columns [64y, 64y + 64), clipped to (Sq, D).

    A block has four warps.  Under eight 16-row tiles per SM, a row group
    gets two of them, which split its keys and its output columns (more
    warps to hide each other's latency, half the serial work each).  Wide
    heads take fewer row groups, then a shallower ring, to fit the shared
    memory."""
    gy = -(-d // OUT_COLS)
    tiles = -(-sq // 16)
    split = 2 if bh * tiles * gy < 8 * _build.NUM_SMS else 1
    for groups in range(min(4 // split, tiles), 0, -1):
        for slots in range(RING_SLOTS, 1, -1):
            if attn_smem(groups, block_k, d, slots) <= SMEM_MAX:
                return groups, split, slots, bh * -(-sq // (16 * groups)), gy
    raise ValueError(f"head_dim {d} with block_k {block_k} needs "
                     f"{attn_smem(1, block_k, d, 2)} bytes of shared memory")


@functools.cache
def _lib():
    lib = _build.load("ita_attention")
    fn = lib.ita_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 17 + [ctypes.c_void_p]
    return fn


def ita_attention(
    q_q: torch.Tensor,  # int8 [B, H, Sq, D]
    k_q: torch.Tensor,  # int8 [B, Hkv, Sk, D]
    v_q: torch.Tensor,  # int8 [B, Hkv, Sk, D]
    *,
    s_q: float,
    s_k: float,
    s_v: float,
    s_out: float,
    causal: bool = False,
    block_k: int = 512,
    kv_valid: int | None = None,
) -> torch.Tensor:
    """Fused int8 MHA with streaming ITAMax. Returns int8 [B, H, Sq, D].

    Bit-exact with ``attention_flash_i8`` at the same ``block_k``;
    ``kv_valid`` masks KV rows a caller padded.
    """
    if q_q.device.type == "cpu":
        return ita_attention_ref(q_q, k_q, v_q, s_q=s_q, s_k=s_k, s_v=s_v, s_out=s_out,
                                 causal=causal, block_k=block_k, kv_valid=kv_valid)
    if not q_q.is_cuda:
        raise RuntimeError(f"ita_attention runs on cuda or cpu tensors, got {q_q.device}")
    b, h, sq, d = q_q.shape
    _, hkv, sk, _ = k_q.shape
    block_k = min(block_k, sk)
    if h % hkv:
        raise ValueError(f"{h} heads are not a multiple of {hkv} KV heads")
    if sk % block_k:
        raise ValueError(f"Sk={sk} is not a multiple of block_k={block_k}")
    if any(t.dtype != torch.int8 for t in (q_q, k_q, v_q)):
        raise TypeError("ita_attention takes int8 q, k, v")
    if d % 4 or block_k % 4:
        raise ValueError(f"head_dim {d} and block_k {block_k} must be multiples of 4")
    p = MhaQParams.make_flash(s_q, s_k, s_v, s_out, d)
    dev = q_q.device
    # [B, H, S, D] -> [B*H, S, D]: query head bh reads KV head bh // (H // Hkv)
    q3, k3, v3 = (_build.as_kernel_arg(t.reshape(-1, t.shape[2], d)) for t in (q_q, k_q, v_q))
    out = torch.empty((b * h, sq, d), dtype=torch.int8, device=dev)
    launch = _lib()
    with torch.cuda.device(dev):
        rc = launch(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), _luts(dev).data_ptr(), out.data_ptr(),
            b * h, sq, sk, d, h // hkv, int(p.logit_mult), int(p.logit_shift),
            int(p.out_mult), int(p.out_shift), int(causal), block_k,
            sk if kv_valid is None else int(kv_valid), *attn_grid(b * h, sq, d, block_k),
            _build.stream_of(out),
        )
    _build.check(rc, "ita_attention")
    ita_attention.launches += 1
    return out.reshape(b, h, sq, d)


ita_attention.launches = 0  # kernel launches since the last reset (ita_decode included)


def ita_decode(
    q_q: torch.Tensor,  # int8 [B, H, 1, D] — one new token per sequence
    k_cache: torch.Tensor,  # int8 [B, Hkv, Smax, D]
    v_cache: torch.Tensor,  # int8 [B, Hkv, Smax, D]
    cache_len: int,  # valid prefix of the cache
    *,
    s_q: float,
    s_k: float,
    s_v: float,
    s_out: float,
    block_k: int = 512,
) -> torch.Tensor:
    """One decode step: the query heads sharing a KV head become the query
    rows of one attention problem, and ``kv_valid`` masks the unfilled tail."""
    b, h, sq, d = q_q.shape
    if sq != 1:
        raise ValueError("decode takes exactly one new token")
    _, hkv, smax, _ = k_cache.shape
    g = h // hkv
    out = ita_attention(
        q_q.reshape(b * hkv, 1, g, d), k_cache.reshape(b * hkv, 1, smax, d),
        v_cache.reshape(b * hkv, 1, smax, d), s_q=s_q, s_k=s_k, s_v=s_v, s_out=s_out,
        block_k=block_k, kv_valid=cache_len,
    )
    return out.reshape(b, h, 1, d)
