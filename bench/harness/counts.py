"""Operations and bytes of the work, counted from the configuration's shapes,
and the card's peaks: what the rooflines and ``mfu`` divide by.

Each input byte is read once and each output byte written once, whatever
a kernel reads again.  An integer multiply-add is two operations.  Peaks
of one H100 SXM at its full 700 W (NVIDIA's data sheet, dense): 1979
TOP/s int8, 3.35 TB/s of HBM.
"""

from __future__ import annotations

PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES)


def gemm(m: int, k: int, n: int, bias: bool) -> tuple[int, int]:
    """``int8_gemm``: int8 x [M, K] and w [K, N] in, int8 [M, N] out, an
    int32 bias [N] where the site has one."""
    return 2 * m * k * n, m * k + k * n + m * n + (4 * n if bias else 0)


def decoder_chunk_calls(arch: dict, lanes: int, seq: int) -> list:
    """The ``int8_gemm`` calls of one batched prefill-chunk dispatch: Q, K,
    V, O, gate, up and down per layer over ``lanes`` x ``seq`` rows."""
    m, d, f = lanes * seq, arch["d_model"], arch["d_ff"]
    h, hkv, hd = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    bias = bool(arch.get("qkv_bias"))
    layer = [gemm(m, d, h * hd, bias), gemm(m, d, hkv * hd, bias), gemm(m, d, hkv * hd, bias),
             gemm(m, h * hd, d, False), gemm(m, d, f, False), gemm(m, d, f, False),
             gemm(m, f, d, False)]
    return layer * arch["n_layers"]


def decoder_rows_ops(arch: dict, lo: int, hi: int) -> int:
    """The products the tokens at context rows [lo, hi) need in the layers:
    every projection, and attention's two over each row's ``row + 1`` keys."""
    if hi <= lo:
        return 0
    n = hi - lo
    d, f = arch["d_model"], arch["d_ff"]
    h, hkv, hd = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    gemms = 2 * (d * (h + 2 * hkv) * hd + h * hd * d + 3 * d * f)
    keys = (lo + 1 + hi) * n // 2  # sum of (row + 1)
    return arch["n_layers"] * (gemms * n + 4 * h * hd * keys)


def decoder_head_ops(arch: dict) -> int:
    """The LM head of one row."""
    return 2 * arch["d_model"] * arch["vocab"]
