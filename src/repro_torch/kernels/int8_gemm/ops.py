"""Public wrapper of the int8 GEMM kernel (scale plumbing + shaping).

On a CUDA tensor it launches ``csrc/int8_gemm.cu``; on a CPU tensor it
runs the plain version (:func:`int8_gemm_ref`), and only there.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.igelu import make_igelu_params
from repro_torch.core.quant_linear import ACT_GELU, ACT_IDENTITY, ACT_RELU
from repro_torch.kernels import _build
from repro_torch.kernels.int8_gemm.ref import int8_gemm_ref
from repro_torch.quant.qparams import make_qparams, np_quantize_multiplier


def _requant_arrays(s_in, s_w_arr, s_out, act, s_preact):
    """Per-channel (mult, shift) as numpy int32 [N] (host-side float64)."""
    real = s_in * s_w_arr / (s_preact if act == ACT_GELU else s_out)
    return np_quantize_multiplier(real)


def _gelu_ints(act, s_preact, s_out) -> tuple[int, int, int, int, int]:
    if act != ACT_GELU:
        return 0, 0, 0, 0, 31
    gp = make_igelu_params(s_preact)
    qp = make_qparams(gp.out_scale, 1.0, s_out)
    return gp.q_b, gp.q_c, gp.q_1, qp.mult, qp.shift


@functools.lru_cache(maxsize=256)
def _device_params(s_in, s_w_bytes, s_out, act, s_preact, n, device):
    """(mult, shift, zero bias) on ``device`` for one set of scales.

    ``s_w_bytes`` is the float64 weight scale (one, or one per channel) as
    bytes, hashable.  The plan's sites repeat a handful of scale sets, so
    the host-side quantization and the copies to the card happen once per
    set (and never inside a CUDA graph capture after the first call).
    """
    s_w = np.frombuffer(s_w_bytes, np.float64)
    if s_w.size == 1:
        s_w = np.full((n,), s_w[0])
    mult, shift = _requant_arrays(s_in, s_w, s_out, act, s_preact)
    return (
        torch.from_numpy(mult).to(device),
        torch.from_numpy(shift).to(device),
        torch.zeros((n,), dtype=torch.int32, device=device),
    )


#: block tiles (BM, BN) the kernel is compiled for, largest first; a warp
#: computes 32x32 of the output (16x32 in the 16-row tile)
GEMM_TILES = ((128, 64), (64, 64), (64, 32), (32, 32), (16, 32))


def gemm_grid(m: int, n: int) -> tuple[int, int, int, int]:
    """(BM, BN, grid_x, grid_y) of a launch: block (x, y) computes rows
    [x*BM, x*BM + BM) and columns [y*BN, y*BN + BN) of the output, clipped
    to (M, N).  The tile is the largest whose grid has at least one block
    per SM (one wave), else the smallest; K does not enter (every tile
    walks all of K)."""
    for bm, bn in GEMM_TILES:
        if -(-m // bm) * -(-n // bn) >= _build.NUM_SMS:
            break
    return bm, bn, -(-m // bm), -(-n // bn)


@functools.cache
def _lib():
    lib = _build.load("int8_gemm")
    fn = lib.int8_gemm_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    return fn


def int8_gemm(
    x_q: torch.Tensor,  # int8 [..., K]
    w_q: torch.Tensor,  # int8 [K, N]
    bias_q: torch.Tensor | None,  # int32 [N] (scale s_in * s_w)
    *,
    s_in: float,
    s_w,  # float or [N] array (per-channel)
    s_out: float,
    act: int = ACT_IDENTITY,
    s_preact: float | None = None,
) -> torch.Tensor:
    """Quantized linear, int8 in and out, ITA GEMM-mode semantics.

    Bit-exact with ``repro_torch.core.quant_linear.qlinear_i8`` at the
    same scales: integer accumulation is associative, so the kernel's
    tiling cannot change a result.  Ragged M, N and K need no padding.
    """
    if act not in (ACT_IDENTITY, ACT_RELU, ACT_GELU):
        raise ValueError(f"unknown act {act}")
    if act == ACT_GELU and s_preact is None:
        raise ValueError("ACT_GELU needs s_preact")
    if x_q.device.type == "cpu":
        return int8_gemm_ref(x_q, w_q, bias_q, s_in=s_in, s_w=s_w, s_out=s_out,
                             act=act, s_preact=s_preact)
    if not x_q.is_cuda:
        raise RuntimeError(f"int8_gemm runs on cuda or cpu tensors, got {x_q.device}")
    *lead, k = x_q.shape
    if w_q.dim() != 2 or w_q.shape[0] != k:
        raise ValueError(f"w_q {tuple(w_q.shape)} does not match K={k}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_gemm takes int8 operands, got {x_q.dtype} and {w_q.dtype}")
    n = w_q.shape[1]
    m = int(np.prod(lead)) if lead else 1
    dev = x_q.device
    if w_q.device != dev or (bias_q is not None and bias_q.device != dev):
        raise ValueError("int8_gemm operands must share one device")

    s_w_arr = np.asarray(s_w, np.float64).reshape(-1)
    if s_w_arr.size not in (1, n):
        raise ValueError(f"s_w has {s_w_arr.size} scales for N={n}")
    mult, shift, zero = _device_params(float(s_in), s_w_arr.tobytes(), float(s_out), act,
                                       s_preact, n, dev)
    bias = zero if bias_q is None else bias_q.to(torch.int32)

    x2 = _build.as_kernel_arg(x_q.reshape(m, k))
    w = _build.as_kernel_arg(w_q)
    bias = _build.as_kernel_arg(bias)
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    launch = _lib()
    with torch.cuda.device(dev):
        rc = launch(x2.data_ptr(), w.data_ptr(), bias.data_ptr(), mult.data_ptr(),
                    shift.data_ptr(), out.data_ptr(), m, n, k, act,
                    *_gelu_ints(act, s_preact, s_out), *gemm_grid(m, n),
                    _build.stream_of(out))
    _build.check(rc, "int8_gemm")
    int8_gemm.launches += 1
    return out.reshape(*lead, n)


int8_gemm.launches = 0  # kernel launches since the last reset
