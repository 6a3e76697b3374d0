"""Public wrapper of the standalone ITAMax kernel.

On a CUDA tensor it launches ``csrc/itamax.cu``; on a CPU tensor it runs
the plain version (:func:`itamax_ref`), and only there.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core import itamax as im
from repro_torch.kernels import _build
from repro_torch.kernels.itamax.ref import itamax_ref

#: longest row the kernel takes: the row sum stays below 2^23
MAX_ROW = 1 << 15

_LUTS: dict[torch.device, torch.Tensor] = {}


def _lut(device: torch.device) -> torch.Tensor:
    """The 8-bit exp LUT, int32 [32] on ``device``, copied there once."""
    t = _LUTS.get(device)
    if t is None:
        t = _LUTS[device] = im.exp_lut(device)
    return t


@functools.cache
def _lib():
    fn = _build.load("itamax").itamax_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    return fn


def itamax(logits: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Rowwise ITAMax over the last axis: int8 logits -> int8 A in [0, 127]
    (scale 2^-7), bit-exact with ``core.itamax.itamax_rowwise``.

    ``mask`` (bool, True = keep) is taken on CPU tensors only: the kernel,
    like the Pallas kernel it replaces, has none, and a masked call on a
    CUDA tensor raises.
    """
    if logits.device.type == "cpu":
        return itamax_ref(logits, mask=mask)
    if not logits.is_cuda:
        raise RuntimeError(f"itamax runs on cuda or cpu tensors, got {logits.device}")
    if mask is not None:
        raise NotImplementedError("the itamax kernel takes no mask (as the Pallas kernel)")
    if logits.dtype != torch.int8:
        raise TypeError(f"itamax takes int8 logits, got {logits.dtype}")
    *lead, n = logits.shape
    if not 0 < n <= MAX_ROW:
        raise ValueError(f"itamax rows of {n}: the kernel takes 1..{MAX_ROW}")
    r = math.prod(lead)
    dev = logits.device
    x = _build.as_kernel_arg(logits.reshape(r, n))
    out = torch.empty((r, n), dtype=torch.int8, device=dev)
    if r == 0:
        return out.reshape(logits.shape)
    lut = _lut(dev)
    launch = _lib()
    with torch.cuda.device(dev):
        rc = launch(x.data_ptr(), lut.data_ptr(), out.data_ptr(), r, n, _build.stream_of(out))
    _build.check(rc, "itamax")
    itamax.launches += 1
    return out.reshape(logits.shape)


itamax.launches = 0  # kernel launches since the last reset
