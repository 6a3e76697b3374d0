"""Public wrapper of the standalone i-GeLU kernel.

On a CUDA tensor it launches ``csrc/igelu.cu``; on a CPU tensor it runs
the plain version (:func:`igelu_ref`), and only there.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.igelu import make_igelu_params
from repro_torch.kernels import _build
from repro_torch.kernels.igelu.ref import igelu_ref
from repro_torch.quant.qparams import make_qparams


#: threads a block
NT = 256


def igelu_grid(n: int) -> tuple[int, int]:
    """(blocks, 16-byte words per thread per round) of a launch over ``n``
    elements.  Every block builds the 256-entry table first, so the grid
    grows to one block per SM before any thread takes a second word, and
    each thread takes up to 3 words a round (all its loads in flight at
    once) before the grid grows past that to the blocks that are resident
    at once; a grid-stride loop takes the rest.  Words are dealt out
    round-robin over the grid's threads, so every SM gets the same share."""
    if n < 0:
        raise ValueError(f"igelu over {n} elements")
    n_vec = n // 16
    blocks = max(1, min(-(-n_vec // NT), _build.NUM_SMS))
    wpt = max(1, min(3, -(-n_vec // (blocks * NT))))
    if n_vec > blocks * NT * wpt:
        blocks = min(-(-n_vec // (NT * wpt)), _build.NUM_SMS * (2048 // NT))
    return blocks, wpt


@functools.cache
def _lib():
    fn = _build.load("igelu").igelu_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    return fn


def igelu(x_q: torch.Tensor, *, in_scale: float, out_scale: float) -> torch.Tensor:
    """Elementwise i-GeLU of int8 ``x_q`` (any shape) onto ``out_scale``,
    bit-exact with :func:`igelu_ref`.  The constants come from
    ``make_igelu_params(in_scale)`` and the requant from
    ``make_qparams(gelu.out_scale, 1.0, out_scale)``, as in the JAX
    package's wrapper; unlike it, no shape restriction applies."""
    if x_q.device.type == "cpu":
        return igelu_ref(x_q, in_scale=in_scale, out_scale=out_scale)
    if not x_q.is_cuda:
        raise RuntimeError(f"igelu runs on cuda or cpu tensors, got {x_q.device}")
    if x_q.dtype != torch.int8:
        raise TypeError(f"igelu takes int8, got {x_q.dtype}")
    gp = make_igelu_params(in_scale)
    qp = make_qparams(gp.out_scale, 1.0, out_scale)
    dev = x_q.device
    x = _build.as_kernel_arg(x_q)
    out = torch.empty(x_q.shape, dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    launch = _lib()
    with torch.cuda.device(dev):
        rc = launch(x.data_ptr(), out.data_ptr(), x.numel(), gp.q_b, gp.q_c, gp.q_1,
                    qp.mult, qp.shift, *igelu_grid(x.numel()), _build.stream_of(out))
    _build.check(rc, "igelu")
    igelu.launches += 1
    return out


igelu.launches = 0  # kernel launches since the last reset
