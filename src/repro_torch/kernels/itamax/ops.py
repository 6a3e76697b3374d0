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

#: the kernel's geometry (csrc/itamax.cu): threads a block, the per-lane
#: weight table (256 ints for each of 32 lanes), the most 16-byte chunks a
#: lane holds, the dynamic shared bytes a block may take, and the shared
#: memory of one SM (each resident block reserves 1 KB more)
NT = 256
TAB_BYTES = 256 * 32 * 4
MAX_CH = 9
SMEM_MAX = 227 * 1024
SMEM_SM = 228 * 1024


def _chunks_spanned(n: int) -> int:
    """16-byte chunks one row of ``n`` bytes may span (rows start aligned
    when 16 divides n)."""
    return n // 16 if n % 16 == 0 else (n + 30) // 16


#: chunks a lane takes at most when fewer lanes a row still fill the card
LANE_CHUNKS = 4


def itamax_lanes(r: int, n: int) -> int:
    """Lanes per row.  Rows of more than 8 chunks a lane at 32 lanes take
    the whole block (NT lanes).  Otherwise the fewest lanes (a power of
    two) that give each lane at most LANE_CHUNKS of the row's chunks while
    the ``r`` rows still make a step for every SM: a step's fixed work
    (copies, barriers, two reductions and a division per row) is then
    spread over more elements a lane."""
    nc = _chunks_spanned(n)
    lanes = 1
    while lanes < 32 and lanes < nc:
        lanes *= 2
    if -(-nc // lanes) > 8:
        return NT
    while (lanes > 1 and -(-nc // (lanes // 2)) <= LANE_CHUNKS
           and -(-r // (NT // (lanes // 2))) >= _build.NUM_SMS):
        lanes //= 2
    return lanes


def itamax_smem(n: int, lanes: int) -> int:
    """Dynamic shared bytes (mirrors the kernel's ``geometry``): the table
    and two staging buffers, each the aligned chunks of NT / lanes rows."""
    return TAB_BYTES + 2 * 16 * ((NT // lanes * n + 30) // 16)


def itamax_rows_per_block(r: int, n: int, lanes: int) -> int:
    """Rows per block at ``lanes`` lanes a row: a multiple of the NT / lanes
    rows a block stages at a time and of 16 / gcd(n, 16), so every block's
    run of bytes starts 16-byte aligned, and as few as give one wave of
    resident blocks (each builds the 32 KB table once), up to 2^30 bytes a
    block."""
    unit = math.lcm(NT // lanes, 16 // math.gcd(n, 16))
    per_sm = min(2048 // NT, SMEM_SM // (itamax_smem(n, lanes) + 1024))
    units = -(-r // (unit * _build.NUM_SMS * per_sm))
    units = min(units, (1 << 30) // (unit * n))
    return unit * max(units, 1)


def itamax_grid(r: int, n: int) -> tuple[int, int, int]:
    """(rows per block, lanes per row, dynamic shared bytes) of a launch
    over ``r`` rows of ``n``; the grid is ceil(r / rows per block)."""
    if not 0 < n <= MAX_ROW:
        raise ValueError(f"itamax rows of {n}: the kernel takes 1..{MAX_ROW}")
    lanes = itamax_lanes(r, n)
    smem = itamax_smem(n, lanes)
    if -(-_chunks_spanned(n) // lanes) > MAX_CH or smem > SMEM_MAX:
        raise ValueError(f"itamax rows of {n} do not fit the kernel's shared memory")
    return itamax_rows_per_block(r, n, lanes), lanes, smem


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
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
    r = math.prod(lead)
    grid = itamax_grid(r, n)
    dev = logits.device
    x = _build.as_kernel_arg(logits.reshape(r, n))
    out = torch.empty((r, n), dtype=torch.int8, device=dev)
    if r == 0:
        return out.reshape(logits.shape)
    lut = _lut(dev)
    launch = _lib()
    with torch.cuda.device(dev):
        rc = launch(x.data_ptr(), lut.data_ptr(), out.data_ptr(), r, n, *grid,
                    _build.stream_of(out))
    _build.check(rc, "itamax")
    itamax.launches += 1
    return out.reshape(logits.shape)


itamax.launches = 0  # kernel launches since the last reset
