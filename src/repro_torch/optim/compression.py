"""int8 gradient compression with error feedback — the paper's 8-bit theme
applied to the training communication path (cross-pod all-reduce).

Each leaf is quantized per-block to int8 with an f32 block scale before the
collective; the quantization residual is carried in an error-feedback
buffer so the compression is unbiased over time (1-bit-Adam-style EF).
The pod axis carries 4x fewer bytes.

``compress`` / ``decompress`` equal the JAX package's bit for bit
(``torch.round`` rounds half to even, as ``jnp.rint`` does).
``compressed_psum`` runs on each rank over a process group: the shared
block scale is an ``all_reduce(MAX)`` of the float32 scales (``pmax``),
the payload an ``all_reduce(SUM)`` of the int8 blocks widened to int32
(``psum``), which is exact.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

BLOCK = 1024


def _pad_to_block(x):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat, pad


def _block_scale(blocks: torch.Tensor) -> torch.Tensor:
    """max |block| / 127, divided exactly: CUDA divides by a Python number
    as a multiply by its reciprocal, one ulp off the reference's quotient
    in some blocks; a tensor divisor on the same device is divided."""
    amax = torch.amax(torch.abs(blocks), dim=1, keepdim=True)
    return amax / amax.new_tensor(127.0)


def compress(g: torch.Tensor, err: torch.Tensor):
    """g (+carried err) -> (q int8 blocks, scales f32, new_err)."""
    g32 = g.to(torch.float32) + err
    flat, pad = _pad_to_block(g32)
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.clamp(_block_scale(blocks), min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    err_flat = (blocks - deq).reshape(-1)
    if pad:
        err_flat = err_flat[:-pad]
    return q, scale[:, 0], err_flat.reshape(g.shape)


def decompress(q: torch.Tensor, scale: torch.Tensor, shape, pad_len: int):
    deq = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    if pad_len:
        deq = deq[:-pad_len]
    return deq.reshape(shape)


def _group(axis_name):
    """A process group: itself, or the group of the named dim of the mesh
    of the activation policy in force."""
    if not isinstance(axis_name, str):
        return axis_name
    from repro_torch.runtime.activations import active_mesh

    mesh = active_mesh()
    if mesh is None:
        raise ValueError(f"axis {axis_name!r} names a mesh dim, but no activation_policy "
                         "is in force; pass a process group")
    return mesh.get_group(axis_name)


def compressed_psum(g: torch.Tensor, err: torch.Tensor, axis_name):
    """Quantize -> psum(int32) -> dequantize, with error feedback.

    Summing int8 payloads in int32 across N pods is exact; the shared
    scale is the max over pods so the sum cannot overflow.  Every rank of
    the group calls it.
    """
    group = _group(axis_name)
    g32 = g.to(torch.float32) + err
    flat, pad = _pad_to_block(g32)
    blocks = flat.reshape(-1, BLOCK)
    scale = _block_scale(blocks)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(scale, min=1e-12)  # shared grid
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq_local = q.to(torch.float32) * scale
    new_err_flat = (blocks - deq_local).reshape(-1)
    if pad:
        new_err_flat = new_err_flat[:-pad]
    summed = q.to(torch.int32)
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    out = (summed.to(torch.float32) * scale).reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(g.shape).to(g.dtype), new_err_flat.reshape(g.shape)
