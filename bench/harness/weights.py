"""The model's int8 weights, made on the device from ``--seed``.

A tree of quantized parameters as ``CompiledModel.session(qp=...)`` takes
it (``layers`` a list of per-layer dicts).  Each kind of tensor is drawn
for all layers at once by a ``torch.Generator`` on the device, in float16
chunks that are rounded into int8 (int32 for biases) where they lie; the
layers' tensors are views of those draws.  The spread of each kind is the
configuration file's ``weights`` entry.
"""

from __future__ import annotations

import math

import torch

from bench.harness.traffic import seed64

CHUNK = 1 << 28  # elements of float16 drawn by one call


def _draw(gen, shape, std: float, mean: float = 0.0, dtype=torch.int8):
    """round(N(mean, std)), clamped to int8, as ``dtype``, in chunks of rows."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    flat = out.view(shape[0], -1)
    step = max(1, CHUNK // max(1, flat.shape[1]))
    lim = 127 if dtype == torch.int8 else (1 << 30)
    for r0 in range(0, shape[0], step):
        part = flat[r0:r0 + step]
        z = torch.randn(part.shape, generator=gen, dtype=torch.float16 if dtype == torch.int8
                        else torch.float32, device=gen.device)
        part.copy_(z.mul_(std).add_(mean).round_().clamp_(-lim, lim))
    return out


def _stack(gen, n_layers: int, d_in: int, d_out: int, w: dict):
    return _draw(gen, (n_layers, d_in, d_out), w["linear_std"] / math.sqrt(d_in))


def make_qp(arch: dict, w: dict, seed: int, device) -> dict:
    """The quantized parameters of a dense decoder with non-parametric norms
    and a tied head (the vocabulary padded to a multiple of 256)."""
    gen = torch.Generator(device=device).manual_seed(seed64(seed))
    n, d, f = arch["n_layers"], arch["d_model"], arch["d_ff"]
    h, hkv, hd = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    qkv = _stack(gen, n, d, (h + 2 * hkv) * hd, w)
    wo = _stack(gen, n, h * hd, d, w)
    mlp = {k: _stack(gen, n, f if k == "down" else d, d if k == "down" else f, w)
           for k in ("gate", "up", "down")}
    b_qkv = (_draw(gen, (n, (h + 2 * hkv) * hd), w["bias_std"], dtype=torch.int32)
             if arch.get("qkv_bias") else None)
    layers = []
    for l in range(n):
        attn = {"wqkv": {"w_q": qkv[l]}, "wo": {"w_q": wo[l]}}
        if b_qkv is not None:
            attn["wqkv"]["b_q"] = b_qkv[l]
        layers.append({"norm1": {}, "attn": attn, "norm2": {},
                       "mlp": {k: {"w_q": t[l]} for k, t in mlp.items()}})
    vocab = -(-arch["vocab"] // 256) * 256
    return {"layers": layers, "embed": {"table_q": _draw(gen, (vocab, d), w["embed_std"])},
            "final_norm": {}}
