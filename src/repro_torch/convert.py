"""Carry the JAX package's parameters into the port's dicts.

The two packages draw different random numbers from the same seed, so a
comparison feeds both the same ints: the JAX side's
``encoder.quantize_params`` or ``transformer.quantize_params`` output (or
its float params), turned into numpy arrays by the caller, becomes the
port's layout here — the stacked ``layers`` pytree (leading layer axis)
becomes a list of per-layer dicts; every other entry (``embed.table_q``,
``pos_q``, ``final_norm``, an untied ``lm_head``) is carried as it is.
No JAX import is needed: the inputs are numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tensor(a, device=None) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _convert(tree: dict, device) -> dict:
    layers = tree["layers"]
    n = np.asarray(next(_leaves(layers))).shape[0]
    out = {k: _map(lambda a: _tensor(a, device), v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [_map(lambda a, i=i: _tensor(np.asarray(a)[i], device), layers)
                     for i in range(n)]
    return out


def from_jax_quantized(qp_numpy: dict, device=None) -> dict:
    """``repro.models.encoder.quantize_params`` or
    ``repro.models.transformer.quantize_params`` output (numpy) -> port ``qp``."""
    return _convert(qp_numpy, device)


def from_jax_params(params_numpy: dict, device=None) -> dict:
    """``repro.models.encoder.init_params`` or ``repro.models.transformer.init_params``
    output (numpy) -> port float params."""
    return _convert(params_numpy, device)
