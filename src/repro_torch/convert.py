"""Carry the JAX package's parameters into the port's dicts.

The two packages draw different random numbers from the same seed, so a
comparison feeds both the same numbers: the JAX side's params (float
``init_params``, integer ``init_qparams`` / ``quantize_params``, of any
family), turned into numpy arrays by the caller, become the port's
layout here.  Every stack of layers that the reference scans (``layers``,
an encoder-decoder's ``enc_layers`` / ``dec_layers``; a leading layer
axis) becomes a list of per-layer dicts, so a mixture-of-experts layer's
expert stacks [E, ...] stay whole in its layer's dict; every other entry
(``embed``, ``final_norm``, an untied ``lm_head``, positional tables,
zamba2's ``shared`` block) is carried as it is, and zamba2's serve params
``{"params", "qshared"}`` convert part by part.  No JAX import is
needed: the inputs are numpy.  ``tree_map`` / ``tree_leaves`` /
``to_device`` walk the port's own params trees, and ``to_jax_layout``
goes the other way: it stacks the per-layer lists back to the leading
layer axis (the checkpointer's on-disk layout, so that files load in
either package).
"""

from __future__ import annotations

import numpy as np
import torch


def tree_map(fn, tree):
    """``fn`` applied to every leaf of nested dicts and lists (the port's
    params: ``layers`` is a list of per-layer dicts)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree):
    """The leaves of nested dicts and lists, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def to_device(tree, device):
    """Every tensor of a params tree moved to ``device``."""
    return tree_map(lambda t: t.to(device), tree)


def _tensor(a, device=None) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carried bit for bit
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


#: the reference's scanned stacks of layers (a leading layer axis)
STACKED = ("layers", "enc_layers", "dec_layers")


def is_layer_list(key, value) -> bool:
    """Whether ``value``, found under ``key``, is a list of per-layer dicts
    that the reference keeps as one stack with a leading layer axis."""
    return (key in STACKED and isinstance(value, list) and len(value) > 0
            and all(isinstance(v, dict) for v in value))


def _stack_layers(layers: list, stack):
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack_layers([lp[k] for lp in layers], stack) for k in first}
    if isinstance(first, list):
        return [_stack_layers([lp[i] for lp in layers], stack) for i in range(len(first))]
    return stack(layers)


def to_jax_layout(tree, stack=torch.stack):
    """The port's params, or any tree that holds them (an optimizer state, a
    ``(params, state)`` tuple), in the JAX package's layout: each list of
    per-layer dicts under ``layers`` / ``enc_layers`` / ``dec_layers``
    becomes one dict whose leaves are ``stack`` of the layers' leaves
    (``torch.stack`` unless given: a new leading layer axis).  The inverse
    of ``from_jax_params`` / ``from_jax_quantized``; tuples, NamedTuples
    included, keep their type."""
    if isinstance(tree, dict):
        return {k: _stack_layers(v, stack) if is_layer_list(k, v) else to_jax_layout(v, stack)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_jax_layout(v, stack) for v in tree]
    if isinstance(tree, tuple):
        items = [to_jax_layout(v, stack) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def _convert(tree: dict, device) -> dict:
    if set(tree) == {"params", "qshared"}:  # zamba2's serve params
        return {"params": _convert(tree["params"], device),
                "qshared": tree_map(lambda a: _tensor(a, device), tree["qshared"])}
    out = {}
    for key, value in tree.items():
        if key in STACKED:
            n = np.asarray(next(tree_leaves(value))).shape[0]
            out[key] = [tree_map(lambda a, i=i: _tensor(np.asarray(a)[i], device), value)
                        for i in range(n)]
        else:
            out[key] = tree_map(lambda a: _tensor(a, device), value)
    return out


def from_jax_quantized(qp_numpy: dict, device=None) -> dict:
    """The JAX package's integer params (numpy): ``quantize_params`` of the
    encoder or the transformer, ``init_qparams`` of the transformer (dense,
    vlm, moe) or of ``encdec``, zamba2's ``{"params", "qshared"}`` ->
    the port's."""
    return _convert(qp_numpy, device)


def from_jax_params(params_numpy: dict, device=None) -> dict:
    """The JAX package's float ``init_params`` output (numpy) of any family
    -> the port's float params."""
    return _convert(params_numpy, device)
