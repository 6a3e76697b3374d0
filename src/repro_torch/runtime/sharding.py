"""Sharding rules: DP / TP / EP / SP over a ``DeviceMesh``.

Parameter placement is decided by path-suffix rules (one table serves the
float and int8 layouts — ``w`` and ``w_q`` leaves shard identically).
The rules and the specs are the JAX package's: a spec ``P(...)`` names,
for each tensor dim, the mesh axes it is split over (``None``: whole).
The JAX package stacks layers with a leading L dim that is never sharded;
here ``layers`` is a list of per-layer dicts (paths ``layers/<i>/...``),
so a layer leaf's spec is the reference's without its leading ``None``
(``leaf_spec``).

Where GSPMD carries a ``NamedSharding``, the port carries DTensor
placements: a spec becomes one placement per mesh dim (``Shard(i)`` on
each mesh dim that tensor dim ``i`` names, in order, ``Replicate()`` on
the others and on a dim of size 1), ``device_put`` distributes each leaf,
and DTensor's propagation plays GSPMD's part inside the step.

Axes:
  "pod"   : data-parallel across pods (slow links; grad compression applies)
  "data"  : data-parallel within a pod; also sequence-shards long KV caches
  "model" : tensor/expert parallel (TP for dense, EP for MoE experts,
            head-parallel for attention and SSD state)
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.convert import STACKED


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class P(tuple):
    """A partition spec: one entry per tensor dim, each ``None``, an axis
    name or a tuple of axis names (the JAX package's ``PartitionSpec``,
    compared entry by entry; as there, a tuple of one name is the name and
    an empty one is ``None``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def __reduce__(self):
        return (type(self), tuple(self))


def axis_names(mesh) -> tuple:
    """The mesh's axis names: a ``DeviceMesh``'s dim names, or ``axis_names``
    of any mesh-like object (a stub that carries only names and sizes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_shape(mesh) -> dict:
    """{axis name: size}, as a JAX mesh's ``shape``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def data_axes(mesh):
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


# (path regex, trailing PartitionSpec entries)
_PARAM_RULES: list[tuple[str, tuple]] = [
    # embeddings / heads
    (r"embed/table(_q)?$", ("model", None)),
    (r"lm_head/w(_q)?$", (None, "model")),
    (r"(dec_embed)/table(_q)?$", ("model", None)),
    (r"(pos|enc_pos|dec_pos)(_q)?$", (None, None)),
    # attention projections
    (r"attn/wqkv/(w|w_q)$", (None, "model")),
    (r"attn/wqkv/(b|b_q)$", ("model",)),
    (r"attn/wo/(w|w_q)$", ("model", None)),
    (r"attn/wq/(w|w_q)$", (None, "model")),
    (r"attn/wkv/(w|w_q)$", (None, "model")),
    (r"shared/wqkv/(w|w_q)$", (None, "model")),
    (r"shared/wo/(w|w_q)$", ("model", None)),
    # dense MLP
    (r"mlp/(gate|up)/(w|w_q)$", (None, "model")),
    (r"mlp/(gate|up)/(b|b_q)$", ("model",)),
    (r"mlp/down/(w|w_q)$", ("model", None)),
    (r"mlp/down/(b|b_q)$", (None,)),
    # MoE experts: EP over "model"
    (r"experts/(gate|up|down)(_q)?$", ("model", None, None)),
    (r"router/w$", (None, None)),
    # Mamba2 / SSD: inner dim (heads) over "model"
    (r"in_proj/(w|w_q)$", (None, "model")),
    (r"out_proj/(w|w_q)$", ("model", None)),
    (r"conv_w$", (None, "model")),
    (r"conv_b$", ("model",)),
    (r"(A_log|dt_bias|D)$", ("model",)),
    (r"out_norm/g$", ("model",)),
]


def sanitize_spec(mesh, spec: P, shape) -> P:
    """Drop axes whose size does not divide the corresponding dim (e.g.
    batch=1 cells cannot shard over the data axes)."""
    sizes = mesh_shape(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for a in axes:
            n *= sizes[a]
        dim = shape[i] if i < len(shape) else 0
        out.append(entry if (dim % n == 0 and dim >= n) else None)
    return P(*out)


def placements(mesh, spec: P) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim.  A
    mesh dim of size 1 splits nothing and is ``Replicate()`` whatever the
    spec names (as in JAX, where such an axis leaves the array whole):
    DTensor would otherwise hold its ops to the rules of a sharded dim."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_shape(mesh)
    out = []
    for name in axis_names(mesh):
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims and sizes.get(name, 2) > 1 else Replicate())
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over dicts, lists and tuples (NamedTuples kept)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, (*path, i)) for i, v in enumerate(tree)]
    if isinstance(tree, tuple):
        keys = getattr(tree, "_fields", range(len(tree)))
        items = [_map_with_path(fn, v, (*path, k)) for k, v in zip(keys, tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return fn(path, tree)


def _map2(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of the same structure."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_map2(fn, v, o) for v, o in zip(tree, other)]
        if isinstance(tree, list):
            return items
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return fn(tree, other)


def spec_for_param(path: str, ndim: int, fsdp: bool = False) -> P:
    """TP/EP placement from the rules table; with ``fsdp`` the first
    unsharded trailing dim of every >=2-D weight additionally shards over
    'data' (ZeRO-3: params+grads+optimizer sharded over the data axis too;
    DTensor re-gathers per use)."""
    for pat, trailing in _PARAM_RULES:
        if re.search(pat, path):
            spec = list(trailing)
            if len(spec) > ndim:  # a leaf with fewer dims (a per-layer leaf)
                spec = spec[-ndim:]
            if fsdp and ndim >= 2:
                for i, e in enumerate(spec):
                    if e is None:
                        spec[i] = "data"
                        break
            pad = [None] * (ndim - len(spec))
            return P(*pad, *spec)
    return P()  # replicate (norms, scalars, biases by default)


def leaf_spec(path: tuple, ndim: int, fsdp: bool = False) -> P:
    """``spec_for_param`` of the leaf at ``path`` (a tuple of keys and list
    indices) of the port's params.  A leaf of a per-layer list
    (``layers/<i>/...``) takes the spec of the reference's stacked leaf,
    one dim more, with its leading layer ``None`` dropped: so ``fsdp``
    shards a stacked 1-D bias (2-D in the reference) over "data" here too."""
    stacked = any(k in STACKED and isinstance(i, int) for k, i in zip(path, path[1:]))
    if stacked:
        return P(*spec_for_param(_path_str(path), ndim + 1, fsdp=fsdp)[1:])
    return spec_for_param(_path_str(path), ndim, fsdp=fsdp)


def _ndim(leaf) -> int:
    return leaf.ndim if hasattr(leaf, "ndim") else np.ndim(leaf)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def param_shardings(mesh, params, fsdp: bool = False):
    """A ``NamedSharding`` tree matching ``params`` (float and int8 alike)."""

    def assign(path, leaf):
        spec = leaf_spec(path, _ndim(leaf), fsdp=fsdp)
        return NamedSharding(mesh, sanitize_spec(mesh, spec, _shape(leaf)))

    return _map_with_path(assign, params)


def batch_shardings(mesh, batch):
    """Shard every batch leaf's leading (batch) dim over the data axes."""
    da = data_axes(mesh)

    def assign(path, leaf):
        nd = _ndim(leaf)
        if nd == 0:
            return NamedSharding(mesh, P())
        spec = P(da, *([None] * (nd - 1)))
        return NamedSharding(mesh, sanitize_spec(mesh, spec, _shape(leaf)))

    return _map_with_path(assign, batch)


def cache_shardings(mesh, cache, *, seq_shard: bool = False):
    """KV/SSM cache placement.

    Transformer caches [L, B, Hkv, S, hd]: batch over data axes, heads over
    model.  With ``seq_shard`` (long-context, batch=1) the sequence dim is
    sharded over "data" instead.
    """
    da = data_axes(mesh)

    def assign(path, leaf):
        leaf_name = _path_str(path).split("/")[-1]
        nd = _ndim(leaf)
        if leaf_name == "len" or nd == 0:
            return NamedSharding(mesh, P())
        if leaf_name in ("k", "v", "ck", "cv"):
            if seq_shard:
                spec = P(None, None, "model", "data", None)
            else:
                spec = P(None, da, "model", None, None)
        elif leaf_name == "conv":  # [L, B, k, conv_dim]
            spec = P(None, da, None, "model")
        elif leaf_name == "ssm":  # [L, B, H, P, N]
            spec = P(None, da, "model", None, None)
        else:
            spec = P()
        return NamedSharding(mesh, sanitize_spec(mesh, spec, _shape(leaf)))

    return _map_with_path(assign, cache)


def opt_state_shardings(mesh, opt_state, param_sh):
    """AdamW mu/nu mirror the parameter shardings; step is replicated."""
    from repro_torch.optim.adamw import AdamWState

    assert isinstance(opt_state, AdamWState)
    return AdamWState(step=NamedSharding(mesh, P()), mu=param_sh, nu=param_sh)


# -- placing trees --------------------------------------------------------------


def _place(leaf, sharding: NamedSharding):
    from torch.distributed.tensor import DTensor, distribute_tensor

    mesh, want = sharding.mesh, sharding.placements
    if isinstance(leaf, DTensor):
        if leaf.device_mesh == mesh:
            return leaf if tuple(leaf.placements) == want else leaf.redistribute(mesh, want)
        leaf = leaf.full_tensor()
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.as_tensor(np.asarray(leaf))
    return distribute_tensor(leaf.to(mesh.device_type), mesh, want)


def device_put(tree, shardings):
    """Every leaf of ``tree`` placed on its ``NamedSharding``'s mesh
    (``jax.device_put``): a DTensor already placed so is returned as it
    is, one on the same mesh is redistributed, any other leaf (a tensor,
    numpy, a DTensor of another mesh, gathered first) is distributed from
    rank 0's values.  Collective: every rank of the meshes calls it."""
    return _map2(_place, tree, shardings)


def gather(tree):
    """Every DTensor leaf of ``tree`` as the whole tensor on every rank
    (collective); other leaves as they are."""
    from torch.distributed.tensor import DTensor

    return _map_with_path(
        lambda _, t: t.full_tensor() if isinstance(t, DTensor) else t, tree)
