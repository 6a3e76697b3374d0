"""Activation sharding policy (SP) — set by launchers, consumed by models.

Model code calls ``constrain(x, kind)`` at layer boundaries; outside a
policy context this returns ``x`` itself.  Inside, it redistributes ``x``
(a DTensor; a plain tensor is taken as replicated on every rank) to the
intended placements (``with_sharding_constraint`` of the JAX package), so
DTensor propagation continues from the layout the rules intend rather
than from whatever the last op produced:

  kind="residual"  [B, S, D]  -> P(data_axes, "model", None)   (Megatron-SP:
                   sequence sharded over the TP axis between attention/MLP
                   regions — activation memory / TP)
  kind="gathered"  [B, S, D]  -> P(data_axes, None, None)
  kind="heads"     [B, H, S, D] -> heads over "model", else the sequence
  kind="ssd"       [B, L, H, P], kind="ssd_l" [B, nc, H, c, c] -> heads
  kind="tokens"    [B, S]     -> P(data_axes, None)
  kind="experts"   [G, E, C, D] -> P(data_axes, "model", None, None)
  kind="kv_cache"  [L, B, Hkv, S, D] -> P(None, data_axes, "model", None, None)

The policy is process-wide, as the JAX package's is: set it around a
step, not across threads that run other steps.

``local_shards`` runs a function on each rank's shards with stated
placements (the products and scans whose DTensor rules differ between
torch versions: attention, the SSD scan, the expert products, the
vocab-parallel embedding, the LM head and its loss, the exact integer
products).
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.runtime.sharding import P, axis_names, mesh_shape, placements

_ACTIVE: dict | None = None


@contextlib.contextmanager
def activation_policy(mesh, *, sequence_parallel: bool = True, gather_boundary: bool = True):
    global _ACTIVE
    da = ("pod", "data") if "pod" in axis_names(mesh) else ("data",)
    prev = _ACTIVE
    _ACTIVE = {
        "mesh": mesh,
        "da": da,
        "sp": sequence_parallel,
        "gather_boundary": gather_boundary,
    }
    try:
        yield
    finally:
        _ACTIVE = prev


def active_mesh():
    """The mesh of the policy in force, or ``None`` outside one."""
    return None if _ACTIVE is None else _ACTIVE["mesh"]


def spec_for(x_shape, kind: str) -> P | None:
    """The spec ``constrain`` gives an activation of ``x_shape`` under the
    policy in force (``None``: left as it is)."""
    da, sp = _ACTIVE["da"], _ACTIVE["sp"]
    sizes = mesh_shape(_ACTIVE["mesh"])
    n_da = 1
    for a in da:
        n_da *= sizes[a]
    n_mdl = int(sizes.get("model", 1))

    def fits(dim, n):
        return dim % n == 0 and dim >= n

    if kind in ("gathered", "heads") and not _ACTIVE.get("gather_boundary", True):
        return None
    if kind == "residual":  # [B, S, D] between layers: SP over the TP axis
        b_ax = da if fits(x_shape[0], n_da) else None
        s_ax = "model" if (sp and fits(x_shape[1], n_mdl)) else None
        spec = P(b_ax, s_ax, None)
    elif kind == "gathered":  # [B, S, D] at the Megatron-SP boundary:
        # gather the (cheap) activations so the (expensive) TP weights stay
        # sharded through the projections
        spec = P(da if fits(x_shape[0], n_da) else None, None, None)
    elif kind == "heads":  # [B, H, S, D] attention internals: head-parallel,
        # falling back to sequence-parallel when H doesn't divide the TP axis
        b_ax = da if fits(x_shape[0], n_da) else None
        if fits(x_shape[1], n_mdl):
            spec = P(b_ax, "model", None, None)
        elif fits(x_shape[2], n_mdl):
            spec = P(b_ax, None, "model", None)
        else:
            spec = P(b_ax, None, None, None)
    elif kind == "ssd":  # [B, L, H, P] SSD internals: head-parallel
        b_ax = da if fits(x_shape[0], n_da) else None
        spec = P(b_ax, None, "model" if fits(x_shape[2], n_mdl) else None, None)
    elif kind == "ssd_l":  # [B, nc, H, c, c] SSD chunk decay matrix
        b_ax = da if fits(x_shape[0], n_da) else None
        spec = P(b_ax, None, "model" if fits(x_shape[2], n_mdl) else None, None, None)
    elif kind == "tokens":  # [B, S]
        spec = P(da if fits(x_shape[0], n_da) else None, None)
    elif kind == "experts":  # [G, E, C, D]
        g_ax = da if fits(x_shape[0], n_da) else None
        spec = P(g_ax, "model" if fits(x_shape[1], n_mdl) else None, None, None)
    elif kind == "kv_cache":  # [L, B, Hkv, S, D]: as runtime.sharding.cache_shardings
        spec = P(None, da if fits(x_shape[1], n_da) else None,
                 "model" if fits(x_shape[2], n_mdl) else None, None, None)
    else:
        return None
    if len(x_shape) != len(spec):
        return None
    return spec


def constrain(x, kind: str):
    if _ACTIVE is None:
        return x
    spec = spec_for(tuple(x.shape), kind)
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    mesh = _ACTIVE["mesh"]
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if any(p.is_partial() for p in x.placements):
        # reduce pending sums first: DTensor's backward cannot turn the
        # gradient of one partial type into another (sum -> avg), which a
        # direct move from Partial(avg) would ask of it
        x = x.redistribute(mesh, [Replicate() if p.is_partial() else p for p in x.placements])
    want = placements(mesh, spec)
    if tuple(x.placements) != want:
        # contiguous first: the shards a redistribution cuts are laid out
        # contiguously whatever strides the DTensor states (a permuted
        # tensor's), and a later view of them would fail
        x = x.contiguous()
    return x.redistribute(mesh, want)


def _as_dtensor(x, mesh):
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    # made by the model (positions, masks): the same on every rank
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _reduced(x):
    """``x`` with its pending sums reduced (``Partial`` -> ``Replicate``)."""
    from torch.distributed.tensor import Replicate

    if any(p.is_partial() for p in x.placements):
        return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                              for p in x.placements])
    return x


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward lays its gradient out contiguously:
    ``to_local``'s backward states the DTensor's (contiguous) strides for
    whatever layout the local gradient has."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_shards(fn, args, specs, out_specs, *, mesh=None):
    """``fn(*locals)`` on each rank's shards: the DTensor ``args`` (plain
    tensors count as replicated) are redistributed to ``specs`` (a
    ``P`` each, or ``None`` to pass an argument as it is), ``fn`` runs on
    their local tensors (with the policy suspended: no constraint applies
    to local tensors), and its result (one tensor or a list) comes back
    as DTensors placed by ``out_specs`` (a ``P``, or the placements
    themselves, e.g. ``Partial`` for a sum still to reduce).  ``fn`` must
    be independent across the sharded dims: each argument's gradient is
    then its shards', summed (``Partial``) over the mesh dims that split
    the work but not that argument.  A spec names only axes whose size
    divides its dim (``fits``)."""
    from torch.distributed.tensor import DTensor, Partial, Placement, Replicate

    if mesh is None:
        mesh = active_mesh() or next(a.device_mesh for a in args if isinstance(a, DTensor))
    in_pl = [None if sp is None else tuple(sp) if sp and isinstance(sp[0], Placement)
             else placements(mesh, sp) for sp in specs]
    multi = isinstance(out_specs, list)
    outs = out_specs if multi else [out_specs]
    out_pl = [tuple(o) if o and isinstance(o[0], Placement) else placements(mesh, o)
              for o in outs]
    split = {i for pl in [*in_pl, *out_pl] if pl is not None
             for i, p in enumerate(pl) if not isinstance(p, Replicate)}
    local = []
    for a, pl in zip(args, in_pl):
        if pl is None or not isinstance(a, torch.Tensor):
            local.append(a)
            continue
        # contiguous first: a redistribution's backward states the input's
        # strides for a gradient it lays out contiguously
        a = _reduced(_as_dtensor(a, mesh).contiguous()).redistribute(mesh, pl)
        grad = [Partial() if (isinstance(p, Replicate) and i in split) else p
                for i, p in enumerate(pl)]
        t = a.to_local(grad_placements=grad)
        local.append(_ContiguousGrad.apply(t) if t.requires_grad else t)
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, None  # local tensors: no constraint applies inside
    try:
        res = fn(*local)
    finally:
        _ACTIVE = prev
    res = list(res) if multi else [res]
    wrapped = []
    for r, pl in zip(res, out_pl):
        # contiguous, so that the global strides stated are the local ones'
        # layout (a size-1 local dim leaves DTensor's inference ambiguous)
        r = r.contiguous()
        shape = list(r.shape)
        for i, p in enumerate(pl):
            if p.is_shard():
                shape[p.dim] *= mesh.size(i)
        wrapped.append(DTensor.from_local(r, mesh, pl, run_check=False, shape=torch.Size(shape),
                                          stride=torch.empty(shape, device="meta").stride()))
    return tuple(wrapped) if multi else wrapped[0]


def fits(dim: int, axes, mesh=None) -> bool:
    """Whether ``dim`` splits evenly over the mesh axes ``axes`` (a name,
    a tuple of names or ``None``) of ``mesh`` (default: the policy's)."""
    if axes is None:
        return True
    sizes = mesh_shape(mesh if mesh is not None else _ACTIVE["mesh"])
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= int(sizes.get(a, 1))
    return dim % n == 0 and dim >= n


def zeros(shape, dtype, device, kind: str):
    """``torch.zeros(shape)``, or, under a policy, a DTensor of zeros placed
    as ``constrain(., kind)`` would place it, each rank allocating only its
    shard (a KV cache that a sharded prefill fills)."""
    if _ACTIVE is None or (spec := spec_for(tuple(shape), kind)) is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor

    mesh = _ACTIVE["mesh"]
    pl = placements(mesh, spec)
    local = list(shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device), mesh, pl,
                              run_check=False)


class _GradAs(torch.autograd.Function):
    """The identity, whose backward hands on its gradient in the forward
    tensor's placements (sums reduced): a product's gradient then reaches
    it laid out as its output was, not in whatever placements the ops
    after it left (a sequence-split gradient, which the product's backward
    would view together with the batch)."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate

        ctx.mesh = x.device_mesh
        ctx.want = tuple(Replicate() if p.is_partial() else p for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            g = _reduced(g.contiguous()).redistribute(ctx.mesh, ctx.want)
        return g


def grad_as_output(y):
    """``y``; on a DTensor, its gradient arrives in ``y``'s own placements
    (``_GradAs``)."""
    from torch.distributed.tensor import DTensor

    return _GradAs.apply(y) if isinstance(y, DTensor) and y.requires_grad else y


def pointwise_local(fn, x, *others, rows: bool = False):
    """``fn(x, *others)``, integer elementwise arithmetic, on each rank's
    shard of a DTensor ``x`` (the others: DTensors of ``x``'s shape take
    its placements, smaller ones are whole, plain tensors pass as they
    are); ``rows``: ``fn`` reduces along the last dim, which is then whole.
    The result has ``x``'s placements.  DTensor 2.13 has no rule for the
    shifts of the integer path and returns some of them unshifted."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return fn(x, *others)
    mesh = x.device_mesh
    x = _reduced(x)
    pl = tuple(Replicate() if rows and p.is_shard(x.dim() - 1) else p for p in x.placements)
    whole = (Replicate(),) * mesh.ndim
    specs = [pl] + [None if not isinstance(o, DTensor) else pl if o.shape == x.shape else whole
                    for o in others]
    return local_shards(fn, (x, *others), specs, pl, mesh=mesh)
