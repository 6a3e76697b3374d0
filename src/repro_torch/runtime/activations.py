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

The policy is process-wide, as the JAX package's is: set it around a
step, not across threads that run other steps.
"""

from __future__ import annotations

import contextlib

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
    return x.redistribute(mesh, placements(mesh, spec))
