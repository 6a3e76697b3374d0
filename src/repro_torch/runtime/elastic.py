"""Elastic re-meshing: shrink/regrow the data axis after node failures.

Policy: the model axis is load-bearing (weights are TP/EP-sharded across
it) so it is preserved; lost capacity comes out of the data axis.  Params
and optimizer state are re-sharded onto the new mesh — combined with the
checkpointer this yields restore-on-fewer-nodes, and the deterministic
data pipeline keeps the batch stream consistent (the global batch is
re-split across the surviving data shards).

A JAX mesh is laid over devices; a ``DeviceMesh`` over ranks (one device
each), and every rank of the default group builds it, those left out of
the new mesh included.
"""

from __future__ import annotations

from repro_torch.runtime.sharding import device_put, gather, param_shardings


def plan_mesh(n_devices: int, model_parallel: int, axis_names=("data", "model")) -> tuple:
    """Largest (data, model) grid that fits ``n_devices``."""
    if n_devices < model_parallel:
        raise ValueError(
            f"cannot preserve model axis {model_parallel} with {n_devices} devices"
        )
    data = n_devices // model_parallel
    return (data, model_parallel), axis_names


def remesh(ranks, model_parallel: int, *, device=None):
    """A (data, model) mesh over the first ``data * model`` of ``ranks``
    (the surviving ranks of the default group)."""
    from repro_torch.launch.mesh import make_mesh

    ranks = list(ranks)
    (data, model), names = plan_mesh(len(ranks), model_parallel)
    return make_mesh((data, model), names, device=device, ranks=ranks[: data * model])


def reshard_state(state, new_mesh):
    """Re-shard an arbitrary tree of params/opt-state onto ``new_mesh``:
    each leaf gathered whole on its old mesh, then placed by
    ``param_shardings(new_mesh, state)``.  Every rank of the old mesh
    calls it."""
    whole = gather(state)
    return device_put(whole, param_shardings(new_mesh, whole))
