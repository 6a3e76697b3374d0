"""Pipeline parallelism (GPipe schedule) over a mesh dim.

At two pods, the natural deployment pipelines *across pods* — the "pod"
axis rides the slower links, and pipelining converts its traffic from
per-layer tensor exchanges into one boundary activation per microbatch
per tick.  The same machinery pipelines over any axis.

Mechanics (classic SPMD pipeline): every rank holds the layer stack of
its stage.  Microbatches enter at stage 0; each tick every stage applies
its layers to its current slot and the slot rotates one stage forward
(the JAX package's ``lax.ppermute`` ring is one ``batch_isend_irecv`` a
tick here).  ``n_micro + n_stages - 1`` ticks drain the pipeline.
Bubble fraction = (S-1)/(M+S-1) — choose n_micro >> n_stages.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def spmd_pipeline(stage_fn, axis_name, n_micro: int):
    """Build the per-rank pipeline body.

    stage_fn(stage_params, x) -> y — applies ONE stage's layers.
    ``axis_name`` is the process group of the pipeline's stages (rank i of
    the group is stage i).  Returns body(stage_params, x_micro) with
    x_micro [n_micro, mb, ...] resident on every rank (only stage 0
    consumes it); the output, the stacked microbatch outputs of the LAST
    stage, is the same on every rank.
    """
    group = axis_name

    def body(stage_params, x_micro):
        ranks = dist.get_process_group_ranks(group)
        n_stages = len(ranks)
        stage_id = ranks.index(dist.get_rank())
        nxt, prv = ranks[(stage_id + 1) % n_stages], ranks[(stage_id - 1) % n_stages]
        ticks = n_micro + n_stages - 1
        # gloo's send and recv read host memory: a card's slot goes through it
        on_host = x_micro.device.type != "cpu" and dist.get_backend(group) == "gloo"
        slot = torch.zeros_like(x_micro[0])
        outputs = torch.zeros_like(x_micro)
        for t in range(ticks):
            if stage_id == 0:  # stage 0 ingests microbatch t (when available)
                slot = x_micro[min(t, n_micro - 1)]
            y = stage_fn(stage_params, slot).to(x_micro.dtype).contiguous()
            if t >= n_stages - 1 and stage_id == n_stages - 1:  # last stage emits
                outputs[t - (n_stages - 1)] = y
            # rotate stage outputs forward one stage
            if n_stages == 1:
                slot = y
                continue
            send = y.cpu() if on_host else y
            recv = torch.empty_like(send)
            ops = [dist.P2POp(dist.isend, send, nxt, group),
                   dist.P2POp(dist.irecv, recv, prv, group)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            slot = recv.to(y.device)
        # broadcast the last stage's outputs to every rank: a masked sum
        last = outputs.reshape(n_micro, -1) * (1.0 if stage_id == n_stages - 1 else 0.0)
        dist.all_reduce(last, op=dist.ReduceOp.SUM, group=group)
        return last.reshape(x_micro.shape)

    return body


def pipelined_apply(
    mesh,
    stage_fn,
    params_stacked,  # leaves [n_stages, ...] — stage s holds slice s
    x: torch.Tensor,  # [batch, ...] — split into n_micro microbatches
    *,
    pipe_axis: str = "pod",
    n_micro: int = 4,
):
    """Run ``stage_fn`` as a pipeline over ``pipe_axis`` of ``mesh``; every
    rank of the mesh calls it with the same ``x`` and gets the output.
    Each rank keeps only its stage's slice of the stacked leaves."""
    from repro_torch.convert import tree_map

    b = x.shape[0]
    assert b % n_micro == 0, (b, n_micro)
    x_micro = x.reshape(n_micro, b // n_micro, *x.shape[1:])
    group = mesh.get_group(pipe_axis)
    stage = mesh.get_local_rank(pipe_axis)
    stage_params = tree_map(lambda a: a[stage].to(x.device, copy=True), params_stacked)
    out = spmd_pipeline(stage_fn, group, n_micro)(stage_params, x_micro)
    return out.reshape(b, *out.shape[2:])
