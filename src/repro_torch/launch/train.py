"""Training driver: a train step with microbatched gradient accumulation,
remat and AdamW, its sharded form over a mesh (``shard_train_fn``), and
checkpoint/restart supervision.

Runnable directly (the card unless ``--device cpu``):
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --reduced \\
      --steps 20 --batch 8 --seq 128 --device cpu

The JAX package's step is ``jax.jit``-ed with its params and state donated;
here the step updates them in place (``optim.adamw.apply``) and returns
the same tensors.  ``shard_train_fn`` runs the same step on DTensors
placed by the sharding rules (``runtime.sharding``); DTensor propagation
takes GSPMD's part.
"""

from __future__ import annotations

import argparse
import functools
import re
import time

import torch

from repro_torch.configs import ShapeCell, get_config, reduced
from repro_torch.convert import tree_leaves, tree_map
from repro_torch.models import build
from repro_torch.optim import adamw
from repro_torch.runtime.activations import activation_policy  # noqa: F401
from repro_torch.runtime.sharding import (
    batch_shardings,
    device_put,
    opt_state_shardings,
    param_shardings,
)

try:
    from torch.distributed.tensor import DTensor
except ImportError:  # a torch built without distributed support
    DTensor = ()


def _placed_as(leaf):
    """A gradient hook: the gradient of the DTensor ``leaf`` redistributed
    to ``leaf``'s placements, and waited on, as soon as the backward has
    made it.  A weight that a product gathered (FSDP's split over "data")
    gets its gradient at the gathered shape, a sum over "data" still to
    reduce: reduce-scattered here, within the layer's backward, it is held
    as the leaf's shard, not whole until the backward ends (ZeRO-3, as
    GSPMD lays it out).  The sums are those the accumulation would reduce."""
    mesh, want = leaf.device_mesh, tuple(leaf.placements)

    def hook(g):
        return g if tuple(g.placements) == want else g.redistribute(mesh, want)

    return hook


def _value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``: ``jax.value_and_grad``.
    The grads are new tensors shaped like ``params`` (zero where the loss
    does not reach a leaf); ``params`` are left as they are.  A DTensor
    leaf's gradient comes back in the leaf's placements (``_placed_as``)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = list(tree_leaves(live))
    for t in leaves:
        if isinstance(t, DTensor):
            t.register_hook(_placed_as(t))
    with torch.enable_grad():
        loss = loss_fn(live, batch)
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def _microbatch_rows(v, microbatches: int) -> list:
    """``v``'s microbatches: rows ``[i * mb, (i + 1) * mb)`` for each ``i``
    (the reference's reshape to ``[microbatches, mb, ...]``).

    A DTensor whose rows are split over the data axes keeps each
    microbatch split over them: one all-to-all hands each rank its share
    of every microbatch, as GSPMD reshards the reference's reshape.  A
    slice of the DTensor would gather the whole batch on every rank for
    each microbatch.  Rows that are whole, or a microbatch that the data
    ranks do not split evenly, are sliced."""
    mb = v.shape[0] // microbatches
    dims = [] if not isinstance(v, DTensor) else \
        [d for d, p in enumerate(v.placements) if p.is_shard(0)]
    if not dims:
        return [v[i * mb:(i + 1) * mb] for i in range(microbatches)]
    import torch.distributed._functional_collectives as funcol

    mesh = v.device_mesh
    names = tuple(mesh.mesh_dim_names[d] for d in dims)
    if len(names) == 1:
        sub = mesh[names[0]]
    else:  # ("pod", "data"): one group, pod-major as the shards are
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        with unset_fake_temporarily():  # the mesh's own ranks, in a dry run too
            sub = mesh[names]._flatten()
    n, r = sub.size(), sub.get_local_rank()
    if mb % n:
        return [v[i * mb:(i + 1) * mb] for i in range(microbatches)]
    # the batch as chunks of c rows: chunk q is row block q % n of
    # microbatch q // n, and rank r holds chunks [r * M, (r + 1) * M)
    c, m_ = mb // n, microbatches
    dest = [(r * m_ + m) % n for m in range(m_)]
    order = sorted(range(m_), key=lambda m: (dest[m], m))
    local = v.to_local()
    send = local.reshape(m_, c, *local.shape[1:])[order].reshape(local.shape)
    recv = funcol.all_to_all_single(
        send, [c * sum((q * m_ + m) % n == r for m in range(m_)) for q in range(n)],
        [c * dest.count(s) for s in range(n)], sub.get_group())
    recv = funcol.wait_tensor(recv)  # chunks in microbatch order
    shape = (mb, *v.shape[1:])
    stride = torch.empty(shape, device="meta").stride()
    return [DTensor.from_local(recv[i * c:(i + 1) * c], mesh, v.placements, run_check=False,
                               shape=torch.Size(shape), stride=stride)
            for i in range(microbatches)]


def make_train_step(
    api,
    *,
    microbatches: int = 1,
    lr_schedule=None,
    remat: bool = True,
    grad_accum_dtype=torch.bfloat16,
):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Gradient accumulation: the global batch is split into ``microbatches``
    along the batch dim; the global batch — and therefore the semantics of
    the step — is unchanged.  Each microbatch's gradient, divided by
    ``microbatches``, is rounded to ``grad_accum_dtype`` and summed there
    (bf16 by default, as the JAX package's scan carries it); the loss is
    summed in float32.  ``batch`` holds tensors on the params' device.
    """
    if lr_schedule is None:
        lr_schedule = lambda step: 3e-4  # noqa: E731

    def loss_with_remat(params, mb):
        return api.loss_fn(params, mb, remat=remat)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = _value_and_grad(loss_with_remat, params, batch)
        else:
            rows = {k: _microbatch_rows(v, microbatches) for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=next(tree_leaves(params)).device)
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=grad_accum_dtype), params)
            for i in range(microbatches):
                mb_loss, mb_grads = _value_and_grad(
                    loss_with_remat, params, {k: v[i] for k, v in rows.items()})
                for a, g in zip(tree_leaves(grads), tree_leaves(mb_grads)):
                    a.add_((g / microbatches).to(grad_accum_dtype))
                loss = loss + mb_loss / microbatches
        lr = lr_schedule(opt_state.step)
        params, opt_state, metrics = adamw.apply(grads, opt_state, params, lr)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


#: DTensor's words for an op it has no sharding rule for
_UNSHARDABLE = re.compile(r"Operator (\S+) does not have a sharding strategy"
                          r"|Sharding propagation failed for ([\w.:]+)")


def _replicated(t):
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(t, DTensor):
        return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)
    return t


def shard_train_fn(train_step, mesh, params, opt_state, batch_spec, *, fsdp: bool = False):
    """The step on ``mesh``: (params, opt_state, batch) -> (params,
    opt_state, metrics), as ``train_step``'s.

    Each call places the params by ``param_shardings`` (``fsdp``: ZeRO-3
    over "data" too), the AdamW state by ``opt_state_shardings`` and the
    global batch by ``batch_shardings``; leaves already placed so are used
    as they are, so a step's outputs feed the next without a copy, updated
    in place.  The metrics come back replicated.  Plain tensors that the
    model makes itself (positions, masks) count as replicated.  Every rank
    of the mesh calls the step with the same batch; run it under
    ``activation_policy(mesh)`` for the models' activation constraints.
    An op that DTensor cannot shard raises ``NotImplementedError`` naming
    it: there is no unsharded fallback.
    """
    from torch.distributed.tensor.experimental import implicit_replication

    p_sh = param_shardings(mesh, params, fsdp=fsdp)
    o_sh = opt_state_shardings(mesh, opt_state, p_sh)
    b_sh = batch_shardings(mesh, batch_spec)

    def step(params, opt_state, batch):
        params, opt_state = device_put(params, p_sh), device_put(opt_state, o_sh)
        batch = device_put(batch, b_sh)
        try:
            with implicit_replication():
                params, opt_state, metrics = train_step(params, opt_state, batch)
        except (NotImplementedError, RuntimeError) as e:
            op = _UNSHARDABLE.search(str(e))
            if op is None:
                raise
            raise NotImplementedError(
                f"shard_train_fn: DTensor cannot shard {op.group(1) or op.group(2)} of this "
                f"step on mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}: {e}") from e
        return params, opt_state, {k: _replicated(v) for k, v in metrics.items()}

    return step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--save-every", type=int, default=50)
    # parsed and never read, as in the JAX package: QAT training runs
    # through examples/torch_train_tinylm.py, which wraps loss_fn itself
    ap.add_argument("--qat", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0, help="seed of the params' draw")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.deploy.api import resolve_device
    from repro_torch.runtime.fault import Supervisor

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    api = build(cfg)
    params = api.init_params(args.seed, device=dev)
    opt_state = adamw.init(params)

    dcfg = DataConfig(vocab=max(cfg.vocab, 2), global_batch=args.batch, seq_len=args.seq)
    cell = ShapeCell("cli", args.seq, args.batch, "train")
    sched = functools.partial(
        adamw.cosine_schedule, peak_lr=3e-4, warmup=10, total=max(args.steps, 20)
    )
    train_step = make_train_step(api, microbatches=args.microbatches, lr_schedule=sched)

    ck = Checkpointer(args.ckpt_dir)
    sup = Supervisor(ck, save_every=args.save_every)

    def step_fn(state, batch):
        params, opt_state = state
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        params, opt_state, metrics = train_step(params, opt_state, batch)
        return (params, opt_state), metrics

    def batch_fn(step):
        return make_batch(cfg, cell, dcfg, step)

    t0 = time.time()
    (params, opt_state), history = sup.run(step_fn, (params, opt_state), batch_fn, 0, args.steps)
    losses = [float(m["loss"]) for _, m in history]  # waits for the device
    dt = time.time() - t0
    print(f"steps={len(history)} time={dt:.1f}s loss[0]={losses[0]:.4f} loss[-1]={losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
