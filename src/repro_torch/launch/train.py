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


def _value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``: ``jax.value_and_grad``.
    The grads are new tensors shaped like ``params`` (zero where the loss
    does not reach a leaf); ``params`` are left as they are."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = list(tree_leaves(live))
    with torch.enable_grad():
        loss = loss_fn(live, batch)
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
    return loss.detach(), tree_map(lambda _: next(grads), params)


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
            # microbatch i is rows [i * mb, (i + 1) * mb): the reference's
            # reshape to [microbatches, mb, ...], taken as slices so that a
            # batch sharded over more ranks than mb rows splits too
            mb = next(iter(batch.values())).shape[0] // microbatches
            loss = torch.zeros((), dtype=torch.float32, device=next(tree_leaves(params)).device)
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=grad_accum_dtype), params)
            for i in range(microbatches):
                mb_loss, mb_grads = _value_and_grad(
                    loss_with_remat, params, {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()})
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
