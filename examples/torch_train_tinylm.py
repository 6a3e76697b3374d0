"""End-to-end driver of the PyTorch port: train a ~138M-parameter LM for a
few dozen steps on one device.

Demonstrates the port's training substrate — the deterministic data
pipeline (the JAX package's batches, bit for bit, mapped onto a Zipf law
so that there is something to learn; see :func:`zipf`), AdamW + cosine
schedule, microbatched gradient accumulation in bfloat16, remat, QAT
(fake-quant on the ITAMax logit grid + int8 weight grid), async
checkpointing in the JAX package's file format with restart supervision
and straggler detection.

Run (quick):   PYTHONPATH=src python examples/torch_train_tinylm.py --steps 30
Run (full):    PYTHONPATH=src python examples/torch_train_tinylm.py --steps 300

The card by default; ``--device cpu`` trains on the CPU.  A checkpoint with
the AdamW state is about 1.65 GB.
"""

import argparse
import dataclasses
import functools
import subprocess
import time

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ShapeCell, get_config
from repro_torch.convert import tree_leaves
from repro_torch.data import DataConfig, make_batch
from repro_torch.deploy.api import resolve_device
from repro_torch.launch.train import make_train_step
from repro_torch.models import build
from repro_torch.optim import adamw
from repro_torch.runtime.fault import Supervisor


def device_label(dev: torch.device) -> str:
    """The device a rate was measured on: the card's name and power limit as
    nvidia-smi reports them, or the CPU."""
    if dev.type != "cuda":
        return "the CPU"
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[dev.index or 0]


def zipf(batch: dict, vocab: int) -> dict:
    """The pipeline's uniform draws k mapped to floor(vocab ** (k / vocab)) - 1:
    P(j) = ln(1 + 1 / (j + 1)) / ln(vocab), about 1 / (j + 1), a Zipf law
    as text's unigrams follow.  The pipeline draws tokens and labels
    uniformly and apart, so nothing can be learned from them and the loss
    can only drift around ln(vocab): the JAX package's
    examples/train_tinylm.py, 30 steps at its defaults on a CPU, rises from
    10.522 to 10.560 and fails its own assertion.  Under the Zipf law the
    loss falls as the model learns the unigram law (its entropy is about
    7.3 nats at a vocab of 32000), and replay stays exact: the map is
    deterministic."""
    return {k: (np.power(float(vocab), v / vocab) - 1).astype(np.int32) for k, v in batch.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--qat", action="store_true")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_tinylm_ckpt")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ~138M params: olmo-1b config narrowed (d=768, 12 layers)
    cfg = get_config("olmo-1b").replace(
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
        d_ff=3072, vocab=32000, max_seq=args.seq,
    )
    api = build(cfg)
    params = api.init_params(0, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"model: {cfg.name}-100m, {n_params/1e6:.1f}M params, qat={args.qat}")

    opt_state = adamw.init(params)
    sched = functools.partial(
        adamw.cosine_schedule, peak_lr=1e-3, warmup=5, total=max(args.steps, 100)
    )
    api_qat = dataclasses.replace(
        api, loss_fn=lambda p, b, **kw: api.loss_fn(p, b, qat=args.qat, **kw))
    train_step = make_train_step(api_qat, microbatches=2, lr_schedule=sched, remat=True)

    dcfg = DataConfig(vocab=cfg.vocab, global_batch=args.batch, seq_len=args.seq)
    cell = ShapeCell("tinylm", args.seq, args.batch, "train")
    ck = Checkpointer(args.ckpt_dir)
    sup = Supervisor(ck, save_every=max(args.steps // 3, 10))

    def step(state, batch):
        p, o = state
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        p, o, metrics = train_step(p, o, batch)
        return (p, o), metrics

    def batch_fn(s):
        return zipf(make_batch(cfg, cell, dcfg, s), cfg.vocab)

    t0 = time.time()
    (params, opt_state), hist = sup.run(step, (params, opt_state), batch_fn, 0, args.steps)
    losses = [float(m["loss"]) for _, m in hist]  # waits for the device
    dt = time.time() - t0
    tok_s = args.steps * args.batch * args.seq / dt
    print(
        f"{len(hist)} steps in {dt:.1f}s ({tok_s:,.0f} tok/s on {device_label(dev)}, "
        f"checkpoint writes included); loss {losses[0]:.3f} -> {losses[-1]:.3f} "
        f"(improved: {losses[-1] < losses[0]})"
    )
    if args.steps >= 15 and not losses[-1] < losses[0]:  # the unigram law is learned
        raise AssertionError("loss must decrease")
    print(f"checkpoints at {args.ckpt_dir}: latest step {ck.latest_step()}")
    return {"losses": losses, "tok_s": tok_s, "n_params": n_params}


if __name__ == "__main__":
    main()
