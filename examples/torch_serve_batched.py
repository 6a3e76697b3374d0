"""Serve many requests through the port's continuous-batching engine.

The twin of ``examples/serve_batched.py``: requests are *submitted* to
``repro_torch.deploy.engine.Engine`` and the scheduler owns everything
below — FIFO admission into KV slots, one batched decode dispatch per
step with per-request positions, eviction + slot recycling, streaming.
No slot index or ``pos`` vector appears anywhere in this file.

Run:  PYTHONPATH=src python examples/torch_serve_batched.py --batch 4 --gen 16 [--device cpu]

The card by default; ``--device cpu`` runs the plain PyTorch versions.
"""

import argparse

from repro_torch.configs import get_config, reduced
from repro_torch.deploy import api
from repro_torch.deploy.engine import Engine
from repro_torch.launch.cli import (
    add_engine_args,
    make_sampling,
    resolve_requests,
    synthesize_prompts,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    add_engine_args(ap)  # --batch/--requests/--prompt-len/--gen/--sampling…
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    n = resolve_requests(args)

    cfg = reduced(get_config(args.arch))
    model = api.compile(cfg, seq_len=args.prompt_len,
                        max_len=args.prompt_len + args.gen + 1)
    engine = Engine(model, max_batch=args.batch, sampling=make_sampling(args),
                    device=args.device)
    prompts = synthesize_prompts(cfg.vocab, n=n, prompt_len=args.prompt_len)

    # stream request 0's tokens as the scheduler samples them
    streamed = []
    handles = [
        engine.submit(p, max_new_tokens=args.gen,
                      on_token=streamed.append if i == 0 else None)
        for i, p in enumerate(prompts)
    ]
    print(f"submitted {n} requests onto {args.batch} slots "
          f"(queue depth {engine.queue_depth})")

    while not engine.idle:
        engine.step()
        if handles[0].done and streamed is not None:
            print(f"request 0 finished streaming: {streamed[:10]} "
                  f"({handles[0].finish_reason})")
            streamed = None  # print once

    stats = engine.stats
    print(f"engine idle: {stats.summary()}")
    for h in handles[:2]:
        print(f"  request {h.rid}: {h.tokens[:10]} ({h.finish_reason})")
    assert stats.tokens_generated == sum(len(h.tokens) for h in handles)
    return handles


if __name__ == "__main__":
    main()
