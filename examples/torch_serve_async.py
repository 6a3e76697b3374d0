"""Serve concurrent clients through the port's async serving stack.

The twin of ``examples/serve_async.py``: the engine loop runs on
``AsyncEngine``'s background thread, client threads submit concurrently
with per-request SLOs under the ``PriorityDeadline`` policy, and one
client talks streaming JSON-lines HTTP through ``ServingFrontend`` — the
whole ``repro_torch.deploy.serving`` stack in one file.

Run:  PYTHONPATH=src python examples/torch_serve_async.py --batch 4 --clients 6 [--device cpu]

The card by default; ``--device cpu`` runs the plain PyTorch versions.
"""

import argparse
import threading

from repro_torch.configs import get_config, reduced
from repro_torch.deploy import api
from repro_torch.deploy.serving import AsyncEngine, ServingFrontend
from repro_torch.deploy.serving.scheduler import QueueFullError
from repro_torch.launch.cli import (
    add_engine_args,
    add_serving_args,
    http_generate,
    http_get_json,
    make_sampling,
    make_scheduler_from_args,
    synthesize_prompts,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--clients", type=int, default=6,
                    help="concurrent submitter threads")
    add_engine_args(ap)  # --batch/--prompt-len/--gen/--sampling…
    add_serving_args(ap)  # --scheduler/--max-queue/--aging-s
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.scheduler == "fifo":
        args.scheduler = "priority-deadline"  # the point of this example

    cfg = reduced(get_config(args.arch))
    model = api.compile(cfg, seq_len=args.prompt_len,
                        max_len=args.prompt_len + args.gen + 1)
    prompts = synthesize_prompts(cfg.vocab, n=args.clients,
                                 prompt_len=args.prompt_len)

    results: dict[int, str] = {}
    with AsyncEngine(model, args.batch, sampling=make_sampling(args),
                     scheduler=make_scheduler_from_args(args), device=args.device) as eng:
        fe = ServingFrontend(eng, port=0)
        host, port = fe.start()
        print(f"serving on http://{host}:{port} "
              f"({args.scheduler}, {args.batch} slots)")

        def client(i):
            if i == 0:
                # one client goes over the wire: streaming NDJSON
                events = list(http_generate(host, port, prompts[i],
                                            args.gen, priority=0,
                                            ttft_slo_ms=10_000.0))
                results[i] = (f"http  {events[-1]['finish_reason']}: "
                              f"{events[-1]['tokens'][:8]}")
                return
            # the rest submit in-process; odd clients are background
            # traffic with a completion budget (preemptible once over it)
            try:
                h = eng.submit(prompts[i], args.gen, priority=i % 2 * 5,
                               ttft_slo_ms=10_000.0,
                               deadline_ms=30_000.0 if i % 2 else None)
            except QueueFullError as e:
                results[i] = f"shed (retry after {e.retry_after_s:.2f}s)"
                return
            toks = [tok for tok in h]  # streams as the loop samples
            results[i] = f"async {h.finish_reason}: {toks[:8]}"

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(args.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        stats = http_get_json(host, port, "/v1/stats")
        for i in sorted(results):
            print(f"  client {i}: {results[i]}")
        print(f"stats: {stats['requests_completed']} completed, "
              f"ttft p50/p99 {stats['ttft_p50_ms']:.1f}/"
              f"{stats['ttft_p99_ms']:.1f} ms, "
              f"goodput under SLO {stats['goodput_under_slo']:.2f}")
        fe.shutdown(drain=True, timeout=60)
        assert all(i in results for i in range(args.clients))
    return results


if __name__ == "__main__":
    main()
