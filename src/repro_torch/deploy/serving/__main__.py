"""``python -m repro_torch.deploy.serving`` — compile + serve over HTTP.

Compiles the named decoder (plan cache applies), binds its weights on the
card (``--device cpu`` for the plain PyTorch versions), starts the
background engine loop with the chosen scheduler policy and binds the
streaming JSON-lines frontend::

  PYTHONPATH=src python -m repro_torch.deploy.serving --arch olmo-1b --reduced \\
      --device cpu --batch 4 --prompt-len 8 --gen 16 --port 8080 \\
      --scheduler priority-deadline --max-queue 64

then::

  curl -N -d '{"prompt": [1,2,3,4,5,6,7,8], "max_new_tokens": 4}' \\
      http://127.0.0.1:8080/v1/generate
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config, reduced


def main(argv=None):
    from repro_torch.deploy.serving.async_engine import AsyncEngine
    from repro_torch.deploy.serving.frontend import ServingFrontend
    from repro_torch.launch.cli import (
        add_engine_args,
        add_plan_args,
        add_sanitize_args,
        add_serving_args,
        apply_sanitize_args,
        make_sampling,
        make_scheduler_from_args,
    )
    from repro_torch.launch.serve import compile_for_serving

    ap = argparse.ArgumentParser(prog="python -m repro_torch.deploy.serving")
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--extra-prompt", type=int, default=8,
                    help="KV headroom past --prompt-len for longer prompts")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080,
                    help="0 picks a free port (printed on startup)")
    ap.add_argument("--verbose", action="store_true", help="per-request access log")
    add_plan_args(ap)
    add_engine_args(ap)
    add_serving_args(ap)
    add_sanitize_args(ap)
    args = ap.parse_args(argv)
    apply_sanitize_args(args)  # before any engine/allocator exists

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = compile_for_serving(cfg, args, extra_prompt=args.extra_prompt)
    if model.kind != "decoder":
        raise SystemExit(
            f"{cfg.name} compiles to an encoder plan; the serving frontend "
            f"streams decoder generations — pick a decoder --arch")

    engine = AsyncEngine(model, args.batch, sampling=make_sampling(args),
                         scheduler=make_scheduler_from_args(args), seed=args.seed,
                         device=args.device)
    frontend = ServingFrontend(engine, args.host, args.port, verbose=args.verbose)
    host, port = frontend.address
    print(f"serving {cfg.name} [{model.backend.value}] on {engine.engine.session.device} at "
          f"http://{host}:{port} (batch={args.batch}, "
          f"scheduler={engine.engine.scheduler.name}, "
          f"max_queue={engine.engine.scheduler.max_queue})", flush=True)
    try:
        frontend.serve_forever()
    except KeyboardInterrupt:
        print("\ndraining ...")
        frontend.shutdown(drain=True)


if __name__ == "__main__":
    main()
