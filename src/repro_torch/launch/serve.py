"""Serving driver of the port: batched encoder requests through the plan.

``compile()`` lowers the config (plan cache hit or miss is printed), then
``InferenceSession.forward`` answers ``--gen`` batches of ``--batch``
synthetic requests on the card and prints the throughput with the
device's name:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mobilebert --batch 8 --gen 4

``--backend w8a8`` runs the paper-faithful integer arithmetic instead of
the kernel backend (on the card its rowwise softmax is the ``itamax``
kernel).  The summary line names the kernels the forwards launched, with
their launches per forward.  ``--device cpu`` runs the plain PyTorch
versions on the CPU instead.
``--profile`` adds one traced batch after the timed loop and prints the
device time by kernel (``torch.profiler``: the top kernels, then the
port's own kernels wherever they rank) and the device's busy share of
the untraced loop's mean forward time; the timed loop itself runs
untraced.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import kernels
from repro_torch.configs import get_config, reduced
from repro_torch.deploy import api


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_requests(cfg, plan, batch_size: int, steps: int, seed: int) -> list[torch.Tensor]:
    """``steps`` request batches for the plan's input, drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    s = plan.seq_len
    if plan.inputs[0] == "tokens":
        return [torch.randint(0, cfg.vocab, (batch_size, s), generator=gen, dtype=torch.int32)
                for _ in range(steps)]
    return [torch.randint(-64, 64, (batch_size, s, cfg.d_model), generator=gen,
                          dtype=torch.int8) for _ in range(steps)]


def profile_forward(session, batch: torch.Tensor, top: int = 12) -> dict:
    """Trace one forward: device time by kernel name and the busy share."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if session.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(session.device)
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        session.forward(batch)
        _sync(session.device)
    wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"profile: traced wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
          f"{launches} device kernels")
    # the top kernels, then the port's own kernels wherever they rank
    own = ("int8_gemm", "ita_attention", "igelu_kernel", "itamax_kernel")
    for i, e in enumerate(kernels):
        if i < top or any(k in e.key for k in own):
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_kernels": launches}


def serve_encoder(model: api.CompiledModel, *, batch_size: int, steps: int, seed: int = 0,
                  device: str | None = None, profile: bool = False) -> dict:
    """Answer ``steps`` batches of ``batch_size`` requests; returns the stats.

    All request batches are made and copied to the device before the
    timed loop, so the loop measures the plan's execution; one batch runs
    first as a warm-up (it also builds the kernels on first use).
    """
    cfg, plan = model.cfg, model.artifact
    t0 = time.perf_counter()
    session = model.session(batch_size, seed=seed, device=device)
    batches = [b.to(session.device) for b in make_requests(cfg, plan, batch_size, steps + 1, seed)]
    out = session.forward(batches[-1])
    _sync(session.device)
    t_setup = time.perf_counter() - t0
    wrappers = kernels.wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    for b in batches[:steps]:
        out = session.forward(b)
    _sync(session.device)
    t_serve = time.perf_counter() - t0
    launched = {name: w.launches // steps for name, w in wrappers.items() if w.launches}
    counts = plan.counts()
    stats = {
        "arch": cfg.name,
        "backend": model.backend.value,
        "device": device_name(session.device),
        "batch": batch_size,
        "seq": plan.seq_len,
        "steps": steps,
        "seconds": t_serve,
        "inf_per_s": steps * batch_size / t_serve,
        "tok_per_s": steps * batch_size * plan.seq_len / t_serve,
        "out_shape": tuple(out.shape),
        "kernel_launches_per_forward": launched,
    }
    names = ", ".join(f"{n} {c}x" for n, c in launched.items()) or "none"
    print(
        f"plan-serving [{model.backend.value}] {cfg.name} on {stats['device']}: "
        f"{counts['nodes']} nodes ({counts['ita']} ita / {counts['cluster']} cluster); "
        f"bind+warm-up {t_setup:.2f}s; {steps} batches of {batch_size}x{plan.seq_len} in "
        f"{t_serve:.4f}s ({stats['inf_per_s']:.1f} inf/s, {stats['tok_per_s']:.0f} tok/s); "
        f"kernels per forward: {names}"
    )
    if profile:
        prof = profile_forward(session, batches[0])
        fwd_ms = 1e3 * t_serve / steps
        prof["busy_share"] = prof["device_busy_ms"] / fwd_ms
        print(f"profile: device busy {prof['device_busy_ms']:.3f} ms of the untraced "
              f"{fwd_ms:.3f} ms forward: busy {100 * prof['busy_share']:.1f}%, "
              f"idle {100 * (1 - prof['busy_share']):.1f}%")
        stats["profile"] = prof
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mobilebert")
    ap.add_argument("--reduced", action="store_true", help="tiny same-family variant")
    ap.add_argument("--backend", default="ita", choices=("ita", "w8a8"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--gen", type=int, default=4, help="request batches to answer")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--plan-cache", default=None, help="plan cache directory")
    ap.add_argument("--no-plan-cache", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="trace one extra batch and print device time by kernel")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    t0 = time.perf_counter()
    model = api.compile(cfg, backend=args.backend, cache_dir=args.plan_cache,
                        use_cache=not args.no_plan_cache)
    print(
        f"compile [{model.backend.value}] {cfg.name}: plan cache "
        f"{'hit' if model.cache_hit else 'miss'} ({model.fingerprint[:12]}, "
        f"v{model.compiler_version}) in {time.perf_counter() - t0:.2f}s"
    )
    serve_encoder(model, batch_size=args.batch, steps=args.gen, seed=args.seed,
                  device=args.device, profile=args.profile)


if __name__ == "__main__":
    main()
