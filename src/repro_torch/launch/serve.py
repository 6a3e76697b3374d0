"""Serving driver of the port: batched requests through the compiled plan.

``compile()`` lowers the config (plan cache hit or miss is printed).  For
an encoder, ``InferenceSession.forward`` answers ``--gen`` batches of
``--batch`` synthetic requests on the card and prints the throughput
with the device's name:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mobilebert --batch 8 --gen 4

For a dense decoder (``--arch olmo-1b``), the pair is compiled for
``--prompt-len`` tokens and a KV region of ``prompt-len + gen`` rows; one
``session.prefill`` of ``--batch`` prompts is followed by ``--gen``
greedy ``session.decode`` steps (argmax of the logits).  It prints the
prefill time, the time per decode step, the generated tokens per second
and the kernels' launches per prefill and per decode step:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --prompt-len 128 --gen 16

``--kv-block-size`` (with ``--kv-blocks``, which defaults to enough
blocks for every slot's ``prompt-len + gen`` rows) compiles the pair over
a paged KV region, a shared pool of blocks with per-slot block tables;
the summary then gives the pool's size and its free blocks at the end.
``--head-by-head`` lowers an encoder with the paper's per-head schedule
(one attention per head, the heads' int32 output partials summed on the
cluster).

This is the session-level loop.  The JAX package's decoder serving runs
through its request-level ``Engine`` (scheduling, admission, sampling),
which is not ported yet (ROADMAP queue 1, item 4).

``--backend w8a8`` runs the paper-faithful integer arithmetic instead of
the kernel backend (on the card its rowwise softmax is the ``itamax``
kernel).  The summary line names the kernels the forwards launched, with
their launches per forward.  ``--device cpu`` runs the plain PyTorch
versions on the CPU instead.
``--profile`` adds one traced batch after the timed loop (for a decoder:
one traced prefill and one traced decode step) and prints the device
time by kernel (``torch.profiler``: the top kernels, then the port's own
kernels wherever they rank) and the device's busy share of the untraced
loop's mean time for the same call; the timed loop itself runs untraced.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import kernels
from repro_torch.configs import get_config, reduced
from repro_torch.deploy import api
from repro_torch.deploy.paging import blocks_for_rows


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


def profile_call(fn, device: torch.device, top: int = 12) -> dict:
    """Trace one ``fn()``: device time by kernel name and the busy share."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(device)
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        fn()
        _sync(device)
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
        stats["profile"] = _profile(lambda: session.forward(batches[0]), session.device,
                                    1e3 * t_serve / steps, "forward")
    return stats


def _profile(fn, device: torch.device, untraced_ms: float, what: str) -> dict:
    prof = profile_call(fn, device)
    prof["busy_share"] = prof["device_busy_ms"] / untraced_ms
    print(f"profile: device busy {prof['device_busy_ms']:.3f} ms of the untraced "
          f"{untraced_ms:.3f} ms {what}: busy {100 * prof['busy_share']:.1f}%, "
          f"idle {100 * (1 - prof['busy_share']):.1f}%")
    return prof


def serve_decoder(model: api.CompiledModel, *, batch_size: int, steps: int, seed: int = 0,
                  device: str | None = None, profile: bool = False) -> dict:
    """One prefill of ``batch_size`` prompts, then ``steps`` greedy decode
    steps; returns the stats.

    A first prefill and decode step run untimed as a warm-up (they also
    build the kernels on first use); the timed prefill starts the region
    afresh.
    """
    cfg, pair = model.cfg, model.artifact
    if pair.seq_len + steps > pair.max_len:
        raise ValueError(f"{steps} decode steps after a {pair.seq_len}-token prompt pass "
                         f"the KV region of {pair.max_len} rows")
    t0 = time.perf_counter()
    session = model.session(batch_size, seed=seed, device=device)
    gen = torch.Generator().manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab, (batch_size, pair.seq_len), generator=gen,
                            dtype=torch.int32).to(session.device)

    def greedy(logits):
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    session.decode(greedy(session.prefill(prompts)))
    _sync(session.device)
    t_setup = time.perf_counter() - t0
    wrappers = kernels.wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    logits = session.prefill(prompts)
    _sync(session.device)
    t_prefill = time.perf_counter() - t0
    per_prefill = {name: w.launches for name, w in wrappers.items() if w.launches}
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        logits = session.decode(greedy(logits))
    _sync(session.device)
    t_decode = time.perf_counter() - t0
    per_step = {name: w.launches / steps for name, w in wrappers.items() if w.launches}
    counts = pair.counts()
    stats = {
        "arch": cfg.name,
        "backend": model.backend.value,
        "device": device_name(session.device),
        "batch": batch_size,
        "paged": pair.paged,
        "prompt_len": pair.seq_len,
        "steps": steps,
        "prefill_ms": 1e3 * t_prefill,
        "decode_ms_per_step": 1e3 * t_decode / steps,
        "tok_per_s": batch_size * steps / t_decode,
        "kernel_launches_per_prefill": per_prefill,
        "kernel_launches_per_decode_step": per_step,
    }
    pre = ", ".join(f"{n} {c}x" for n, c in per_prefill.items()) or "none"
    dec = ", ".join(f"{n} {c:g}x" for n, c in per_step.items()) or "none"
    region = f"dense KV region of {pair.max_len} rows a slot"
    if pair.paged:
        stats["blocks_free"] = session.blocks_free
        region = (f"paged KV pool of {pair.kv_blocks} blocks of {pair.kv_block_size} rows "
                  f"({session.blocks_free} free after the run)")
    print(
        f"decoder-serving [{model.backend.value}] {cfg.name} on {stats['device']}, {region}: "
        f"plan nodes "
        f"prefill {counts['prefill']['nodes']} ({counts['prefill']['ita']} ita), decode "
        f"{counts['decode']['nodes']} ({counts['decode']['ita']} ita); bind+warm-up "
        f"{t_setup:.2f}s; prefill {batch_size}x{pair.seq_len} in {stats['prefill_ms']:.3f} ms; "
        f"{steps} decode steps of {batch_size} at {stats['decode_ms_per_step']:.3f} ms a step "
        f"({stats['tok_per_s']:.1f} tok/s); kernels per prefill: {pre}; per decode step: {dec}"
    )
    if profile:
        stats["profile_prefill"] = _profile(lambda: session.prefill(prompts), session.device,
                                            stats["prefill_ms"], "prefill")
        tok = greedy(session.prefill(prompts))
        stats["profile_decode"] = _profile(lambda: session.decode(tok), session.device,
                                           stats["decode_ms_per_step"], "decode step")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mobilebert")
    ap.add_argument("--reduced", action="store_true", help="tiny same-family variant")
    ap.add_argument("--backend", default="ita", choices=("ita", "w8a8"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--gen", type=int, default=4,
                    help="request batches to answer (encoder) or decode steps (decoder)")
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="decoder prompt length (default: the config's max_seq)")
    ap.add_argument("--kv-block-size", type=int, default=None,
                    help="decoder: a paged KV region of blocks of this many rows")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="decoder: the paged pool's blocks (default: every slot's "
                         "prompt-len + gen rows)")
    ap.add_argument("--head-by-head", action="store_true",
                    help="encoder: lower with the paper's per-head MHA schedule")
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
    decoder = api.is_dense_decoder(cfg)
    kw = dict(head_by_head=args.head_by_head)
    if decoder:
        s = args.prompt_len or cfg.max_seq
        kw.update(seq_len=s, max_len=s + args.gen)
        blocks = args.kv_blocks
        if args.kv_block_size and blocks is None:
            blocks = args.batch * blocks_for_rows(s + args.gen, args.kv_block_size)
        kw.update(kv_block_size=args.kv_block_size, kv_blocks=blocks)
    t0 = time.perf_counter()
    model = api.compile(cfg, backend=args.backend, cache_dir=args.plan_cache,
                        use_cache=not args.no_plan_cache, **kw)
    print(
        f"compile [{model.backend.value}] {cfg.name}: plan cache "
        f"{'hit' if model.cache_hit else 'miss'} ({model.fingerprint[:12]}, "
        f"v{model.compiler_version}) in {time.perf_counter() - t0:.2f}s"
    )
    serve = serve_decoder if decoder else serve_encoder
    serve(model, batch_size=args.batch, steps=args.gen, seed=args.seed,
          device=args.device, profile=args.profile)


if __name__ == "__main__":
    main()
