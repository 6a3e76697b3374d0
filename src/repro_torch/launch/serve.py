"""Serving entry point of the port: the request-level engine over the compiled plan.

``compile()`` lowers the config (plan cache hit or miss is printed).  For
an encoder, ``InferenceSession.forward`` answers ``--gen`` batches of
``--batch`` synthetic requests on the card and prints the throughput
with the device's name:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mobilebert --batch 8 --gen 4

A dense decoder (``--arch olmo-1b``, the default) is served by the continuous-batching
``repro_torch.deploy.engine.Engine``, as in the JAX package: ``--requests``
prompts (lengths staggered over ``--prompt-len`` .. ``--prompt-len +
--extra-prompt``) are *submitted*, and the engine owns admission, the
per-request depths, eviction and slot recycling over ``--batch`` slots.
The pair is compiled for ``--prompt-len`` tokens and a KV region of
``prompt-len + extra-prompt + gen + 1`` rows a slot.  It prints the
engine's summary (tok/s, TTFT / TPOT / step percentiles, occupancy), the
ms of a prefill dispatch and of a decode step, and the kernels' launches
per prefill dispatch and per decode step:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --prompt-len 128 --gen 16 --batch 8

``--kv-block-size`` (with ``--kv-blocks``, which defaults to enough
blocks for every slot's whole region) compiles the pair over a paged KV
region, a shared pool of blocks with per-slot block tables: prompts then
prefill in chunks, and the summary gives the pool's size and its free
blocks at the end.  ``--scheduler`` / ``--max-queue`` / ``--aging-s``
pick the admission policy, ``--sampling temperature`` the sampler.
``--head-by-head`` lowers an encoder with the paper's per-head schedule.
``--sanitize`` (``REPRO_SANITIZE=1``) serves under the concurrency and
KV-lifetime sanitizer: lockdep-tracked locks and the shadow block pool.

The default backend, ``w8a8``, runs the paper-faithful integer
arithmetic (on the card its rowwise softmax is the ``itamax`` kernel);
``--backend ita`` runs the CUDA kernels.  ``--via-plan`` is accepted for
compatibility (serving is always plan-backed), and a family that plan
lowering does not support exits with ``cannot serve <name>: ...``, as in
the JAX package.  ``--device cpu`` runs the plain PyTorch versions on the CPU.
``--profile`` traces, after the timed run, one batch (encoder) or one
engine step that holds a prefill and one step of pure decode (decoder),
and prints the device time by kernel (``torch.profiler``: the top
kernels, then the port's own kernels wherever they rank) and the
device's busy share of the same work untraced.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import kernels
from repro_torch.configs import get_config, reduced
from repro_torch.deploy import api
from repro_torch.deploy.paging import blocks_for_rows
from repro_torch.launch.cli import (
    add_engine_args,
    add_plan_args,
    add_sanitize_args,
    add_serving_args,
    apply_sanitize_args,
    make_sampling,
    make_scheduler_from_args,
    resolve_requests,
    synthesize_prompts,
)

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


class DispatchCounter:
    """Counts a decoder session's dispatches and the kernel launches each
    makes: ``prefill_slot`` and ``prefill_chunks`` calls are ``"prefill"``,
    ``decode`` calls ``"decode"``.  It wraps those three methods on the
    session object (the engine calls them there); a call that raises is
    not counted."""

    KINDS = {"prefill_slot": "prefill", "prefill_chunks": "prefill", "decode": "decode"}

    def __init__(self, session: api.InferenceSession):
        self._wrappers = kernels.wrappers()
        self.reset()
        for method, kind in self.KINDS.items():
            setattr(session, method, self._counted(getattr(session, method), kind))

    def reset(self) -> None:
        self.calls = {"prefill": 0, "decode": 0}
        self.launches = {"prefill": {}, "decode": {}}

    def _counted(self, fn, kind: str):
        def counted(*args, **kwargs):
            before = {name: w.launches for name, w in self._wrappers.items()}
            out = fn(*args, **kwargs)
            self.calls[kind] += 1
            for name, w in self._wrappers.items():
                if w.launches > before[name]:
                    got = self.launches[kind]
                    got[name] = got.get(name, 0) + w.launches - before[name]
            return out
        return counted

    def per_call(self, kind: str) -> dict:
        """Each kernel's launches per dispatch of ``kind``."""
        n = max(1, self.calls[kind])
        return {name: c / n for name, c in self.launches[kind].items()}


def compile_for_serving(cfg, args, *, extra_prompt: int = 0) -> api.CompiledModel:
    """One ``compile()`` call for both families (the shared CLI surface):
    a decoder's KV region holds ``prompt-len + extra_prompt + gen + 1``
    rows a slot, over a paged pool with ``--kv-block-size``."""
    kw = dict(head_by_head=getattr(args, "head_by_head", False))
    if api.is_dense_decoder(cfg):
        max_len = args.prompt_len + extra_prompt + args.gen + 1
        kw.update(seq_len=args.prompt_len, max_len=max_len)
        blocks = args.kv_blocks
        if args.kv_block_size and blocks is None:
            blocks = args.batch * blocks_for_rows(max_len, args.kv_block_size)
        kw.update(kv_block_size=args.kv_block_size, kv_blocks=blocks)
    t0 = time.perf_counter()
    model = api.compile(cfg, backend=args.backend, cache_dir=args.plan_cache,
                        use_cache=not args.no_plan_cache, **kw)
    print(
        f"compile [{model.backend.value}] {cfg.name}: {model.kind} artifact, plan cache "
        f"{'hit' if model.cache_hit else 'miss'} ({model.fingerprint[:12]}, "
        f"v{model.compiler_version}) in {time.perf_counter() - t0:.2f}s"
    )
    return model


def _launches(per: dict) -> str:
    return ", ".join(f"{n} {c:g}x" for n, c in per.items()) or "none"


def serve_decoder(model: api.CompiledModel, *, max_batch: int, requests: int, prompt_len: int,
                  extra_prompt: int, gen: int, sampling=None, scheduler=None, seed: int = 0,
                  device: str | None = None, profile: bool = False) -> dict:
    """Request-level serving: submit -> schedule -> stream, engine only;
    returns the stats.

    One request of ``prompt_len`` tokens runs first as a warm-up (it also
    builds the kernels on first use); the stats and counters start
    afresh after it.
    """
    from repro_torch.deploy.engine import Engine

    cfg, pair = model.cfg, model.artifact
    t0 = time.perf_counter()
    engine = Engine(model, max_batch, sampling=sampling, scheduler=scheduler, seed=seed,
                    device=device)
    session = engine.session
    counter = DispatchCounter(session)
    warm = synthesize_prompts(cfg.vocab, n=1, prompt_len=prompt_len, seed=seed + 1)[0]
    engine.submit(warm, 2)
    engine.run_until_idle()
    if engine.prefix_index is not None:
        engine.prefix_index.drop_all()
    t_setup = time.perf_counter() - t0
    engine.reset_stats()
    counter.reset()
    prompts = synthesize_prompts(cfg.vocab, n=requests, prompt_len=prompt_len,
                                 extra=extra_prompt, seed=seed)
    t0 = time.perf_counter()
    handles = [engine.submit(p, gen) for p in prompts]
    stats = engine.run_until_idle()
    _sync(session.device)
    t_run = time.perf_counter() - t0
    per_prefill, per_step = counter.per_call("prefill"), counter.per_call("decode")
    out = {
        "arch": cfg.name,
        "backend": model.backend.value,
        "device": device_name(session.device),
        "batch": max_batch,
        "paged": pair.paged,
        "requests": requests,
        "seconds": t_run,
        "prefill_dispatches": stats.prefill_dispatches,
        "decode_steps": stats.decode_dispatches,
        "prefill_ms": 1e3 * stats.prefill_time_s / max(1, stats.prefill_dispatches),
        "decode_ms_per_step": 1e3 * stats.decode_time_s / max(1, stats.decode_dispatches),
        "tok_per_s": stats.tokens_per_s(),
        "ttft_ms": (1e3 * stats.ttft(50), 1e3 * stats.ttft(99)),
        "tpot_ms": (1e3 * stats.tpot(50), 1e3 * stats.tpot(99)),
        "kernel_launches_per_prefill": per_prefill,
        "kernel_launches_per_decode_step": per_step,
        "tokens": [h.tokens for h in handles],
    }
    region = f"dense KV region of {pair.max_len} rows a slot"
    if pair.paged:
        out["blocks_free"] = session.blocks_free
        region = (f"paged KV pool of {pair.kv_blocks} blocks of {pair.kv_block_size} rows "
                  f"({session.blocks_free} free after the run)")
    counts = pair.counts()
    print(
        f"engine-serving [{model.backend.value}] {cfg.name} on {out['device']}, {region}: plan "
        f"nodes prefill {counts['prefill']['nodes']} ({counts['prefill']['ita']} ita), decode "
        f"{counts['decode']['nodes']} ({counts['decode']['ita']} ita); bind+warm-up "
        f"{t_setup:.2f}s; {requests} requests of {prompt_len}-{prompt_len + extra_prompt} "
        f"prompt tokens in {t_run:.3f}s"
    )
    print(f"  {stats.summary()}")
    print(
        f"  {stats.prefill_dispatches} prefill dispatches at {out['prefill_ms']:.3f} ms; "
        f"{stats.decode_dispatches} decode steps of {max_batch} slots at "
        f"{out['decode_ms_per_step']:.3f} ms a step; kernels per prefill dispatch: "
        f"{_launches(per_prefill)}; per decode step: {_launches(per_step)}"
    )
    for h in handles[:2]:
        print(f"  request {h.rid}: prompt {len(h.prompt)} tokens -> {h.tokens[:8]} "
              f"({h.finish_reason})")
    if profile:
        out.update(_profile_steps(engine, prompt_len, seed))
    return out


def _profile_steps(engine, prompt_len: int, seed: int) -> dict:
    """Untraced, then traced: ``max_batch`` fresh prompts of ``prompt_len``
    tokens, the engine step that admits and prefills them (it also decodes
    them once), and the next step, pure decode."""
    dev = engine.session.device
    untraced = {}

    def admit():
        for p in synthesize_prompts(engine.cfg.vocab, n=engine.max_batch,
                                    prompt_len=prompt_len, seed=seed + 2):
            engine.submit(p, 3)

    def timed_step():
        _sync(dev)
        t = time.perf_counter()
        engine.step()
        _sync(dev)
        return 1e3 * (time.perf_counter() - t)

    admit()
    untraced["prefill"], untraced["decode"] = timed_step(), timed_step()
    engine.run_until_idle()
    admit()
    out = {"profile_prefill_step": _profile(engine.step, dev, untraced["prefill"],
                                            "engine step with a prefill"),
           "profile_decode_step": _profile(engine.step, dev, untraced["decode"],
                                           "engine step of pure decode")}
    engine.run_until_idle()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true", help="tiny same-family variant")
    ap.add_argument("--extra-prompt", type=int, default=2,
                    help="decoder: stagger prompt lengths up to this many tokens past "
                         "--prompt-len")
    add_engine_args(ap)
    add_serving_args(ap)
    add_sanitize_args(ap)
    add_plan_args(ap, via_plan_help="accepted for compatibility; serving is "
                  "always plan-backed (compile() -> Engine/InferenceSession)")
    ap.add_argument("--head-by-head", action="store_true",
                    help="encoder: lower with the paper's per-head MHA schedule")
    ap.add_argument("--profile", action="store_true",
                    help="trace one batch (encoder) or two engine steps (decoder) and print "
                         "device time by kernel")
    args = ap.parse_args(argv)
    apply_sanitize_args(args)  # before any engine/allocator exists

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    try:
        model = compile_for_serving(cfg, args, extra_prompt=args.extra_prompt)
    except api.UnsupportedFamilyError as e:
        raise SystemExit(f"cannot serve {cfg.name}: {e}") from None
    if model.kind == "encoder":
        return serve_encoder(model, batch_size=args.batch, steps=args.gen, seed=args.seed,
                             device=args.device, profile=args.profile)
    return serve_decoder(
        model, max_batch=args.batch, requests=resolve_requests(args),
        prompt_len=args.prompt_len, extra_prompt=args.extra_prompt, gen=args.gen,
        sampling=make_sampling(args), scheduler=make_scheduler_from_args(args),
        seed=args.seed, device=args.device, profile=args.profile)


if __name__ == "__main__":
    main()
