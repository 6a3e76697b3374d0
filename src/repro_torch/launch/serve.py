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
with the program's spans on (:mod:`repro_torch.deploy.spans`), and
prints for each traced call the device time by kernel (``torch.profiler``:
the top kernels, then the port's own kernels wherever they rank), the
device's busy and idle share of the traced window, the device time and
the idle time by the innermost program span (``engine/…``,
``session/…``, ``executor/<node kind>``) and the host's self time by span.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import kernels
from repro_torch.configs import get_config, reduced
from repro_torch.deploy import api, spans
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


#: the profiled call's own span: the traced window
WINDOW = "serve.window"
#: the port's own kernels, listed wherever they rank
OWN_KERNELS = ("int8_gemm", "ita_attention", "igelu_kernel", "itamax_kernel")


def union(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def innermost(nested, w0: float, w1: float) -> list:
    """[w0, w1] cut into (start, end, name) pieces, each named by the
    innermost of the properly nested ``nested`` (start, end, name) spans
    that covers it (None where none does)."""
    out: list = []
    stack: list = []
    t = w0

    def emit(end, name):
        nonlocal t
        end = min(max(end, t), w1)
        if end > t:
            out.append((t, end, name))
        t = end

    for s, e, name in sorted(nested, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            emit(stack[-1][0], stack[-1][1])
            stack.pop()
        emit(s, stack[-1][1] if stack else None)
        stack.append((e, name))
    while stack:
        emit(stack[-1][0], stack[-1][1])
        stack.pop()
    emit(w1, None)
    return out


def ms_by_span(intervals: list, pieces: list) -> dict:
    """ms of the sorted disjoint ``intervals`` inside each piece's span
    (by the span's name without its arguments), largest first."""
    by: dict = {}
    i = 0
    for s, e, name in pieces:
        while i < len(intervals) and intervals[i][1] <= s:
            i += 1
        j = i
        while j < len(intervals) and intervals[j][0] < e:
            cut = min(e, intervals[j][1]) - max(s, intervals[j][0])
            if cut > 0:
                key = "(outside the spans)" if name is None else spans.base(name)
                by[key] = by.get(key, 0.0) + cut
            j += 1
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def _by_span_line(what: str, by: dict, k: int = 10) -> None:
    top = ", ".join(f"{n} {v:.3f}" for n, v in list(by.items())[:k]) or "none"
    print(f"profile: {what} ms by program span: {top}")


def profile_call(fn, device: torch.device, top: int = 12) -> dict:
    """Trace one ``fn()`` with the program's spans on.  Over the traced
    window (the span around the call, on the trace's clock): device time
    by kernel, the device's busy share (the union of device intervals over
    the window), device time by the innermost program span (from the
    spans' device twins), idle time by the innermost program span on the
    host covering it, and the host's self time by program span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(device)
    with spans.recording(), profile(activities=activities) as prof:
        with record_function(WINDOW):
            fn()
            _sync(device)
    host, twins, device_ops, window = [], [], [], None
    for e in prof.events():
        s, t = e.time_range.start / 1e3, e.time_range.end / 1e3  # ms
        on_host = e.device_type.name == "CPU"
        if e.name == WINDOW:
            window = (s, t) if on_host else window
        elif spans.is_program(e.name):
            (host if on_host else twins).append((s, t, e.name))
        elif e.device_type.name == "CUDA":
            device_ops.append((s, t, e.name))
    w0, w1 = window
    wall = w1 - w0
    busy = union((max(s, w0), min(t, w1)) for s, t, _ in device_ops if t > w0 and s < w1)
    busy_ms = sum(e - s for s, e in busy)
    gaps = [(a, b) for (_, a), (b, _) in zip([(w0, w0)] + busy, busy + [(w1, w1)]) if b > a]
    kernels: dict = {}
    for s, t, name in device_ops:
        ms, n = kernels.get(name, (0.0, 0))
        kernels[name] = (ms + t - s, n + 1)
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    print(f"profile: traced wall {wall:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"{len(device_ops)} device kernels")
    for i, (name, (ms, n)) in enumerate(ranked):
        if i < top or any(k in name for k in OWN_KERNELS):
            print(f"  {ms:9.3f} ms {n:6d}x  {name[:90]}")
    share = busy_ms / wall if wall > 0 else 0.0
    print(f"profile: busy {100 * share:.1f}%, idle {100 * (1 - share):.1f}% of the traced "
          f"window of {wall:.3f} ms (idle {wall - busy_ms:.3f} ms)")
    out = {"wall_ms": wall, "device_busy_ms": busy_ms, "device_kernels": len(device_ops),
           "busy_share": share,
           "device_ms_by_span": ms_by_span(busy, innermost(twins, w0, w1)),
           "idle_ms_by_span": ms_by_span(gaps, innermost(host, w0, w1)),
           "host_ms_by_span": ms_by_span([(w0, w1)], innermost(host, w0, w1))}
    _by_span_line("device", out["device_ms_by_span"])
    _by_span_line("idle", out["idle_ms_by_span"])
    _by_span_line("host self", out["host_ms_by_span"])
    return out


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
        print("profile: one forward")
        stats["profile"] = profile_call(lambda: session.forward(batches[0]), session.device)
    return stats


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
    """Traced: ``max_batch`` fresh prompts of ``prompt_len`` tokens, the
    engine step that admits and prefills them (it also decodes them once),
    and the next step, pure decode."""
    dev = engine.session.device
    for p in synthesize_prompts(engine.cfg.vocab, n=engine.max_batch,
                                prompt_len=prompt_len, seed=seed + 2):
        engine.submit(p, 3)
    out = {}
    for key, what in (("profile_prefill_step", "engine step with a prefill"),
                      ("profile_decode_step", "engine step of pure decode")):
        print(f"profile: one {what}")
        out[key] = profile_call(engine.step, dev)
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
