"""The traced sub-window: ``torch.profiler`` over a few units of steady work,
reduced to device time by kernel, the device's busy share and the idle
gaps by what the host was doing.

Host spans are ``record_function`` marks that the drivers put around their
calls into the program (``engine.step``, ``session.prefill_chunks``,
``session.decode``); the sub-window itself is
the span ``bench.window``.  Device events are those the profiler reports
on the CUDA device; copies and fills count as busy time.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

WINDOW_SPAN = "bench.window"
SPANS = ("engine.step", "session.prefill_chunks", "session.decode")


@dataclass
class Reduction:
    window_s: float
    busy_s: float
    device_ops: list          # [(name, start_s, end_s)] inside the window
    calls: dict = field(default_factory=dict)   # kernel -> [(ops, bytes)] traced
    idle_by_host: list = field(default_factory=list)

    def kernel_time(self, kernel: str) -> tuple[int, float]:
        """Launches and device seconds of the kernel function ``<kernel>_kernel``."""
        sel = [e - s for n, s, e in self.device_ops if f"{kernel}_kernel" in n]
        return len(sel), sum(sel)

    def top_ops(self, k: int = 10) -> list:
        tot: dict = {}
        for n, s, e in self.device_ops:
            tot[n] = tot.get(n, 0.0) + (e - s)
        return sorted(([n[:120], t] for n, t in tot.items()), key=lambda x: -x[1])[:k]


def union_s(intervals: list) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def idle_by_host(device: list, host: list, w0: float, w1: float, k: int = 10) -> list:
    """Idle device time inside [w0, w1], summed by the innermost host span
    that covers the start of each gap (``host`` [(name, start, end)])."""
    busy = sorted((s, e) for _, s, e in device)
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, min(s, w1)))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    by: dict = {}
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        covering = [(e - s, n) for n, s, e in host if s <= g0 < e]
        name = min(covering)[1] if covering else "host: outside the spans"
        by[name] = by.get(name, 0.0) + (g1 - g0)
    return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:k]


def reduce_events(events, calls: dict) -> Reduction:
    """Reduce ``prof.events()`` of one traced sub-window."""
    device, host, window = [], [], None
    for e in events:
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        on_host = e.device_type.name == "CPU"
        if e.name == WINDOW_SPAN or e.name in SPANS:
            # a span's twin on the device (a GPU user annotation) is no work
            if on_host and e.name == WINDOW_SPAN:
                window = (s, t)
            elif on_host:
                host.append((e.name, s, t))
        elif e.device_type.name == "CUDA":
            device.append((e.name, s, t))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN!r} span")
    w0, w1 = window
    inside = [(n, max(s, w0), min(t, w1)) for n, s, t in device if t > w0 and s < w1]
    return Reduction(window_s=w1 - w0, busy_s=union_s([(s, t) for _, s, t in inside]),
                     device_ops=inside, calls=dict(calls),
                     idle_by_host=idle_by_host(inside, host, w0, w1))


@contextlib.contextmanager
def profiled(sink: list):
    """Profile the body on the host and the card (the host alone where there
    is no card, as in the CPU tests); appends the events to ``sink``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            yield
            sync()
    sink.extend(prof.events())
