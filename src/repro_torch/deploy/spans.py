"""Named phases of the engine, the session and the executor, timed on the
host and, while the switch is on, marked on the profiler's timeline.

A span is a named stretch of host work.  Its name carries one prefix per
layer: ``engine/…`` (:mod:`repro_torch.deploy.engine`), ``session/…``
(:class:`~repro_torch.deploy.api.InferenceSession`) and ``executor/…``
(:func:`repro_torch.deploy.executor.execute`, one span per plan node).

* :class:`Phases` is the engine's: one per engine step, it adds each
  span's *self* time (its wall time less that of the spans it encloses) and
  a call to dicts by name, which the engine folds into ``EngineStats``
  once a step.  That accounting is always on; it costs two clock reads a
  span, and the engine opens spans per phase and per request, never per
  plan node.
* :func:`annotate` is the session's and the executor's: a profiler mark
  only, nothing while the switch is off.

While the process-wide switch is on (:func:`recording`, off by default),
every span also enters ``torch.profiler.record_function``, so a profile
shows it on the host's timeline and, as a GPU user annotation, on the
device's, on the clock of the device trace.  A span's arguments (the
request ids of its lanes, a plan node's name) ride in the event's name
after the span's own, in brackets: ``engine/sample[rid=7]``.  The profiler
drops ``record_function``'s own ``args`` string from its events, so that
is the one place a reader of the trace finds them; :func:`base` strips
them again.  The switch stays off while a benchmark traces the program:
its reduction would count the annotations' device twins as busy time.
"""

from __future__ import annotations

import contextlib
import time

#: the prefixes of the program's span names, one a layer
PREFIXES = ("engine/", "session/", "executor/")

_on = False
_NULL = contextlib.nullcontext()


def enabled() -> bool:
    """Is the profiler switch on (spans marked on the timeline)?"""
    return _on


@contextlib.contextmanager
def recording():
    """Turn the switch on for the body (it is restored after)."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


def base(name: str) -> str:
    """A traced span's name without its arguments."""
    return name.split("[", 1)[0]


def is_program(name: str) -> bool:
    """Is a traced event one of the program's spans?"""
    return name.startswith(PREFIXES)


def _mark(name: str, args: str | None):
    from torch.profiler import record_function

    return record_function(name if args is None else f"{name}[{args}]")


def annotate(name: str, args: str | None = None):
    """A profiler mark around the body while the switch is on; else nothing."""
    return _mark(name, args) if _on else _NULL


class Phases:
    """Host seconds (self time) and calls by span name, over one engine step.

    ``span(name, rids)`` opens a span over the requests ``rids`` (request
    ids, formatted only while the switch is on); ``span(name,
    phase=False)`` one whose time is the caller's to record (a dispatch's
    enqueue or fetch, which ``EngineStats`` keeps in fields of their own):
    it still leaves the enclosing phase's self time, but is not added by
    name.  Read its ``seconds`` after the ``with``.
    """

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self._inner: list[float] = []  # per open span: seconds its children took

    def span(self, name: str, rids=(), *, phase: bool = True) -> "_Span":
        return _Span(self, name, rids, phase)


class _Span:
    __slots__ = ("phases", "name", "rids", "phase", "mark", "t0", "seconds")

    def __init__(self, phases: Phases, name: str, rids, phase: bool):
        self.phases, self.name, self.rids, self.phase = phases, name, rids, phase
        self.seconds = 0.0

    def __enter__(self) -> "_Span":
        self.mark = None
        if _on:
            args = "rid=" + ",".join(map(str, self.rids)) if self.rids else None
            self.mark = _mark(self.name, args)
            self.mark.__enter__()
        self.phases._inner.append(0.0)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = time.perf_counter() - self.t0
        ph = self.phases
        inner = ph._inner.pop()
        if ph._inner:
            ph._inner[-1] += self.seconds
        if self.phase:
            ph.seconds[self.name] = ph.seconds.get(self.name, 0.0) + self.seconds - inner
            ph.calls[self.name] = ph.calls.get(self.name, 0) + 1
        if self.mark is not None:
            self.mark.__exit__(*exc)
        return False
