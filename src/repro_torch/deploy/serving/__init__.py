"""Async serving frontend + SLO-aware scheduling over the engine (torch port).

The JAX package's ``deploy/serving`` package over the port's engine.

Three layers, bottom to top:

* :mod:`repro_torch.deploy.serving.scheduler` — pluggable admission policy
  (:class:`FIFO`, :class:`PriorityDeadline`), bounded-queue load
  shedding (:class:`QueueFullError`), preemption decisions;
* :mod:`repro_torch.deploy.serving.async_engine` — :class:`AsyncEngine` runs
  the continuous-batching loop on a dedicated background thread with a
  thread-safe ``submit()`` and event-driven idle wait;
  :class:`AsyncRequestHandle` adds blocking streaming iteration and a
  ``result(timeout=)`` join;
* :mod:`repro_torch.deploy.serving.frontend` — :class:`ServingFrontend`, a
  stdlib-only streaming JSON-lines HTTP server (``POST /v1/generate``,
  ``GET /v1/status/<rid>``, ``GET /v1/stats``) with graceful drain;
  runnable as ``python -m repro_torch.deploy.serving``.

Attribute access is lazy (PEP 562): :mod:`repro_torch.deploy.engine` imports
the scheduler module from this package, so an eager ``__init__`` would
re-enter the engine mid-import.  ``from repro_torch.deploy.serving import
AsyncEngine`` still works — the first attribute touch resolves it.
"""

from __future__ import annotations

_EXPORTS = {
    "Scheduler": "scheduler",
    "FIFO": "scheduler",
    "PriorityDeadline": "scheduler",
    "QueueFullError": "scheduler",
    "POLICIES": "scheduler",
    "make_scheduler": "scheduler",
    "effective_deadline": "scheduler",
    "AsyncEngine": "async_engine",
    "AsyncRequestHandle": "async_engine",
    "ServingFrontend": "frontend",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        modname = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{modname}"), name)


def __dir__():
    return __all__
