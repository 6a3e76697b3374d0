"""Background-threaded serving loop: :class:`AsyncEngine` (torch port).

The JAX package's ``deploy/serving/async_engine.py`` over the port's
engine.  On the card, the loop thread is the only thread that launches
work: it takes the session's device as its current device and the
stream that was current on the constructing thread as its own, so every
dispatch queues where the session's tensors were made.

The synchronous :class:`~repro_torch.deploy.engine.Engine` runs its
continuous-batching loop on the caller's thread — fine for benchmarks,
useless for serving: nobody can submit while the loop is stepping.
``AsyncEngine`` moves the loop onto ONE dedicated daemon thread and
makes the edges thread-safe:

* ``submit()`` is callable from any thread (the engine's queue frontier
  is lock-protected); it wakes the loop via a condition variable — the
  loop *waits* on that condition when idle, so an empty engine costs
  zero CPU (no busy-spin);
* ``cancel()`` of a possibly-resident request is routed *to* the loop
  thread through a mailbox (resident state — slots, KV, block tables —
  belongs exclusively to the loop thread; see the session's thread
  affinity);
* every completed step broadcasts on the same condition, which is what
  :class:`AsyncRequestHandle` blocks on: ``for tok in handle`` streams
  tokens as they are sampled, ``handle.result(timeout=)`` joins.

Lock order is ``condition -> engine lock`` only (the loop reads
``engine.idle`` — which takes the engine lock — while holding the
condition; no path nests them the other way), so the pair cannot
deadlock.

If a step raises, the loop parks the exception, finishes every live
request with reason ``"error"`` and stops; waiters re-raise the original
exception instead of hanging.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Sequence

import torch

from repro_torch.deploy.engine import Engine, RequestHandle, RequestStatus
from repro_torch.deploy.sanitize import make_condition


class AsyncRequestHandle:
    """Thread-safe view of one in-flight request.

    Wraps the engine's :class:`~repro_torch.deploy.engine.RequestHandle`
    (``.handle``; its ``tokens`` list is appended only by the loop
    thread) and adds blocking consumption:

    * ``for tok in ahandle:`` — yields each generated token as it is
      sampled, ending when the request finishes (any reason);
    * ``result(timeout=)`` — blocks until the request finishes and
      returns the underlying handle; raises ``TimeoutError`` on expiry
      and re-raises the engine's exception if the loop died.

    Both are safe from any number of consumer threads at once (each
    iterator keeps its own cursor; tokens are never popped).
    """

    def __init__(self, engine: "AsyncEngine", handle: RequestHandle):
        self._aengine = engine
        self.handle = handle

    # -- delegating views ---------------------------------------------------

    @property
    def rid(self) -> int:
        return self.handle.rid

    @property
    def tokens(self) -> list:
        return self.handle.tokens

    @property
    def status(self) -> RequestStatus:
        return self.handle.status

    @property
    def finish_reason(self) -> str | None:
        return self.handle.finish_reason

    @property
    def done(self) -> bool:
        return self.handle.done

    def cancel(self) -> None:
        self._aengine.cancel(self)

    # -- blocking consumption ----------------------------------------------

    def __iter__(self):
        """Stream generated tokens, blocking until each is sampled."""
        i = 0
        cv = self._aengine._cv
        while True:
            with cv:
                while (len(self.handle.tokens) <= i and not self.handle.done
                       and self._aengine._error is None):
                    cv.wait()
                err = self._aengine._error
                n = len(self.handle.tokens)
                finished = self.handle.done
            while i < n:
                yield self.handle.tokens[i]
                i += 1
            if finished and i >= len(self.handle.tokens):
                return
            if err is not None:
                raise err

    def result(self, timeout: float | None = None) -> RequestHandle:
        """Block until the request finishes; return the raw handle."""
        cv = self._aengine._cv
        with cv:
            ok = cv.wait_for(
                lambda: self.handle.done or self._aengine._error is not None,
                timeout)
            if not ok:
                raise TimeoutError(
                    f"request rid={self.handle.rid} not finished within "
                    f"{timeout}s (status={self.handle.status.value}, "
                    f"{len(self.handle.tokens)} tokens so far)")
            if self._aengine._error is not None and not self.handle.done:
                raise self._aengine._error
        return self.handle

    def __repr__(self) -> str:
        return f"Async{self.handle!r}"


class AsyncEngine:
    """Run an :class:`~repro_torch.deploy.engine.Engine` on a background thread.

    ``AsyncEngine(compiled_model, max_batch, **engine_kwargs)`` builds
    the engine and starts the loop immediately; passing a ready
    ``Engine`` adopts it (it must not have live work — the loop thread
    takes exclusive ownership of slot/device state).  Use as a context
    manager for deterministic teardown::

        with AsyncEngine(model, max_batch=8) as eng:
            h = eng.submit(prompt, max_new_tokens=64)
            for tok in h:          # streams as sampled
                ...

    ``close(drain=True)`` (the context-manager default) lets queued and
    resident work finish before stopping; ``close(drain=False)`` cancels
    everything still live and stops after the current step.
    """

    def __init__(self, model, max_batch: int | None = None, **engine_kwargs):
        if isinstance(model, Engine):
            if max_batch is not None or engine_kwargs:
                raise ValueError(
                    "adopting a ready Engine: max_batch/engine kwargs were "
                    "already chosen when it was built")
            if not model.idle:
                raise ValueError(
                    "adopted Engine has live work; the loop thread needs "
                    "exclusive ownership from the start — hand it an idle "
                    "engine")
            self.engine = model
        else:
            self.engine = Engine(model, max_batch, **engine_kwargs)
        # "serving.cv" outranks "engine.lock" in the declared lattice
        # (sanitize.LOCK_LATTICE); under REPRO_SANITIZE=1 this is a
        # lockdep-tracked condition that flags order inversions
        self._cv = make_condition("serving.cv")
        dev = self.engine.session.device
        # the stream the session's tensors were made on (the default
        # stream unless the caller chose another)
        self._stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        self._cancels: deque[RequestHandle] = deque()
        self._stop = False
        self._drain_on_stop = True
        self._error: BaseException | None = None
        self._thread = threading.Thread(
            target=self._run, name="repro-engine-loop", daemon=True)
        self._thread.start()

    # -- submission (any thread) --------------------------------------------

    def submit(
        self,
        prompt_tokens: Sequence[int],
        max_new_tokens: int,
        *,
        eos_id: int | None = None,
        on_token: Callable[[int], None] | None = None,
        priority: int = 0,
        ttft_slo_ms: float | None = None,
        deadline_ms: float | None = None,
    ) -> AsyncRequestHandle:
        """Thread-safe :meth:`Engine.submit`; wakes the loop.

        Raises exactly what the engine raises — ``ValueError`` /
        ``KVCapacityError`` for invalid requests,
        :class:`~repro_torch.deploy.serving.scheduler.QueueFullError` when the
        bounded queue sheds (synchronously, so a frontend can answer
        429 before any handle exists).
        """
        if self._error is not None:
            raise RuntimeError("engine loop died") from self._error
        with self._cv:
            if self._stop:
                raise RuntimeError("AsyncEngine is closed (draining/stopped)")
            handle = self.engine.submit(
                prompt_tokens, max_new_tokens, eos_id=eos_id,
                on_token=on_token, priority=priority,
                ttft_slo_ms=ttft_slo_ms, deadline_ms=deadline_ms)
            self._cv.notify_all()
        return AsyncRequestHandle(self, handle)

    def cancel(self, handle) -> None:
        """Cancel from any thread.

        Queued requests are withdrawn inline (the queue frontier is
        lock-protected); a possibly-resident request is routed to the
        loop thread's mailbox — resident slot/KV state is loop-owned.
        """
        raw = handle.handle if isinstance(handle, AsyncRequestHandle) else handle
        if threading.current_thread() is self._thread:
            self.engine.cancel(raw)  # already on the owning thread
            return
        with self._cv:
            self._cancels.append(raw)
            self._cv.notify_all()

    # -- introspection --------------------------------------------------------

    @property
    def stats(self):
        return self.engine.stats

    def stats_snapshot(self):
        """One consistent :class:`EngineStats` copy taken under the
        engine lock — safe to read field-by-field from any thread while
        the loop is stepping (``/v1/stats``, benchmark CSVs)."""
        return self.engine.stats_snapshot()

    @property
    def idle(self) -> bool:
        return self.engine.idle and not self._cancels

    def drain(self, timeout: float | None = None) -> None:
        """Block until every submitted request has finished."""
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self.idle or self._error is not None, timeout)
        if not ok:
            raise TimeoutError(f"engine not idle within {timeout}s")
        if self._error is not None:
            raise RuntimeError("engine loop died") from self._error

    # -- lifecycle ------------------------------------------------------------

    def close(self, drain: bool = True, timeout: float | None = None) -> None:
        """Stop the loop thread.  ``drain=True`` finishes live work
        first (new submissions are refused immediately either way);
        ``drain=False`` cancels whatever is still queued or resident."""
        with self._cv:
            self._stop = True
            self._drain_on_stop = drain
            self._cv.notify_all()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"engine loop did not stop within {timeout}s")

    def __enter__(self) -> "AsyncEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)

    # -- the loop thread ------------------------------------------------------

    def _work_pending(self) -> bool:
        return bool(self._cancels) or not self.engine.idle

    def _run(self) -> None:
        # the engine's session was built on the constructor's thread; the
        # loop takes exclusive ownership of all mutating calls from here
        self.engine.session.rebind_thread()
        try:
            if self._stream is not None:
                # the current device and stream are per thread
                torch.cuda.set_device(self._stream.device)
                torch.cuda.set_stream(self._stream)
            while True:
                with self._cv:
                    while not self._stop and not self._work_pending():
                        self._cv.wait()
                    if self._stop and (not self._drain_on_stop
                                       or not self._work_pending()):
                        break
                    cancels = []
                    while self._cancels:
                        cancels.append(self._cancels.popleft())
                # resident-state mutation happens OUTSIDE the condition:
                # streamers only need the post-step broadcast
                for raw in cancels:
                    self.engine.cancel(raw)
                if not self.engine.idle:
                    self.engine.step()
                with self._cv:
                    self._cv.notify_all()
            if not self._drain_on_stop:
                for h in list(self.engine._slots):
                    if h is not None:
                        self.engine.cancel(h)
                with self.engine._lock:
                    while True:
                        q = self.engine.scheduler.pop(self.engine.clock())
                        if q is None:
                            break
                        self.engine._finish(q, "cancelled",
                                            status=RequestStatus.EVICTED)
        except BaseException as e:  # noqa: BLE001 - park it for the waiters
            self._error = e
            for h in list(self.engine._slots):
                if h is not None:
                    self.engine._finish(h, "error",
                                        status=RequestStatus.EVICTED)
        finally:
            with self._cv:
                self._stop = True
                self._cv.notify_all()
