"""Pluggable admission scheduling for the serving engine (torch port).

A copy of the JAX package's ``deploy/serving/scheduler.py``, which holds
no JAX: the same policies pop the same order for the same operations.
The :class:`~repro_torch.deploy.engine.Engine` used to hard-code FIFO
admission inside its step loop; this module makes the policy a value.
A :class:`Scheduler` owns exactly one thing — the *queue of not-yet-
resident requests* — and answers three questions each scheduler step:

* **order** — which queued request is admitted into the next free slot
  (:meth:`Scheduler.peek` / :meth:`Scheduler.pop`);
* **preemption** — which *residents* should be evicted back to the
  queue so a more urgent queued request can have their slot
  (:meth:`Scheduler.victims`; paged KV makes the requeue cheap — the
  victim's blocks free immediately and its prefix re-prefills in
  chunks);
* **backpressure** — whether a new submission is accepted at all: a
  bounded queue (``max_queue``) sheds load with a structured
  :class:`QueueFullError` carrying a ``retry_after_s`` estimate, so a
  frontend can answer ``429 Retry-After`` instead of letting latency
  grow without bound.  A ranking policy may instead *displace*: when the
  newcomer strictly outranks the worst queued request, :meth:`Scheduler.add`
  returns that worst request for the engine to finish with reason
  ``"shed"`` and admits the newcomer — overload drops the lowest-value
  work, not whichever request was unlucky enough to arrive last.

Two policies ship:

* :class:`FIFO` — submission order, never preempts; with
  ``max_queue=None`` this is exactly the engine's historical behavior
  (the default-compatible policy).
* :class:`PriorityDeadline` — orders by ``(aged priority, effective
  deadline, arrival)`` where the effective deadline is derived from the
  request's ``ttft_slo_ms`` / ``deadline_ms``; priorities *age* (a
  request's priority improves the longer it waits) so low-priority
  traffic is starvation-free, and residents that have blown their
  ``deadline_ms`` budget are preempted when a strictly more urgent
  request is waiting.

Schedulers never touch engine or device state and never read ambient
wall-clock time — the engine passes ``now`` (its injectable ``clock``)
into every call, so policies are deterministic under a fake clock in
tests.  Thread safety is the engine's job (it serializes every
scheduler call under its submission lock); implementations here are
plain single-threaded data structures.
"""

from __future__ import annotations

import math
from collections import deque
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids the engine cycle
    from repro_torch.deploy.engine import RequestHandle


class QueueFullError(RuntimeError):
    """A bounded admission queue shed this submission (backpressure).

    Structured so a frontend can answer with real backpressure instead
    of a stringly error: ``queue_depth`` / ``max_queue`` describe the
    queue that refused, ``retry_after_s`` is the scheduler's estimate of
    when capacity will exist again (an HTTP frontend maps it onto a
    ``429`` + ``Retry-After`` header).  Requeues of *preempted* requests
    never shed — admission already happened; the bound applies to new
    work only.
    """

    def __init__(self, queue_depth: int, max_queue: int,
                 retry_after_s: float):
        self.queue_depth = int(queue_depth)
        self.max_queue = int(max_queue)
        self.retry_after_s = float(retry_after_s)
        super().__init__(
            f"admission queue full ({self.queue_depth}/{self.max_queue} "
            f"queued); retry after ~{self.retry_after_s:.3f}s"
        )


class Scheduler:
    """Admission-policy contract (see the module docstring).

    Subclasses implement the queue; the engine guarantees:

    * every call happens under the engine's submission lock (no
      concurrent calls);
    * ``now`` is monotonic within one engine's lifetime (the engine's
      injectable ``clock``, *not* ambient time);
    * a handle is in exactly one place at a time — queued here, resident
      in a slot, or finished — and the engine moves it between those
      states only through this interface (``add``/``requeue`` in,
      ``pop``/``remove`` out).
    """

    name = "base"

    def __init__(self, max_queue: int | None = None):
        if max_queue is not None and max_queue < 0:
            raise ValueError(f"max_queue must be >= 0 or None, got {max_queue}")
        self.max_queue = max_queue
        # EWMA of the interval between admissions — the retry-after
        # estimate a shed response carries.  Seeded pessimistically; the
        # first few pops converge it onto the real service rate.
        self._pop_ewma_s = 0.05
        self._last_pop_t: float | None = None

    # -- bookkeeping shared by implementations ------------------------------

    def _assert_serialized(self) -> None:
        """Prove the engine's serialization contract on every mutation.

        The engine installs its submission lock as ``self.guard_lock``;
        under ``REPRO_SANITIZE=1`` that lock is lockdep-tracked and this
        raises a LOCK006 diagnostic if a mutating call arrives without
        it held.  Free-standing schedulers (tests, benchmarks) have no
        ``guard_lock`` and skip the check."""
        lock = getattr(self, "guard_lock", None)
        if lock is not None:
            from repro_torch.deploy.sanitize import require_held

            require_held(lock, f"scheduler.{type(self).__name__}")

    def _shed_check(self, queue_depth: int, now: float) -> None:
        self._assert_serialized()
        if self.max_queue is not None and queue_depth >= self.max_queue:
            raise QueueFullError(queue_depth, self.max_queue,
                                 self.retry_after_s(queue_depth))

    def _note_pop(self, now: float) -> None:
        self._assert_serialized()
        if self._last_pop_t is not None:
            dt = max(1e-4, now - self._last_pop_t)
            self._pop_ewma_s += 0.25 * (dt - self._pop_ewma_s)
        self._last_pop_t = now

    def retry_after_s(self, queue_depth: int) -> float:
        """Backpressure estimate: roughly one admission interval per
        queued request ahead of the shed one."""
        return max(1e-3, self._pop_ewma_s * (queue_depth + 1))

    def snapshot(self) -> dict:
        """Queue-health stats for monitoring surfaces (``/v1/stats``):
        policy name, depth, shed threshold, and the admission-interval
        EWMA behind :meth:`retry_after_s`."""
        depth = len(self)
        return {
            "policy": self.name,
            "queue_depth": depth,
            "max_queue": self.max_queue,
            "pop_interval_ewma_s": self._pop_ewma_s,
            "retry_after_s": self.retry_after_s(depth),
        }

    # -- the policy surface -------------------------------------------------

    def __len__(self) -> int:
        raise NotImplementedError

    def add(self, handle: "RequestHandle", now: float) -> "RequestHandle | None":
        """Accept a new submission or raise :class:`QueueFullError`.

        May instead accept by *displacement*: the returned handle (if not
        None) is a previously queued, strictly lower-ranked request that
        lost its place — the engine must finish it with reason
        ``"shed"``.  FIFO never displaces."""
        raise NotImplementedError

    def requeue(self, handle: "RequestHandle", now: float) -> None:
        """Re-admit a preempted resident.  Never sheds (the request was
        already accepted); the handle keeps its original arrival time so
        aging continues from first submission (starvation-freedom)."""
        raise NotImplementedError

    def peek(self, now: float) -> "RequestHandle | None":
        """The request the policy would admit next (None when empty).
        The engine peeks before popping so admission can refuse without
        reordering: a head that does not fit the pool — or whose prompt
        a resident is mid-prefilling (prefix-cache deferral: waiting one
        step turns the admission into a shared-block hit) — blocks the
        queue until the blocker resolves; no overtaking.  ``peek`` must
        therefore be non-consuming and stable across repeated calls with
        no intervening mutation."""
        raise NotImplementedError

    def pop(self, now: float) -> "RequestHandle | None":
        raise NotImplementedError

    def remove(self, handle: "RequestHandle") -> bool:
        """Withdraw a queued handle (cancellation); False if absent."""
        raise NotImplementedError

    def victims(self, residents: list, now: float) -> list:
        """Residents to preempt-to-queue this step (default: none)."""
        return []


class FIFO(Scheduler):
    """Submission order, no preemption — the default-compatible policy.

    ``FIFO()`` (unbounded) is byte-for-byte the engine's historical
    admission behavior; ``FIFO(max_queue=N)`` adds load shedding only.
    """

    name = "fifo"

    def __init__(self, max_queue: int | None = None):
        super().__init__(max_queue)
        self._q: deque = deque()

    def __len__(self) -> int:
        return len(self._q)

    def add(self, handle, now: float) -> None:
        self._shed_check(len(self._q), now)
        self._q.append(handle)
        return None

    def requeue(self, handle, now: float) -> None:
        self._q.append(handle)

    def peek(self, now: float):
        return self._q[0] if self._q else None

    def pop(self, now: float):
        if not self._q:
            return None
        self._note_pop(now)
        return self._q.popleft()

    def remove(self, handle) -> bool:
        try:
            self._q.remove(handle)
            return True
        except ValueError:
            return False


class PriorityDeadline(Scheduler):
    """SLO-aware admission: ``(aged priority, effective deadline,
    arrival)`` ordering with deadline-driven preemption.

    Each request carries (all optional at submit):

    * ``priority`` — int, **lower is more urgent** (nice-style); default 0;
    * ``ttft_slo_ms`` — target time-to-first-token: the admission
      deadline becomes ``arrival + ttft_slo_ms``;
    * ``deadline_ms`` — completion budget: past ``arrival +
      deadline_ms`` the request is *over budget* and preemptible.

    The sort key at time ``now`` is::

        (priority - floor((now - arrival) / aging_s),   # aged priority
         min(arrival + ttft_slo, arrival + deadline),   # effective deadline
         arrival_seq)                                    # submission order

    Aging subtracts one priority level per ``aging_s`` seconds waited,
    so any finite-priority request eventually outranks a bounded stream
    of higher-priority arrivals — the queue is starvation-free (property
    tested).  Ties break by effective deadline, then strict submission
    order, so the key is a total order.

    **Preemption**: a resident is a victim when (a) it has a
    ``deadline_ms`` and ``now`` is past it (over budget), and (b) some
    *queued* request strictly outranks it under the same key.  Victims
    go back to the queue (the engine frees their slot + KV blocks and
    later re-prefills their prefix — bit-exact resume), at most one
    victim per outranking queued request per step, worst-ranked victims
    first.

    **Displacement shedding**: with a bounded queue, a full queue does
    not automatically refuse the newcomer.  If any queued request is
    already *expired* (``now`` past its effective admission deadline —
    its SLO is lost no matter what), the worst-ranked expired one is
    displaced for ANY newcomer: that shed can never cost goodput.
    Otherwise the newcomer displaces the worst-ranked queued request iff
    it strictly outranks it.  :meth:`add` returns the displaced handle
    and the engine finishes it with reason ``"shed"``; only when nothing
    is expired and the newcomer outranks nobody does
    :class:`QueueFullError` fire.  Under overload this sheds the
    lowest-value queued work instead of whichever request happened to
    arrive after the queue filled, so urgent traffic keeps its SLO while
    the queue bound (and therefore p99 TTFT) still holds.
    """

    name = "priority-deadline"

    def __init__(self, max_queue: int | None = None, *,
                 aging_s: float = 5.0):
        super().__init__(max_queue)
        if aging_s <= 0:
            raise ValueError(f"aging_s must be > 0, got {aging_s}")
        self.aging_s = float(aging_s)
        self._q: list = []

    def __len__(self) -> int:
        return len(self._q)

    # -- ordering -----------------------------------------------------------

    def key(self, handle, now: float) -> tuple:
        """The total-order sort key (smaller = admitted sooner)."""
        aged = handle.priority - int(max(0.0, now - handle.arrival_t)
                                     / self.aging_s)
        return (aged, handle.admit_deadline_t, handle.rid)

    def _best(self, now: float):
        return min(self._q, key=lambda h: self.key(h, now))

    # -- queue ops ----------------------------------------------------------

    def add(self, handle, now: float):
        if (self.max_queue is not None and len(self._q) >= self.max_queue
                and self._q):
            # Shed *expired* queued work first: past its admission
            # deadline the SLO is already lost, so dropping it cannot
            # cost goodput and the freed place admits a still-viable
            # newcomer.  (Without this, deadline ordering ranks the
            # nearly-dead first and displacement would evict the fresh.)
            expired = [h for h in self._q if h.admit_deadline_t < now]
            pool = expired or self._q
            worst = max(pool, key=lambda h: self.key(h, now))
            if expired or self.key(handle, now) < self.key(worst, now):
                self._q.remove(worst)
                self._q.append(handle)
                return worst  # displaced: the engine sheds it
        self._shed_check(len(self._q), now)
        self._q.append(handle)
        return None

    def requeue(self, handle, now: float) -> None:
        self._q.append(handle)

    def peek(self, now: float):
        return self._best(now) if self._q else None

    def pop(self, now: float):
        if not self._q:
            return None
        h = self._best(now)
        self._q.remove(h)
        self._note_pop(now)
        return h

    def remove(self, handle) -> bool:
        try:
            self._q.remove(handle)
            return True
        except ValueError:
            return False

    # -- preemption ---------------------------------------------------------

    @staticmethod
    def over_budget(handle, now: float) -> bool:
        return handle.deadline_t is not None and now > handle.deadline_t

    def victims(self, residents: list, now: float) -> list:
        if not self._q:
            return []
        queued = sorted(self._q, key=lambda h: self.key(h, now))
        cands = [r for r in residents if self.over_budget(r, now)]
        # worst-ranked victims lose their slot first
        cands.sort(key=lambda h: self.key(h, now), reverse=True)
        out, qi = [], 0
        for r in cands:
            if qi < len(queued) and self.key(queued[qi], now) < self.key(r, now):
                out.append(r)
                qi += 1
        return out


#: CLI name -> factory; one registry so serve.py, the benchmark and
#: ``python -m repro_torch.deploy.serving`` present identical choices.
POLICIES = {
    FIFO.name: FIFO,
    PriorityDeadline.name: PriorityDeadline,
}


def make_scheduler(name: str, *, max_queue: int | None = None,
                   aging_s: float | None = None) -> Scheduler:
    """Build a policy by registry name (shared CLI surface)."""
    try:
        cls = POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {name!r}; choices: {', '.join(POLICIES)}"
        ) from None
    if cls is PriorityDeadline and aging_s is not None:
        return cls(max_queue, aging_s=aging_s)
    return cls(max_queue)


def effective_deadline(arrival_t: float, ttft_slo_ms: float | None,
                       deadline_ms: float | None) -> float:
    """Absolute admission deadline: the earlier of the TTFT SLO and the
    completion budget; ``+inf`` when the request carries neither."""
    out = math.inf
    if ttft_slo_ms is not None:
        out = min(out, arrival_t + ttft_slo_ms / 1e3)
    if deadline_ms is not None:
        out = min(out, arrival_t + deadline_ms / 1e3)
    return out
