"""Readers of the program's own counters in ``EngineStats`` over the window:
the engine's host phases (``host_s``), each dispatch's enqueue
(``prefill_enqueue_s`` / ``decode_enqueue_s``), the lanes the chunk
dispatches carried (``prefill_lanes``) and the queue wait
(``queue_wait_s``).  A program that lacks a counter returns None, and the
metric is left out of the result line.
"""

from __future__ import annotations

from bench.harness.traffic import nearest_rank


def engine_host_ms(run):
    """ms of the engine's host phases (``engine/*``) per engine step."""
    st = run.stats
    host = getattr(st, "host_s", None)
    steps = len(st.step_times_s) if st is not None else 0
    if host is None or not steps:
        return None
    return 1e3 * sum(s for name, s in host.items() if name.startswith("engine/")) / steps


def enqueue_ms(run, kind: str):
    """ms from the session call's entry to its return, per ``kind``
    (``prefill`` / ``decode``) dispatch."""
    st = run.stats
    seconds = getattr(st, f"{kind}_enqueue_s", None)
    n = getattr(st, f"{kind}_dispatches", 0)
    return 1e3 * seconds / n if seconds is not None and n else None


def chunk_lane_use(run):
    """Percent of the chunk dispatches' lanes that carried a chunk."""
    st = run.stats
    lanes = getattr(st, "prefill_lanes", None)
    n = getattr(st, "prefill_dispatches", 0)
    return 100.0 * lanes / (n * st.max_batch) if lanes is not None and n else None


def queue_wait_ms(run, pct: float):
    """Nearest-rank percentile of submit -> first admission, in ms."""
    waits = getattr(run.stats, "queue_wait_s", None)
    return 1e3 * nearest_rank(waits, pct) if waits else None
