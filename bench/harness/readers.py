"""What the per-layer metrics in ``bench/metrics/`` read from a run.

A reader that finds nothing to read returns None, and the metric is left
out of the result line: a roofline is never reported as 0.
"""

from __future__ import annotations

from bench.harness import counts


def roofline(run, kernel: str):
    """Percent of the roofline bound: the least time the traced calls of
    ``kernel`` could take, over the device time its launches took.  None
    where the kernel did not run or ran another number of times than the
    calls counted from the shapes."""
    tr = run.trace
    if tr is None:
        return None
    calls = tr.calls.get(kernel, [])
    launches, seconds = tr.kernel_time(kernel)
    if not calls or launches != len(calls) or seconds <= 0:
        return None
    return 100.0 * sum(counts.bound_s(o, b) for o, b in calls) / seconds


def mfu(run):
    """Percent of the int8 peak: the model's products over the window."""
    if run.window_s <= 0 or run.model_ops <= 0:
        return None
    return 100.0 * run.model_ops / run.window_s / counts.PEAK_INT8_OPS


def device_idle(run):
    """Percent of the traced sub-window in which no operation ran on the device."""
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def engine_ms(run, time_field: str, count_field: str):
    """Milliseconds of one dispatch, from ``EngineStats`` over the window."""
    st = run.stats
    n = getattr(st, count_field, 0) if st is not None else 0
    return 1e3 * getattr(st, time_field) / n if n else None
