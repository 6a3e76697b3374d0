"""ms of one batched prefill-chunk dispatch (EngineStats over the window)."""

from bench.harness import readers


def read(run):
    return readers.engine_ms(run, "prefill_time_s", "prefill_dispatches")
