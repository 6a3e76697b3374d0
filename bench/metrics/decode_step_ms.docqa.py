"""ms of one batched decode dispatch (EngineStats over the window)."""

from bench.harness import readers


def read(run):
    return readers.engine_ms(run, "decode_time_s", "decode_dispatches")
