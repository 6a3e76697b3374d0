"""ms of the engine's host phases outside the dispatches, per engine step."""

from bench.harness import program_counters


def read(run):
    return program_counters.engine_host_ms(run)
