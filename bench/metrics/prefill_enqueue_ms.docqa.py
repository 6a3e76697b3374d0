"""ms of a chunk dispatch's enqueue: the session call, entry to return."""

from bench.harness import program_counters


def read(run):
    return program_counters.enqueue_ms(run, "prefill")
