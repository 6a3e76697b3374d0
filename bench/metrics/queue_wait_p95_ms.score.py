"""Nearest-rank p95 of a request's queue wait (submit -> first admission), ms."""

from bench.harness import program_counters


def read(run):
    return program_counters.queue_wait_ms(run, 95)
