"""Percent of a chunk dispatch's lanes that carried a chunk."""

from bench.harness import program_counters


def read(run):
    return program_counters.chunk_lane_use(run)
