"""Percent of the traced sub-window with no operation on the device."""

from bench.harness import readers


def read(run):
    return readers.device_idle(run)
