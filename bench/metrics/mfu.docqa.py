"""Percent of the 1979 TOP/s int8 peak: the model's products over the window."""

from bench.harness import readers


def read(run):
    return readers.mfu(run)
