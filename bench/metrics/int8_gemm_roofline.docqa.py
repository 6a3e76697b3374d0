"""Percent of the int8_gemm calls' roofline bound, from the trace."""

from bench.harness import readers


def read(run):
    return readers.roofline(run, "int8_gemm")
