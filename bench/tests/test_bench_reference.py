"""The plain references hold the program's window bit for bit, and their
int4 control, put in the program's place, fails the same check."""

from __future__ import annotations

import time

import pytest
import torch
from conftest import CELLS, SEED, small

from bench.harness.check import control, passes
from bench.run import measure


@pytest.fixture(scope="module", params=CELLS)
def measured(request):
    spec = small(request.param)
    run, checks = measure(spec, SEED, 2.0, False, torch.device("cpu"), time.perf_counter())
    return spec, run, checks


def test_window_matches_reference(measured):
    _, run, checks = measured
    assert run.attempted > 0 and run.failed == 0
    assert all(passes(*c) for c in checks), checks
    by = {n: v for n, v, _ in checks}
    # integer-exact: no difference at all, in the logits or the tokens
    assert by["max_abs_logit_diff"] == 0.0 and by["max_served_logit_gap"] == 0.0


def test_control_is_not_correct(measured):
    spec, run, checks = measured
    reading = control(spec["config"], spec["traffic"], run, SEED)
    limits = {n: lim for n, _, lim in checks}
    assert not any(passes(n, v, limits[n]) for n, v in reading.items()), reading
