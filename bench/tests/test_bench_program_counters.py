"""The readers of the program's own counters: each returns a number in its
small cell, and nothing where the program lacks the counter, as an older
program does."""

from __future__ import annotations

import json
import time
import types

import pytest
import torch
from conftest import ROOT, SEED, small

from bench.harness.spec import metric_reader
from bench.run import measure, per_layer

NEW = {"olmo-1b-docqa": ("engine_host_ms.docqa", "prefill_enqueue_ms.docqa",
                         "decode_enqueue_ms.docqa", "chunk_lane_use.docqa"),
       "olmo-1b-score": ("engine_host_ms.score", "prefill_enqueue_ms.score",
                         "chunk_lane_use.score", "queue_wait_p95_ms.score")}


@pytest.fixture(scope="module", params=sorted(NEW))
def traced(request):
    spec = small(request.param)
    run, _ = measure(spec, SEED, 2.0, True, torch.device("cpu"), time.perf_counter())
    return request.param, spec, run


def test_each_new_reader_reads_a_number(traced):
    cell, spec, run = traced
    line = per_layer(spec, run)
    for name in NEW[cell]:
        assert isinstance(line[name]["value"], float) and line[name]["value"] >= 0.0, name
    lanes = line[f"chunk_lane_use.{cell.split('-')[-1]}"]["value"]
    assert 0.0 < lanes <= 100.0
    assert not any(n.startswith(("engine/", "session/", "executor/"))
                   for n, _ in run.trace.top_ops(100))


def test_every_new_metric_is_listed_for_its_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"]: m["workloads"] for m in bench["per_layer"]}
    for cell, names in NEW.items():
        for name in names:
            assert listed[name] == [cell]


@pytest.mark.parametrize("name", sorted(n for names in NEW.values() for n in names))
def test_a_program_without_the_counter_reads_nothing(name):
    from repro_torch.deploy.engine import EngineStats

    old = EngineStats(max_batch=16, prefill_dispatches=3, decode_dispatches=5)
    old.step_times_s = [1.0, 1.0]
    stats = types.SimpleNamespace(**{k: v for k, v in vars(old).items()
                                     if k not in ("host_s", "host_calls", "queue_wait_s",
                                                  "prefill_lanes", "prefill_enqueue_s",
                                                  "decode_enqueue_s")})
    assert metric_reader(name)(types.SimpleNamespace(stats=stats)) is None
