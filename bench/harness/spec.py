"""Finds a cell's configuration, traffic mix and metrics by the names in
``BENCHMARK.json``.

A configuration is the JSON file that ``BENCHMARK.json`` names for it, a
traffic mix is ``bench/traffic/<traffic>.json`` and a per-layer metric is
``bench/metrics/<metric>.py`` with a ``read(run)`` function: a later change
adds any of them as new files and entries, and edits none that is here.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """A metric with ``workloads`` is the listed cells'; one without is every
    cell's that reports the end-to-end metric it ``moves`` (or every cell's,
    for an end-to-end metric)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_cell(name: str, root: Path = ROOT) -> dict:
    """Everything one run of the cell ``name`` needs, as plain data."""
    bench = load_benchmark(root)
    cell = _by_name(bench["workloads"], name, "workload")
    cfg_entry = _by_name(bench["configs"], cell["config"], "config")
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(root / "bench" / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": e2e, "per_layer": per_layer}


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(run)`` function of ``bench/metrics/<name>.py``."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
