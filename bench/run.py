"""Runs one cell of the benchmark once and prints its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` measures the cell's end-to-end metrics over a window of
``--seconds``; ``--trace 1`` runs the same window and then profiles a few
units of steady work, and reports the cell's per-layer metrics.  Either
way the output of the window is checked against the plain reference once
the window has closed.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
``breakdown`` when traced, what the run reports beside them and is never
judged on, and last ``checks``: each number compared beside its limit,
which standard error's last lines repeat).

It measures the PyTorch port (``src/repro_torch``) on a CUDA card and
fails without one.  The kernels' build and the plan cache go to fixed
directories under ``build/bench/`` in the checkout, so only a checkout's
first run builds them.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench"
#: top-level modules that no run may load: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Fixed build and cache directories inside the checkout."""
    for var, sub in (("REPRO_TORCH_BUILD", "kernels"), ("REPRO_TORCH_PLAN_CACHE", "plans"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def per_layer(spec: dict, run) -> dict:
    from bench.harness.spec import metric_reader

    out = {}
    for m in spec["per_layer"]:
        v = metric_reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def end_to_end(spec: dict, run) -> dict:
    vals = dict(run.e2e, setup_s=run.setup_s)
    return {m["name"]: {"value": float(vals[m["name"]]), "unit": m["unit"]}
            for m in spec["end_to_end"]}


def measure(spec: dict, seed: int, seconds: float, trace: bool, dev, t_start: float):
    """One run of the cell and its check: (run, checks)."""
    import torch

    from bench.harness.cells import EngineCell
    from bench.harness.check import check

    config, mix = spec["config"], spec["traffic"]
    t_cell = time.perf_counter()
    cell = EngineCell(config, mix, seed, dev)
    run = cell.window(seconds, trace)
    run.setup_s = run.t0 - t_start
    run.extra["setup_phases_s"]["imports"] = t_cell - t_start
    cell.close()
    del cell
    gc.collect()  # the program's state goes before the reference runs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check(config, mix, run, seed)
    run.extra["check_s"] = time.perf_counter() - t_check
    return run, checks


def result(spec: dict, run, checks: list, trace: bool, dev) -> dict:
    import torch

    from bench.harness.check import passes

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": spec["cell"]["chips"], "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": all(passes(*c) for c in checks), "attempted": run.attempted,
           "failed": run.failed}
    if trace:
        device.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        out["metrics"] = per_layer(spec, run)
        out["breakdown"] = {"device_ops": run.trace.top_ops(10),
                            "idle_gaps": run.trace.idle_by_host}
    else:
        out["metrics"] = end_to_end(spec, run)
    out["device"] = device
    out.update(run.extra)
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from bench.harness.spec import load_cell

    spec = load_cell(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    run, checks = measure(spec, args.seed, args.seconds, bool(args.trace), dev, T_START)
    out = result(spec, run, checks, bool(args.trace), dev)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded forbidden modules: {', '.join(bad)}", file=sys.stderr)
        return 3
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
