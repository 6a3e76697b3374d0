"""The knee of an open-loop cell: the same set-up, then one window at each
offered rate, the engine drained between them.

    python3 bench/sweep.py --workload olmo-1b-score --seed <n> --seconds 30 --rates 4 6 8

For each rate it prints one JSON line: the TTFT median and 95th percentile
(from the due time; a request with no token by the close counts with its
wait so far), requests due and answered inside the window, the queue at
the close and how late the generator ran.  The knee is the highest rate
whose queue does not grow through the window.  Run on a CUDA card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import _environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from bench.harness.cells import EngineCell
    from bench.harness.spec import load_cell

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    spec = load_cell(args.workload)
    cell = EngineCell(spec["config"], spec["traffic"], args.seed, torch.device("cuda", 0))
    print(json.dumps({"setup_s": time.perf_counter() - T_START}), flush=True)
    for rate in args.rates:
        mix = dict(spec["traffic"], rate_per_s=rate)
        run = cell.window(args.seconds, False, mix)
        print(json.dumps({"rate_per_s": rate, "ttft_p95_ms": run.e2e["ttft_p95_ms"],
                          "due": run.attempted, "failed": run.failed, **run.extra}), flush=True)
        cell.drain()
    return 0


if __name__ == "__main__":
    sys.exit(main())
