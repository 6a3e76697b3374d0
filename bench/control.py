"""Readings that set the limits of ``correct``: the program's numbers over
many seeds, and the control's, at the cell's own size.

    python3 bench/control.py --workload <name> --seconds 10 --seeds <n> ... [--control-seeds <n> ...]

For each seed it builds the cell, runs a window at the cell's own load
(a closed loop after its warm-up, as ``run.py`` does),
frees the program and compares the window's answers with the reference,
as ``run.py`` does (the lower reading).  For each control seed it also
puts the reference computed at int4, the precision below the configured
int8, in the program's place on the same answers and prints the same
number for it (the upper reading).  One JSON line a seed.  Run on a CUDA
card.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

from run import _environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    _environment()
    import torch

    from bench.harness.cells import EngineCell
    from bench.harness.check import check, control
    from bench.harness.spec import load_cell

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    spec = load_cell(args.workload)
    config, mix = spec["config"], spec["traffic"]
    dev = torch.device("cuda", 0)
    for seed in list(dict.fromkeys(args.seeds + args.control_seeds)):
        cell = EngineCell(config, mix, seed, dev)
        run = cell.window(args.seconds, False)
        cell.close()
        del cell
        gc.collect()
        torch.cuda.empty_cache()
        line = {"seed": seed, "e2e": run.e2e,
                "program": {n: v for n, v, _ in check(config, mix, run, seed)}}
        if seed in args.control_seeds:
            line["control"] = control(config, mix, run, seed)
        print(json.dumps(line), flush=True)
        del run
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
