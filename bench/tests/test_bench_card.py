"""On the card: each cell's command, as the benchmark runs it, for a short
window (marked ``cuda``; it skips without a card)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import CELLS, ROOT, SEED


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", cell, "--seed",
                          str(SEED), "--seconds", "5", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
