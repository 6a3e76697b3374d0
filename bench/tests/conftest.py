"""The benchmark's tests run on the CPU at small sizes (run them with
``python -m pytest bench/tests``); those that need a card are marked
``cuda`` and skip without one."""

from __future__ import annotations

import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

SEED = (1 << 31) + 11  # a seed past 32 signed bits, as checks draw them


@pytest.fixture(scope="session", autouse=True)
def _plan_cache(tmp_path_factory):
    os.environ["REPRO_TORCH_PLAN_CACHE"] = str(tmp_path_factory.mktemp("plans"))


def small(cell: str) -> dict:
    """The cell as the benchmark loads it, at a size the CPU runs in seconds:
    widths cut, depth 2, the traffic scaled to them; the shapes' rules
    kept (prompts of several chunks whose attention walks more than one
    block of keys)."""
    from bench.harness.spec import load_cell

    spec = load_cell(cell)
    arch = spec["config"]["arch"]
    arch.update(n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64, d_ff=256,
                vocab=512)
    mix = spec["traffic"]
    spec["config"]["compile"].update(seq_len=128, max_len=1024, kv_block_size=16,
                                     kv_blocks=256)
    spec["config"]["slots"] = 4
    if mix["loop"] == "closed":
        mix.update(outstanding=8, prompt_len=[300, 700], max_new_tokens=[2, 6],
                   warm_finished=2)
    else:
        mix.update(rate_per_s=12.0, prompt_len=[200, 500])
    mix["check_requests"] = 100  # every finished request
    return spec


CELLS = ("olmo-1b-docqa", "olmo-1b-score")
