"""A run with the timed path broken underneath comes out not correct: the
harness's whole run on the CPU (no look for a card), once for each fault
a cell can have.  One card, so no exchange between chips to leave out."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch
from conftest import SEED, small

from bench.harness.check import passes
from bench.run import measure


def _measure(cell: str):
    run, checks = measure(small(cell), SEED, 2.0, False, torch.device("cpu"),
                          time.perf_counter())
    assert run.attempted > 0
    return run, checks


def _correct(cell: str) -> bool:
    return all(passes(*c) for c in _measure(cell)[1])


@pytest.mark.parametrize("cell", ["olmo-1b-docqa", "olmo-1b-score"])
def test_engine_token_altered(monkeypatch, cell):
    from repro_torch.deploy.engine import Greedy

    def sample(self, logits_row, rid, index):
        row = logits_row[: self.vocab] if self.vocab else logits_row
        return int((np.argmax(row) + 1) % len(row))

    monkeypatch.setattr(Greedy, "__call__", sample)
    assert not _correct(cell)


@pytest.mark.parametrize("cell", ["olmo-1b-docqa", "olmo-1b-score"])
def test_engine_logits_altered_argmax_kept(monkeypatch, cell):
    """The head's scale doubled: every served token stays the argmax of its
    row, and only the logits themselves tell the fault."""
    from repro_torch.core.heterogeneous import DEFAULT_TABLE, Engine

    head = DEFAULT_TABLE.table["lmhead"][Engine.CLUSTER]
    monkeypatch.setitem(DEFAULT_TABLE.table["lmhead"], Engine.CLUSTER,
                        lambda h_q, w_q, *, scale, tied: head(h_q, w_q, scale=2 * scale,
                                                              tied=tied))
    run, checks = _measure(cell)
    by = {n: v for n, v, _ in checks}
    assert by["max_served_logit_gap"] == 0.0 and by["max_abs_logit_diff"] > 0.0
    assert not all(passes(*c) for c in checks)


@pytest.mark.parametrize("cell", ["olmo-1b-docqa", "olmo-1b-score"])
def test_engine_state_unchanged(monkeypatch, cell):
    """The paged KV write returns the pool as it was."""
    from repro_torch.core.heterogeneous import DEFAULT_TABLE, Engine

    monkeypatch.setitem(DEFAULT_TABLE.table["cache_write_paged"], Engine.CLUSTER,
                        lambda kv_m, pool, *a, **kw: pool)
    assert not _correct(cell)


@pytest.mark.parametrize("cell", ["olmo-1b-docqa", "olmo-1b-score"])
def test_engine_half_batch_left_out(monkeypatch, cell):
    """A chunk dispatch computes only the first half of its slots: the others'
    tokens never reach the model."""
    from repro_torch.deploy.api import InferenceSession

    chunks = InferenceSession.prefill_chunks

    def half(self, todo):
        todo = {s: ((t if s < self.batch_size // 2 else torch.zeros_like(torch.as_tensor(t))), st)
                for s, (t, st) in todo.items()}
        return chunks(self, todo)

    monkeypatch.setattr(InferenceSession, "prefill_chunks", half)
    assert not _correct(cell)
