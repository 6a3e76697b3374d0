"""The generator and the window's accounting: seeds, the shuffled
quantiles, due times, late answers and the window's edge."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch
from conftest import SEED

from bench.harness import traffic as T
from bench.harness.cells import EngineCell

OPEN = {"loop": "open", "rate_per_s": 5.0, "prompt_len": [512, 1536],
        "max_new_tokens": [1, 1]}
CLOSED = {"loop": "closed", "prompt_len": [1024, 1984], "max_new_tokens": [8, 32]}


def test_a_seed_gives_the_same_schedule_twice():
    a, b = T.requests_due(OPEN, 1000, SEED, 60.0), T.requests_due(OPEN, 1000, SEED, 60.0)
    assert [r["due_s"] for r in a] == [r["due_s"] for r in b]
    assert all(np.array_equal(x["prompt"], y["prompt"]) for x, y in zip(a, b))


def test_seeds_offer_the_same_work_in_another_order():
    n = 64
    a, b = (T.requests(CLOSED, 1000, s, n) for s in (SEED, SEED + 1))
    la, lb = [len(r["prompt"]) for r in a], [len(r["prompt"]) for r in b]
    assert sorted(la) == sorted(lb) and la != lb
    assert sorted(r["max_new_tokens"] for r in a) == sorted(r["max_new_tokens"] for r in b)
    assert min(la) >= 1024 and max(la) <= 1984
    ga, gb = (np.diff([0.0] + [r["due_s"] for r in T.requests_due(OPEN, 10, s, 60.0)])
              for s in (SEED, SEED + 1))
    assert np.allclose(np.sort(ga), np.sort(gb)) and not np.allclose(ga, gb)


def test_an_open_window_has_every_request_its_rate_offers():
    for seed in (SEED, SEED + 1, 7):
        reqs = T.requests_due(OPEN, 10, seed, 60.0)
        assert len(reqs) == 300 and reqs[-1]["due_s"] < 60.0
    gaps = np.diff([0.0] + [r["due_s"] for r in reqs])
    # the whole exponential: gaps well past the mean, and bursts of short ones
    assert gaps.max() > 5.0 / OPEN["rate_per_s"] and gaps.min() < 0.01 / OPEN["rate_per_s"]


def test_nearest_rank():
    assert T.nearest_rank(list(range(1, 101)), 95) == 95.0
    assert T.nearest_rank([3.0], 95) == 3.0
    assert T.nearest_rank([], 95) == 0.0


class _FakeEngine:
    """Answers the oldest queued request at each step (or never), after
    ``step_s`` seconds; stamps each handle with the time it answered."""

    def __init__(self, step_s: float, answers: bool):
        self.step_s, self.answers = step_s, answers
        self.queue, self.handles = [], []

    def reset_stats(self):
        pass

    def submit(self, prompt, max_new, on_token=None):
        h = SimpleNamespace(done=False, finish_reason=None, tokens=[], on_token=on_token,
                            answered=None, rid=len(self.handles))
        self.queue.append(h)
        self.handles.append(h)
        return h

    @property
    def idle(self):
        return not self.queue

    @property
    def queue_depth(self):
        return len(self.queue)

    def step(self):
        time.sleep(self.step_s)
        if self.answers and self.queue:
            h = self.queue.pop(0)
            h.answered = time.perf_counter()
            h.tokens.append(0)
            h.on_token(0)
            h.done, h.finish_reason = True, "length"

    def stats_snapshot(self):
        return SimpleNamespace(prompt_tokens_prefilled=0, tokens_generated=0, step_times_s=[])


def _open_cell(engine) -> EngineCell:
    cell = object.__new__(EngineCell)
    cell.config = {"arch": {}, "slots": 1, "compile": {"seq_len": 1}}
    cell.mix = dict(OPEN, rate_per_s=20.0, check_requests=1)
    cell.seed, cell.dev, cell.vocab, cell.qp = SEED, torch.device("cpu"), 50, None
    cell.engine = engine
    cell.disp = SimpleNamespace(reset=lambda: None, ops=0, chunks=0, decodes=0)
    cell.served = SimpleNamespace(of=lambda rid, n: None)
    cell.setup_phases = {}
    return cell


def test_ttft_is_timed_from_the_due_time():
    eng = _FakeEngine(0.03, answers=True)
    cell = _open_cell(eng)
    run = cell.window(1.0, False)
    reqs = T.requests_due(cell.mix, 50, SEED, 1.0)
    t_end = run.t0 + 1.0
    expect = [min(h.answered or t_end, t_end) - (run.t0 + r["due_s"])
              for h, r in zip(eng.handles, reqs) if r["due_s"] < 1.0]
    assert len(run.answers["waits_s"]) == len(expect) > 5
    assert any(h.answered and h.answered < t_end for h in eng.handles)
    # the answer's time less the due time, not less the (later) submission
    assert np.allclose(run.answers["waits_s"], expect, atol=1e-3)
    assert run.extra["generator_late_ms"]["max"] > 0.0


def test_an_unanswered_request_counts_with_its_wait_so_far():
    cell = _open_cell(_FakeEngine(0.05, answers=False))
    run = cell.window(0.8, False)
    reqs = T.requests_due(cell.mix, 50, SEED, 0.8)
    expect = [0.8 - r["due_s"] for r in reqs if r["due_s"] < 0.8]
    assert len(run.answers["waits_s"]) == len(expect) > 3
    assert np.allclose(run.answers["waits_s"], expect, atol=1e-9)
    assert np.isclose(run.e2e["ttft_p95_ms"], 1e3 * T.nearest_rank(expect, 95))


def test_the_window_counts_only_work_done_inside_it():
    """A closed loop: the tokens of steps begun inside the window, over the
    time to the end of the last of them; requests finished in the warm-up
    are not the window's."""
    eng = _FakeEngine(0.3, answers=True)
    cell = _open_cell(eng)
    cell.mix = dict(CLOSED, outstanding=2, requests_drawn=64, warm_finished=1,
                    check_requests=1)
    done = []

    def stats():  # one token a finished request, counted from the window's open
        return SimpleNamespace(prompt_tokens_prefilled=0,
                               tokens_generated=sum(1 for h in eng.handles if h.done) - done[0],
                               step_times_s=[])

    reset = eng.reset_stats
    eng.reset_stats = lambda: (done.append(sum(1 for h in eng.handles if h.done)), reset())
    eng.stats_snapshot = stats
    run = cell.window(1.0, False)
    # steps end 0.3, 0.6, 0.9 and 1.2 s after the open: the fourth began inside
    assert done == [1] and run.attempted == 5
    assert np.isclose(run.window_s, 1.2, atol=0.05)
    assert np.isclose(run.e2e["tok_per_s"], 4 / run.window_s)
