"""The port's async serving layer against the JAX package's.

Cases of the reference's ``tests/test_serving.py`` on reduced OLMo-1B:

* the admission policies (``FIFO``, ``PriorityDeadline``) under a fake
  clock, and the port's and the reference's schedulers driven through the
  same random sequence of operations, which must pop the same order,
  shed and displace the same requests and name the same victims;
* ``AsyncEngine`` streams equal to the reference's synchronous engine on
  the same ints (``w8a8`` and ``ita``, dense and paged), a preempted and
  requeued request included (sync and async);
* the async lifecycle (idle wait, timeouts, close with and without drain,
  cancels from other threads, concurrent producers, a loop that dies);
* the session's thread affinity, the latency statistics, the stdlib HTTP
  frontend on port 0 and ``python -m repro_torch.deploy.serving``;
* the sanitizer switch: with ``REPRO_SANITIZE`` set the port never runs
  unsanitized (tracked locks, a tracked condition and a shadow block pool).
"""

import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.error
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config, reduced
from repro.deploy import api as j_api
from repro.deploy.engine import Engine as JEngine
from repro.deploy.serving import scheduler as j_sched
from repro.models import transformer as JT
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import from_jax_quantized
from repro_torch.deploy import api as t_api
from repro_torch.deploy import sanitize
from repro_torch.deploy.engine import Engine, Greedy, Temperature
from repro_torch.deploy.serving import scheduler as t_sched
from repro_torch.deploy.serving.async_engine import AsyncEngine
from repro_torch.deploy.serving.frontend import ServingFrontend
from repro_torch.deploy.serving.scheduler import (
    FIFO,
    PriorityDeadline,
    QueueFullError,
    effective_deadline,
    make_scheduler,
)
from repro_torch.launch.cli import http_generate, http_get_json, synthesize_prompts

ROOT = Path(__file__).resolve().parents[1]
SEQ = 8
MAX_LEN = 24


@pytest.fixture(scope="module")
def olmo():
    cfg, tcfg = reduced(get_config("olmo-1b")), t_reduced(t_get_config("olmo-1b"))
    params = JT.init_params(cfg, jax.random.PRNGKey(7))
    qp = JT.quantize_params(cfg, params)
    return cfg, tcfg, params, from_jax_quantized(jax.tree.map(np.asarray, qp))


def _opts(backend="w8a8", *, paged=False, max_len=MAX_LEN, kv_blocks=14):
    kw = dict(kv_block_size=4, kv_blocks=kv_blocks) if paged else {}
    return dict(backend=backend, seq_len=SEQ, max_len=max_len, use_cache=False, **kw)


def _compile(olmo, backend="w8a8", **kw):
    return t_api.compile(olmo[1], **_opts(backend, **kw))


def _reference(olmo, backend="w8a8", max_batch=2, **kw):
    return JEngine(j_api.compile(olmo[0], verify=False, **_opts(backend, **kw)), max_batch,
                   params=olmo[2])


@pytest.fixture(scope="module")
def dense_model(olmo):
    return _compile(olmo)


def _prompts(cfg, n, *, lengths=(SEQ, SEQ + 2), seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, cfg.vocab, lengths[i % len(lengths)])]
            for i in range(n)]


def _sync_streams(engine, prompts, gens):
    handles = [engine.submit(p, g) for p, g in zip(prompts, gens)]
    engine.run_until_idle(max_steps=300)
    return [(h.tokens, h.finish_reason) for h in handles]


class _FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _mk(rid, *, priority=0, ttft=None, deadline=None, arrival=0.0, mod=t_sched):
    """Bare handle stand-in for scheduler unit tests (no engine)."""

    class H:
        pass

    h = H()
    h.rid, h.priority, h.ttft_slo_ms, h.deadline_ms, h.arrival_t = (
        rid, priority, ttft, deadline, arrival)
    h.deadline_t = None if deadline is None else arrival + deadline / 1e3
    h.admit_deadline_t = mod.effective_deadline(arrival, ttft, deadline)
    return h


# ---------------------------------------------------------------------------
# scheduler policies
# ---------------------------------------------------------------------------


def _policy_trace(mod, policy: str, max_queue, seed: int, n_ops: int = 160) -> list:
    """A random sequence of scheduler operations on one package's policy,
    each operation's observable outcome recorded."""
    rng = np.random.default_rng(seed)
    sched = mod.make_scheduler(policy, max_queue=max_queue, aging_s=0.5)
    now, rid, resident, trace = 0.0, 0, [], []

    def rids(hs):
        return [h.rid for h in hs]

    for _ in range(n_ops):
        op = rng.choice(["add", "add", "pop", "peek", "remove", "requeue", "victims", "tick"])
        if op == "add":
            h = _mk(rid, priority=int(rng.integers(0, 6)),
                    ttft=None if rng.random() < 0.3 else float(rng.integers(10, 2000)),
                    deadline=None if rng.random() < 0.4 else float(rng.integers(50, 3000)),
                    arrival=now, mod=mod)
            rid += 1
            try:
                shed = sched.add(h, now)
                trace.append(("add", h.rid, None if shed is None else shed.rid))
            except mod.QueueFullError as e:
                trace.append(("full", h.rid, e.queue_depth, e.max_queue, e.retry_after_s))
        elif op == "pop":
            h = sched.pop(now)
            trace.append(("pop", None if h is None else h.rid))
            if h is not None:
                resident.append(h)
        elif op == "peek":
            h = sched.peek(now)
            trace.append(("peek", None if h is None else h.rid))
        elif op == "remove" and len(sched):
            h = sched.peek(now)
            trace.append(("remove", h.rid, sched.remove(h), sched.remove(h)))
        elif op == "requeue" and resident:
            h = resident.pop(int(rng.integers(0, len(resident))))
            sched.requeue(h, now)
            trace.append(("requeue", h.rid))
        elif op == "victims":
            v = sched.victims(resident, now)
            trace.append(("victims", rids(v)))
            for h in v:
                resident.remove(h)
                sched.requeue(h, now)
        else:
            now += float(rng.uniform(0.0, 1.5))
        trace.append(("len", len(sched), sched.snapshot()))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("policy,max_queue", [
    ("fifo", None), ("fifo", 4), ("priority-deadline", None), ("priority-deadline", 4),
], ids=["fifo", "fifo-bounded", "priority-deadline", "priority-deadline-bounded"])
def test_scheduler_equals_reference_under_fake_clock(policy, max_queue, seed):
    got = _policy_trace(t_sched, policy, max_queue, seed)
    assert got == _policy_trace(j_sched, policy, max_queue, seed)
    assert any(e[0] == "pop" and e[1] is not None for e in got)


class TestSchedulerPolicies:
    def test_fifo_orders_by_submission_and_default_unbounded(self):
        s = FIFO()
        for h in [_mk(i) for i in range(50)]:
            s.add(h, 0.0)
        assert [s.pop(0.0).rid for _ in range(50)] == list(range(50))
        assert s.pop(0.0) is None and s.peek(0.0) is None

    def test_bounded_queue_sheds_with_structured_error(self):
        s = FIFO(max_queue=2)
        s.add(_mk(0), 0.0)
        s.add(_mk(1), 0.1)
        with pytest.raises(QueueFullError) as ei:
            s.add(_mk(2), 0.2)
        assert ei.value.queue_depth == 2 and ei.value.max_queue == 2
        assert ei.value.retry_after_s > 0
        s.requeue(_mk(3), 0.3)  # requeues are not shed
        assert len(s) == 3

    def test_displacement_sheds_worst_queued_for_outranking_arrival(self):
        s = PriorityDeadline(max_queue=2, aging_s=1e9)
        bg = [_mk(0, priority=5, ttft=900.0), _mk(1, priority=5, ttft=100.0)]
        assert s.add(bg[0], 0.0) is None and s.add(bg[1], 0.0) is None
        assert s.add(_mk(2, priority=0, ttft=50.0), 0.0) is bg[0]
        assert [s.pop(0.0).rid for _ in range(2)] == [2, 1]
        s2 = PriorityDeadline(max_queue=1, aging_s=1e9)
        s2.add(_mk(0, priority=0, ttft=50.0), 0.0)
        with pytest.raises(QueueFullError):
            s2.add(_mk(1, priority=5), 0.0)
        s3 = PriorityDeadline(max_queue=2, aging_s=1e9)
        doomed = _mk(0, priority=0, ttft=50.0)
        s3.add(doomed, 0.0)
        s3.add(_mk(1, priority=5, ttft=5000.0), 0.0)
        assert s3.add(_mk(2, priority=9), 1.0) is doomed  # expired work goes first
        f = FIFO(max_queue=1)
        assert f.add(_mk(0), 0.0) is None
        with pytest.raises(QueueFullError):
            f.add(_mk(1, priority=-10, ttft=1.0), 0.0)

    def test_priority_deadline_arrival_and_aging(self):
        s = PriorityDeadline(aging_s=1e9)
        for h in (_mk(0, priority=5, ttft=900.0), _mk(1, priority=5, ttft=100.0),
                  _mk(2, priority=0, ttft=500.0)):
            s.add(h, 0.0)
        assert [s.pop(0.0).rid for _ in range(3)] == [2, 1, 0]
        s.add(_mk(4, priority=1), 0.0)
        s.add(_mk(3, priority=1), 0.0)
        assert [s.pop(0.0).rid for _ in range(2)] == [3, 4]
        aged = PriorityDeadline(aging_s=1.0)
        aged.add(_mk(0, priority=5, arrival=0.0), 0.0)
        aged.add(_mk(1, priority=0, arrival=9.0), 9.0)
        assert aged.pop(9.0).rid == 0

    def test_victims_only_over_budget_and_outranked(self):
        s = PriorityDeadline(aging_s=1e9)
        ok, over = _mk(0, priority=5), _mk(1, priority=5, deadline=100.0)
        assert s.victims([ok, over], 1.0) == []
        s.add(_mk(2, priority=0), 1.0)
        assert [h.rid for h in s.victims([ok, over], 1.0)] == [1]
        capped = PriorityDeadline(aging_s=1e9)
        capped.add(_mk(10, priority=0), 1.0)
        assert len(capped.victims([_mk(i, priority=5, deadline=100.0) for i in range(3)],
                                  1.0)) == 1

    def test_registry_validation_and_effective_deadline(self):
        assert isinstance(make_scheduler("fifo"), FIFO)
        pd = make_scheduler("priority-deadline", max_queue=4, aging_s=2.0)
        assert isinstance(pd, PriorityDeadline) and (pd.max_queue, pd.aging_s) == (4, 2.0)
        with pytest.raises(ValueError, match="unknown scheduler"):
            make_scheduler("lifo")
        with pytest.raises(ValueError, match="aging_s"):
            PriorityDeadline(aging_s=0.0)
        with pytest.raises(ValueError, match="max_queue"):
            FIFO(max_queue=-1)
        assert effective_deadline(1.0, None, None) == math.inf
        assert effective_deadline(1.0, 500.0, 200.0) == pytest.approx(1.2)

    def test_engine_finishes_displaced_handle_as_shed(self, olmo, dense_model):
        cfg = olmo[0]
        eng = Engine(dense_model, 1, qp=olmo[3], device="cpu",
                     scheduler=PriorityDeadline(max_queue=1))
        p = _prompts(cfg, 1)[0]
        bg = eng.submit(p, 2, priority=5)
        urgent = eng.submit(p, 2, priority=0, ttft_slo_ms=50.0)
        assert bg.done and bg.finish_reason == "shed"
        assert eng.stats.shed_requests == 1 and eng.stats.requests_evicted == 1
        eng.run_until_idle(max_steps=100)
        assert urgent.finish_reason == "length" and len(urgent.tokens) == 2

    def test_engine_rejects_used_scheduler_and_bad_slo(self, olmo, dense_model):
        s = FIFO()
        s.add(_mk(0), 0.0)
        with pytest.raises(ValueError, match="fresh"):
            Engine(dense_model, 1, qp=olmo[3], device="cpu", scheduler=s)
        eng = Engine(dense_model, 1, qp=olmo[3], device="cpu")
        with pytest.raises(ValueError, match="ttft_slo_ms"):
            eng.submit([1] * SEQ, 2, ttft_slo_ms=-1.0)
        with pytest.raises(ValueError, match="deadline_ms"):
            eng.submit([1] * SEQ, 2, deadline_ms=-5.0)


# ---------------------------------------------------------------------------
# async streams against the reference
# ---------------------------------------------------------------------------


class TestAsyncBitExact:
    @pytest.mark.parametrize("backend,paged", [
        ("w8a8", False), ("w8a8", True), ("ita", False), ("ita", True),
    ], ids=["w8a8-dense", "w8a8-paged", "ita-dense", "ita-paged"])
    def test_async_streams_match_reference_engine(self, olmo, backend, paged):
        """The loop thread changes *when* steps happen, never what they
        compute: the async streams equal the reference's sync engine."""
        cfg = olmo[0]
        n = 4 if backend == "w8a8" else 3
        prompts, gens = _prompts(cfg, n, seed=3), [3, 4, 2, 3][:n]
        want = _sync_streams(_reference(olmo, backend, paged=paged), prompts, gens)
        model = _compile(olmo, backend, paged=paged)
        with AsyncEngine(model, 2, qp=olmo[3], device="cpu") as eng:
            hs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
            streams = [[t for t in h] for h in hs]  # blocking iteration
            got = [(h.result(timeout=120).tokens, h.finish_reason) for h in hs]
        assert got == want
        assert streams == [t for t, _ in want]

    @pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
    def test_preempted_requeued_stream_is_bit_exact(self, olmo, paged):
        """A resident evicted back to the queue resumes with its prefix
        teacher-forced and its sampling index unchanged: greedy, the
        preempted stream equals the reference engine's under the same
        schedule and an uninterrupted run; with temperature sampling,
        an uninterrupted run of the port."""
        def preempted(make, sampling=None):
            clk = _FakeClock()
            eng = make(clock=clk, scheduler=PriorityDeadline(),
                       **({} if sampling is None else {"sampling": sampling}))
            h = eng.submit(list(range(10)), 8, priority=5, deadline_ms=100)
            for _ in range(6):
                eng.step()
            assert h.tokens, "setup: nothing generated before preemption"
            clk.t = 1.0  # blow h's completion budget
            hi = eng.submit(list(range(8)), 2, priority=0)
            eng.run_until_idle(max_steps=300)
            assert h.preemptions >= 1
            assert eng.stats.preemptions == eng.stats.requeues == h.preemptions
            assert hi.finish_reason == "length" and len(hi.tokens) == 2
            return h.tokens, h.finish_reason

        jm = j_api.compile(olmo[0], verify=False, **_opts(paged=paged))
        tm = _compile(olmo, paged=paged)

        def port(**kw):
            return Engine(tm, 1, qp=olmo[3], device="cpu", **kw)

        want = preempted(lambda **kw: JEngine(jm, 1, params=olmo[2], **kw))
        assert preempted(port) == want
        assert _sync_streams(port(), [list(range(10))], [8]) == [want]
        sampled = preempted(port, Temperature(0.8, 3))
        assert _sync_streams(port(sampling=Temperature(0.8, 3)), [list(range(10))],
                             [8]) == [sampled]

    def test_async_preemption_resumes_exactly(self, olmo, dense_model):
        """Preemption on the loop thread: the long request is preempted by
        an urgent one mid-stream and still streams the uninterrupted
        run's tokens, each once."""
        want = _sync_streams(Engine(dense_model, 1, qp=olmo[3], device="cpu"),
                             [list(range(10))], [12])
        clk = _FakeClock()
        seen = []
        with AsyncEngine(dense_model, 1, qp=olmo[3], device="cpu", clock=clk,
                         scheduler=PriorityDeadline()) as eng:
            h = eng.submit(list(range(10)), 12, priority=5, deadline_ms=100,
                           on_token=seen.append)
            it = iter(h)
            first = [next(it), next(it)]
            clk.t = 1.0
            hi = eng.submit(list(range(8)), 2, priority=0)
            rest = list(it)
            assert hi.result(timeout=120).finish_reason == "length"
        assert h.handle.preemptions >= 1
        assert [(first + rest, h.finish_reason)] == want
        assert seen == h.tokens

    def test_requeued_request_streams_each_token_once(self, olmo, dense_model):
        seen = []
        clk = _FakeClock()
        eng = Engine(dense_model, 1, qp=olmo[3], device="cpu", scheduler=PriorityDeadline(),
                     clock=clk)
        h = eng.submit(list(range(10)), 6, priority=5, deadline_ms=100, on_token=seen.append)
        for _ in range(5):
            eng.step()
        clk.t = 1.0
        eng.submit(list(range(8)), 1, priority=0)
        eng.run_until_idle(max_steps=200)
        assert h.preemptions >= 1 and seen == h.tokens


# ---------------------------------------------------------------------------
# async lifecycle
# ---------------------------------------------------------------------------


class TestAsyncLifecycle:
    def test_idle_engine_does_not_busy_spin(self, olmo, dense_model):
        with AsyncEngine(dense_model, 1, qp=olmo[3], device="cpu") as eng:
            eng.submit(_prompts(olmo[0], 1)[0], 2).result(timeout=120)
            steps = len(eng.stats.step_times_s)
            time.sleep(0.25)  # idle: the loop must be waiting, not stepping
            assert len(eng.stats.step_times_s) == steps

    def test_result_timeout_raises(self, olmo, dense_model):
        with AsyncEngine(dense_model, 1, qp=olmo[3], device="cpu") as eng:
            h = eng.submit(_prompts(olmo[0], 1)[0], 14)
            with pytest.raises(TimeoutError, match="not finished"):
                h.result(timeout=1e-4)
            assert h.result(timeout=120).finish_reason == "length"

    def test_submit_after_close_raises(self, olmo, dense_model):
        eng = AsyncEngine(dense_model, 1, qp=olmo[3], device="cpu")
        eng.close()
        with pytest.raises(RuntimeError, match="closed"):
            eng.submit(_prompts(olmo[0], 1)[0], 2)

    def test_close_without_drain_cancels_live_work(self, olmo, dense_model):
        eng = AsyncEngine(dense_model, 1, qp=olmo[3], device="cpu")
        hs = [eng.submit(p, 30) for p in _prompts(olmo[0], 3)]
        eng.close(drain=False, timeout=60)
        assert all(h.done for h in hs)
        assert any(h.finish_reason == "cancelled" for h in hs)

    def test_cancel_from_other_thread(self, olmo, dense_model):
        with AsyncEngine(dense_model, 1, qp=olmo[3], device="cpu") as eng:
            hs = [eng.submit(p, 10) for p in _prompts(olmo[0], 3)]
            hs[2].cancel()  # still queued behind hs[1]
            hs[0].cancel()  # possibly resident: routed to the loop thread
            assert hs[1].result(timeout=120).finish_reason == "length"
            for h in (hs[0], hs[2]):
                assert h.result(timeout=120).finish_reason == "cancelled"

    def test_threaded_producers_all_complete_or_shed(self, olmo, dense_model):
        """Producer threads hammer one bounded-queue engine: every
        submission completes with the reference engine's exact stream or
        is shed with QueueFullError, and the stats account for all."""
        prompts = _prompts(olmo[0], 4, seed=5)
        want = _sync_streams(_reference(olmo), prompts, [4] * 4)
        results, shed = {}, []
        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            with AsyncEngine(dense_model, 2, qp=olmo[3], device="cpu",
                             scheduler=FIFO(max_queue=6)) as eng:
                def producer(t):
                    for j in range(4):
                        try:
                            h = eng.submit(prompts[j], 4)
                        except QueueFullError:
                            shed.append((t, j))
                            continue
                        raw = h.result(timeout=120)
                        results[(t, j)] = (raw.tokens, raw.finish_reason)

                threads = [threading.Thread(target=producer, args=(t,)) for t in range(6)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=300)
                assert not any(th.is_alive() for th in threads)
                eng.drain(timeout=120)
                stats = eng.stats_snapshot()
        finally:
            sys.setswitchinterval(switch)
        assert len(results) + len(shed) == 24
        for (_, j), got in results.items():
            assert got == want[j]
        assert stats.requests_completed == stats.requests_submitted == len(results)
        assert stats.shed_requests == len(shed)

    def test_adopting_busy_engine_rejected(self, olmo, dense_model):
        sync = Engine(dense_model, 1, qp=olmo[3], device="cpu")
        sync.submit(_prompts(olmo[0], 1)[0], 2)
        with pytest.raises(ValueError, match="live work"):
            AsyncEngine(sync)

    def test_loop_failure_reaches_every_handle(self, olmo, dense_model):
        """A step that raises on the loop thread: the resident request
        finishes with reason "error", waiters re-raise the loop's
        exception instead of hanging, and submit refuses."""
        eng = AsyncEngine(dense_model, 1, qp=olmo[3], device="cpu")
        session = eng.engine.session
        calls = []

        def broken(*args, **kwargs):
            calls.append(threading.current_thread().name)
            raise RuntimeError("device lost")

        session.decode = broken
        hs = [eng.submit(p, 4) for p in _prompts(olmo[0], 2)]
        with pytest.raises(RuntimeError, match="device lost"):
            hs[1].result(timeout=60)
        with pytest.raises(RuntimeError, match="device lost"):
            list(hs[1])
        assert hs[0].result(timeout=60).finish_reason == "error"
        assert calls == ["repro-engine-loop"]
        with pytest.raises(RuntimeError, match="loop died"):
            eng.submit(_prompts(olmo[0], 1)[0], 2)
        with pytest.raises(RuntimeError, match="loop died"):
            eng.drain(timeout=10)
        eng.close(timeout=10)


class TestSessionThreadAffinity:
    def test_mutation_from_second_thread_rejected(self, olmo, dense_model):
        eng = Engine(dense_model, 1, qp=olmo[3], device="cpu")
        eng.submit(_prompts(olmo[0], 1)[0], 2)
        eng.run_until_idle(max_steps=100)  # binds the session to this thread
        errors = []

        def intruder():
            try:
                eng.session.free_slot(0)
            except RuntimeError as e:
                errors.append(str(e))

        t = threading.Thread(target=intruder)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        assert len(errors) == 1 and "rebind_thread" in errors[0]

    def test_rebind_transfers_ownership(self, olmo, dense_model):
        session = dense_model.session(1, qp=olmo[3], device="cpu")
        session.free_slot(0)  # binds here
        ok = []

        def new_owner():
            session.rebind_thread()
            session.free_slot(0)
            ok.append(True)

        t = threading.Thread(target=new_owner)
        t.start()
        t.join(timeout=60)
        assert ok == [True]

    def test_loop_thread_owns_the_session(self, olmo, dense_model):
        """Under AsyncEngine the caller's thread can no longer mutate the
        session: the loop thread took it over."""
        with AsyncEngine(dense_model, 1, qp=olmo[3], device="cpu") as eng:
            eng.submit(_prompts(olmo[0], 1)[0], 2).result(timeout=120)
            with pytest.raises(RuntimeError, match="rebind_thread"):
                eng.engine.session.free_slot(0)


class TestLatencyStats:
    def test_ttft_tpot_recorded_per_generated_token(self, olmo, dense_model):
        eng = Engine(dense_model, 2, qp=olmo[3], device="cpu")
        hs = [eng.submit(p, 3) for p in _prompts(olmo[0], 2)]
        eng.run_until_idle(max_steps=200)
        s = eng.stats
        assert len(s.ttft_s) == 2 and len(s.tpot_s) == sum(len(h.tokens) for h in hs) - 2
        assert all(t >= 0 for t in s.ttft_s + s.tpot_s) and s.ttft(50) <= s.ttft(99)
        assert all(h.ttft_s is not None and h.finish_t is not None for h in hs)

    def test_goodput_under_slo_with_fake_clock(self, olmo, dense_model):
        clk = _FakeClock()
        eng = Engine(dense_model, 1, qp=olmo[3], device="cpu", clock=clk)
        met = eng.submit([1] * SEQ, 2, ttft_slo_ms=1e6)
        missed = eng.submit([2] * SEQ, 2, ttft_slo_ms=1.0)
        while not eng.idle:
            clk.t += 0.050  # 50 ms per scheduler step
            eng.step()
        assert met.ttft_s <= 1e3 and missed.ttft_s > 1e-3
        assert eng.stats.goodput_under_slo() == pytest.approx(0.5)

    def test_summary_mentions_slo_and_preemption_counters(self, olmo, dense_model):
        eng = Engine(dense_model, 1, qp=olmo[3], device="cpu")
        eng.submit([1] * SEQ, 2)
        eng.run_until_idle(max_steps=100)
        s = eng.stats.summary()
        assert "ttft p50/p99" in s and "tpot p50/p99" in s
        eng.stats.preemptions = eng.stats.requeues = 2
        eng.stats.shed_requests = 1
        assert "2 preemptions / 2 requeues / 1 shed" in eng.stats.summary()


# ---------------------------------------------------------------------------
# the HTTP frontend
# ---------------------------------------------------------------------------


class TestFrontend:
    @pytest.fixture()
    def served(self, olmo, dense_model):
        eng = AsyncEngine(dense_model, 2, qp=olmo[3], device="cpu",
                          scheduler=PriorityDeadline(max_queue=32))
        fe = ServingFrontend(eng, port=0)
        host, port = fe.start()
        yield host, port, fe
        if fe._thread.is_alive():
            fe.shutdown(drain=False, timeout=60)

    def test_streaming_matches_final_summary_and_the_reference(self, olmo, served):
        host, port, _ = served
        prompt = _prompts(olmo[0], 1)[0]
        [(want, _)] = _sync_streams(_reference(olmo), [prompt], [4])
        events = list(http_generate(host, port, prompt, 4))
        toks = [e["token"] for e in events if "token" in e]
        final = events[-1]
        assert final["done"] and final["finish_reason"] == "length"
        assert final["tokens"] == toks == want
        assert [e["index"] for e in events if "token" in e] == [0, 1, 2, 3]

    def test_unary_status_stats_roundtrip(self, olmo, served):
        host, port, _ = served
        out = http_generate(host, port, _prompts(olmo[0], 1)[0], 3, stream=False,
                            priority=1, ttft_slo_ms=60_000.0)
        assert out["finish_reason"] == "length" and len(out["tokens"]) == 3
        st = http_get_json(host, port, f"/v1/status/{out['rid']}")
        assert st["status"] == "done" and st["tokens_generated"] == 3
        stats = http_get_json(host, port, "/v1/stats")
        assert stats["requests_completed"] >= 1
        assert stats["goodput_under_slo"] == pytest.approx(1.0)
        assert stats["scheduler"]["policy"] == "priority-deadline"
        assert stats["sanitize"] == {"enabled": False, "lockdep_findings": 0,
                                     "shadow_findings": 0, "audit_findings": 0}
        assert http_get_json(host, port, "/healthz")["status"] == "ok"

    def test_bad_request_is_structured_400_and_unknown_rid_404(self, olmo, served):
        host, port, _ = served
        with pytest.raises(urllib.error.HTTPError) as ei:
            http_generate(host, port, [], 3, stream=False)
        assert ei.value.code == 400
        body = json.loads(ei.value.read().decode())
        assert body["type"] == "ValueError" and "empty prompt" in body["error"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            http_get_json(host, port, "/v1/status/999999")
        assert ei.value.code == 404

    def test_shed_is_429_with_retry_after(self, olmo, dense_model):
        eng = AsyncEngine(dense_model, 1, qp=olmo[3], device="cpu",
                          scheduler=FIFO(max_queue=0))  # sheds everything
        fe = ServingFrontend(eng, port=0)
        host, port = fe.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                http_generate(host, port, _prompts(olmo[0], 1)[0], 2, stream=False)
            assert ei.value.code == 429 and int(ei.value.headers["Retry-After"]) >= 1
            body = json.loads(ei.value.read().decode())
            assert body["type"] == "QueueFullError" and body["max_queue"] == 0
            assert eng.stats.shed_requests == 1
        finally:
            fe.shutdown(drain=False, timeout=60)

    def test_graceful_drain_finishes_streams_then_refuses(self, olmo, dense_model):
        eng = AsyncEngine(dense_model, 2, qp=olmo[3], device="cpu")
        fe = ServingFrontend(eng, port=0)
        host, port = fe.start()
        h = eng.submit(_prompts(olmo[0], 1)[0], 6)
        fe.draining = True  # the first phase of shutdown()
        with pytest.raises(urllib.error.HTTPError) as ei:
            http_generate(host, port, _prompts(olmo[0], 1)[0], 2, stream=False)
        assert ei.value.code == 503
        assert http_get_json(host, port, "/healthz")["status"] == "draining"
        fe.shutdown(drain=True, timeout=120)  # the in-flight request finishes
        assert h.done and h.finish_reason == "length"
        with pytest.raises(urllib.error.URLError):
            http_get_json(host, port, "/healthz")  # listener gone


def test_serving_module_serves_over_http():
    """``python -m repro_torch.deploy.serving`` on the CPU at port 0: it
    prints its address, streams a generation and drains on SIGINT."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.deploy.serving", "--reduced", "--device",
         "cpu", "--no-plan-cache", "--port", "0", "--batch", "2", "--prompt-len", "8",
         "--backend", "ita"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        line = ""
        deadline = time.monotonic() + 120
        while "http://" not in line and time.monotonic() < deadline:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, "the server exited"
        assert "serving olmo-1b [ita] on cpu" in line, line
        host, port = line.split("http://")[1].split()[0].split(":")
        prompt = synthesize_prompts(512, n=1, prompt_len=8)[0]
        events = list(http_generate(host, int(port), prompt, 3))
        assert events[-1]["done"] and len(events[-1]["tokens"]) == 3
    finally:
        proc.send_signal(2)  # SIGINT: drain and exit
        try:
            proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0


# ---------------------------------------------------------------------------
# the sanitizer switch and the imports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value", ["1", "true", "on"])
def test_sanitize_switch_refuses_to_run_unsanitized(olmo, dense_model, monkeypatch, value):
    """The switch turns on lockdep-tracked locks, a tracked condition and,
    over a paged pool, the shadow block pool (a dense region has none)."""
    monkeypatch.setenv("REPRO_SANITIZE", value)
    assert sanitize.enabled() is True
    assert isinstance(sanitize.make_lock("engine.lock"), sanitize._TrackedLock)
    assert isinstance(sanitize.make_condition("serving.cv"), sanitize._TrackedCondition)
    dense = Engine(dense_model, 1, qp=olmo[3], device="cpu")
    assert isinstance(dense._lock, sanitize._TrackedLock) and dense._lock.reentrant
    assert dense.session.allocator is None
    paged = Engine(_compile(olmo, paged=True), 2, qp=olmo[3], device="cpu")
    shadow = paged.session.allocator.shadow
    assert isinstance(shadow, sanitize.ShadowPool) and shadow.n_blocks == 14
    paged.submit(_prompts(olmo[0], 1)[0], 2)
    paged.run_until_idle(max_steps=50)
    assert shadow.findings == [] and sanitize.runtime_findings() == ()


def test_sanitize_off_is_plain_threading(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    assert sanitize.enabled() is False and sanitize.runtime_findings() == ()
    lock = sanitize.make_lock("engine.lock", reentrant=True)
    assert not isinstance(lock, sanitize._TrackedLock)
    with lock, lock:  # reentrant
        sanitize.require_held(lock, "scheduler.FIFO")
    monkeypatch.delenv("REPRO_SANITIZE")
    assert sanitize.enabled() is False
    assert isinstance(sanitize.make_condition("serving.cv"), threading.Condition)


def test_cli_helpers(monkeypatch):
    import argparse

    from repro_torch.launch import cli

    ap = argparse.ArgumentParser()
    cli.add_engine_args(ap)
    cli.add_serving_args(ap)
    args = ap.parse_args(["--batch", "3", "--sampling", "temperature", "--sample-seed", "5",
                          "--scheduler", "priority-deadline", "--max-queue", "9"])
    assert cli.resolve_requests(args) == 6 and cli.resolve_requests(args, factor=3) == 9
    t = cli.make_sampling(args)
    assert isinstance(t, Temperature) and (t.temperature, t.seed) == (0.8, 5)
    s = cli.make_scheduler_from_args(args)
    assert isinstance(s, PriorityDeadline) and s.max_queue == 9
    assert isinstance(cli.make_sampling(ap.parse_args([])), Greedy)
    a = synthesize_prompts(100, n=5, prompt_len=4, extra=2, seed=1)
    assert [len(p) for p in a] == [4, 5, 6, 4, 5]
    assert a == synthesize_prompts(100, n=5, prompt_len=4, extra=2, seed=1)
    assert all(0 <= t < 100 for p in a for t in p)


def test_serving_modules_import_no_jax():
    code = (
        "import sys, json\n"
        "import repro_torch.deploy.engine, repro_torch.deploy.sanitize\n"
        "import repro_torch.deploy.serving.async_engine, repro_torch.deploy.serving.frontend\n"
        "import repro_torch.deploy.serving.__main__, repro_torch.launch.cli\n"
        "import repro_torch.launch.serve, repro_torch.deploy.verify\n"
        "from repro_torch.deploy.serving import AsyncEngine, ServingFrontend, FIFO\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print(json.dumps(bad))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout) == []


def test_http_repeat_tool_replays_a_run(tmp_path):
    """``ci/torch_engine_http_repeat.py`` on the CPU at reduced width: the
    HTTP streams equal the synchronous engine's, and the synchronous replay
    of the run's admissions gives the same dispatches and streams."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, str(ROOT / "ci" / "torch_engine_http_repeat.py"), "--device", "cpu",
         "--reduced", "--budget", "0", "--replay-first", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "run 0: 0 of 8 streams differ" in res.stdout, res.stdout
    assert "streams differing [], the same dispatches True" in res.stdout, res.stdout
    assert "http repeat on cpu: 1 runs, 0 differed" in res.stdout, res.stdout
    assert not list(tmp_path.iterdir())
