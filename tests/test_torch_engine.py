"""The port's request-level Engine against the JAX package's, stream for stream.

Cases of the reference's ``tests/test_engine.py`` on reduced OLMo-1B (GQA,
RoPE, SwiGLU, tied embeddings), dense KV region.  The port's ``Engine``
(on the CPU) and the reference's ``Engine`` run the same schedule on the
same ints (the reference's quantized params, carried by
``repro_torch.convert``): per-request token streams, finish reasons and
the scheduler's counters are compared with ``==`` on ``w8a8`` and ``ita``,
with staggered submits, EOS, KV-capacity eviction and slot recycling.
``Temperature`` cannot equal the JAX package's bits (it seeds a torch
generator where the reference folds a ``jax.random`` key), so it is held
to its own contract: deterministic for a seed, independent of batch
order, admission order and ``max_batch``.
"""

import jax
import numpy as np
import pytest

from repro.configs import get_config, reduced
from repro.deploy import api as j_api
from repro.deploy.engine import Engine as JEngine
from repro.models import transformer as JT
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import from_jax_quantized
from repro_torch.deploy import api as t_api
from repro_torch.deploy import engine as engine_mod
from repro_torch.deploy.engine import (
    Engine,
    EngineStats,
    Greedy,
    RequestStatus,
    Temperature,
)
from repro_torch.deploy.serving.scheduler import PriorityDeadline

SEQ = 8
MAX_LEN = SEQ + 8

#: scheduler counters that both engines must agree on after one schedule
COUNTERS = ("requests_submitted", "requests_completed", "requests_evicted",
            "slots_recycled", "prefill_dispatches", "decode_dispatches",
            "tokens_generated", "prompt_tokens_forced", "prompt_tokens_prefilled",
            "slot_steps_busy", "peak_queue_depth")


@pytest.fixture(scope="module")
def olmo():
    """Reduced OLMo-1B in both packages, the reference's params and the
    port's copy of their quantized ints."""
    cfg, tcfg = reduced(get_config("olmo-1b")), t_reduced(t_get_config("olmo-1b"))
    params = JT.init_params(cfg, jax.random.PRNGKey(7))
    qp = JT.quantize_params(cfg, params)
    return cfg, tcfg, params, from_jax_quantized(jax.tree.map(np.asarray, qp))


def _models(olmo, backend="w8a8", max_len=MAX_LEN, **kw):
    cfg, tcfg = olmo[:2]
    opts = dict(backend=backend, seq_len=SEQ, max_len=max_len, use_cache=False, **kw)
    jm, tm = j_api.compile(cfg, verify=False, **opts), t_api.compile(tcfg, **opts)
    assert tm.fingerprint == jm.fingerprint
    return jm, tm


def _port(olmo, tm, max_batch, **kw):
    return Engine(tm, max_batch, qp=olmo[3], device="cpu", **kw)


def _engines(olmo, max_batch, backend="w8a8", max_len=MAX_LEN, **kw):
    """The reference's engine and the port's over the same ints."""
    jm, tm = _models(olmo, backend, max_len)
    return JEngine(jm, max_batch, params=olmo[2], **kw), _port(olmo, tm, max_batch, **kw)


def _prompts(cfg, n, *, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, cfg.vocab, lengths[i % len(lengths)])]
            for i in range(n)]


def _outcome(handles):
    return [(h.tokens, h.finish_reason, h.status.value) for h in handles]


def _same_run(jeng, teng, jhandles, thandles):
    """Streams, finish reasons, statuses and counters of both engines."""
    assert _outcome(thandles) == _outcome(jhandles)
    for name in COUNTERS:
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name


def _run_both(jeng, teng, schedule):
    """``schedule(engine) -> handles`` on both engines, then compare."""
    jh, th = schedule(jeng), schedule(teng)
    _same_run(jeng, teng, jh, th)
    return th


class TestSchedulerBitExact:
    @pytest.mark.parametrize("backend,n,max_batch,gens", [
        ("w8a8", 6, 2, (2, 4, 1, 3)),
        ("ita", 3, 2, (2, 1, 2)),
    ], ids=["w8a8", "ita"])
    def test_random_schedule_bit_exact(self, olmo, backend, n, max_batch, gens):
        """Staggered submits, mixed prompt lengths, mid-flight admissions,
        an EOS stop and recycled slots: every request's stream equals the
        reference engine's, token for token."""
        cfg = olmo[0]
        jeng, teng = _engines(olmo, max_batch, backend)
        prompts = _prompts(cfg, n, lengths=(SEQ, SEQ + 2, SEQ + 1), seed=3)
        budgets = [gens[i % len(gens)] for i in range(n)]
        # request 1 stops on EOS where its budget allows: its own 2nd
        # token (from a lone run)
        eos_ids = [None] * n
        if budgets[1] >= 2:
            lone = _port(olmo, teng.session.model, 1)
            probe = lone.submit(prompts[1], budgets[1])
            lone.run_until_idle(max_steps=50)
            eos_ids[1] = probe.tokens[1]

        def schedule(engine):
            handles = [engine.submit(prompts[i], budgets[i], eos_id=eos_ids[i])
                       for i in range(n // 2)]
            engine.step()
            engine.step()
            handles += [engine.submit(prompts[i], budgets[i], eos_id=eos_ids[i])
                        for i in range(n // 2, n)]
            engine.run_until_idle(max_steps=300)
            return handles

        handles = _run_both(jeng, teng, schedule)
        if eos_ids[1] is not None:
            assert handles[1].finish_reason == "eos" and len(handles[1].tokens) == 2
        assert all(h.status is RequestStatus.DONE for h in handles)
        assert teng.stats.tokens_generated == sum(len(h.tokens) for h in handles)
        if n > max_batch:
            assert teng.stats.slots_recycled >= 1
        assert teng.stats.prompt_tokens_forced >= 1  # the teacher-forced tails

    def test_eos_stops_early(self, olmo):
        cfg = olmo[0]
        jeng, teng = _engines(olmo, 1)
        [prompt] = _prompts(cfg, 1, lengths=(SEQ,), seed=5)
        free = _port(olmo, teng.session.model, 1)
        free_run = free.submit(prompt, 4)
        free.run_until_idle(max_steps=50)

        def schedule(engine):
            h = engine.submit(prompt, 4, eos_id=free_run.tokens[0])
            engine.run_until_idle(max_steps=50)
            return [h]

        [h] = _run_both(jeng, teng, schedule)
        assert h.finish_reason == "eos" and h.tokens == free_run.tokens[:1]


class TestKVCapacityEviction:
    def test_engine_evicts_precisely_and_recycles(self, olmo):
        """Requests overflowing the KV region finish with reason
        ``kv_capacity`` and the reference engine's exact prefix; the freed
        slots are recycled for the queue."""
        cfg = olmo[0]
        jeng, teng = _engines(olmo, 2, max_len=SEQ + 3)
        prompts = _prompts(cfg, 3, lengths=(SEQ, SEQ + 1), seed=9)

        def schedule(engine):
            handles = [engine.submit(p, 10) for p in prompts]
            engine.run_until_idle(max_steps=100)
            return handles

        handles = _run_both(jeng, teng, schedule)
        assert {h.finish_reason for h in handles} == {"kv_capacity"}
        assert teng.stats.slots_recycled >= 1

    def test_submit_rejects_impossible_prompts(self, olmo):
        jeng, teng = _engines(olmo, 1)
        for prompt, budget, match in (([1] * (SEQ - 1), 2, "seq_len"),
                                      ([1] * (MAX_LEN + 1), 2, "max_len"),
                                      ([1] * SEQ, 0, "max_new_tokens"),
                                      ([], 2, "empty prompt")):
            with pytest.raises(ValueError, match=match) as want:
                jeng.submit(prompt, budget)
            with pytest.raises(ValueError, match=match) as got:
                teng.submit(prompt, budget)
            assert str(got.value) == str(want.value)
        assert teng.stats.requests_submitted == 0 and teng.idle

    def test_submit_rejects_prompt_larger_than_paged_pool(self, olmo):
        """A prompt needing more KV blocks than the whole paged pool is
        refused at submit time with ``KVCapacityError(reason="pool")``."""
        _, tm = _models(olmo, max_len=40, kv_block_size=4, kv_blocks=4)
        engine = _port(olmo, tm, 1)
        with pytest.raises(t_api.KVCapacityError, match="pool holds") as ei:
            engine.submit([1] * 20, 2)  # needs 5 blocks; the pool has 4
        assert ei.value.reason == "pool"
        assert engine.stats.requests_submitted == 0 and engine.idle


class TestDeterminism:
    def test_greedy_across_batch_orderings(self, olmo):
        """The same request set, submitted in another order onto another
        slot count, gives the same per-request streams, and those are the
        reference engine's."""
        cfg = olmo[0]
        jm, tm = _models(olmo)
        prompts = _prompts(cfg, 4, lengths=(SEQ, SEQ + 1), seed=11)

        def run(engine, order):
            handles = {i: engine.submit(prompts[i], 3) for i in order}
            engine.run_until_idle(max_steps=200)
            return {i: h.tokens for i, h in handles.items()}

        a = run(_port(olmo, tm, 2), range(4))
        b = run(_port(olmo, tm, 3), reversed(range(4)))
        assert a == b
        assert a == run(JEngine(jm, 2, params=olmo[2]), range(4))

    def test_temperature_deterministic_and_order_free(self, olmo):
        """The draw depends on (seed, request id, token index) only: the
        same streams for any ``max_batch``, any admission order and any
        run; the engine binds ``vocab`` on its own copy of the policy."""
        cfg = olmo[0]
        _, tm = _models(olmo)
        shared = Temperature(0.8, 4)
        prompts = _prompts(cfg, 3, lengths=(SEQ,), seed=2)

        def run(max_batch, priorities=None):
            kw = {} if priorities is None else dict(scheduler=PriorityDeadline(aging_s=1e9))
            engine = _port(olmo, tm, max_batch, sampling=shared, **kw)
            assert engine.sampling.vocab == cfg.vocab and shared.vocab is None
            handles = [engine.submit(p, 3, priority=(priorities or [0] * 3)[i])
                       for i, p in enumerate(prompts)]
            engine.run_until_idle(max_steps=100)
            return [h.tokens for h in handles], [h.first_token_t for h in handles]

        a, _ = run(1)
        assert a == run(3)[0] == run(1)[0]
        # reversed admission order (same request ids): the same streams
        b, first = run(1, priorities=[2, 1, 0])
        assert first[2] < first[1] < first[0]
        assert b == a
        assert all(0 <= t < cfg.vocab for toks in a for t in toks)
        with pytest.raises(ValueError, match="temperature"):
            Temperature(0.0, 0)

    def test_temperature_draw_is_a_function_of_seed_rid_index(self):
        rng = np.random.default_rng(0)
        row = rng.standard_normal(300).astype(np.float32)
        t = Temperature(1.0, 7, vocab=256)
        draws = [t(row, rid, i) for rid in range(4) for i in range(8)]
        assert draws == [t(row, rid, i) for rid in range(4) for i in range(8)]
        assert all(0 <= d < 256 for d in draws) and len(set(draws)) > 1
        assert draws != [Temperature(1.0, 8, vocab=256)(row, rid, i)
                         for rid in range(4) for i in range(8)]
        # a vanishing temperature is greedy
        assert Temperature(1e-6, 7, vocab=256)(row, 3, 5) == Greedy(256)(row, 3, 5)

    def test_greedy_breaks_ties_to_the_first_index(self):
        row = np.asarray([0.5, 2.0, 2.0, -1.0, 3.0], np.float32)
        assert Greedy(vocab=4)(row, 0, 0) == 1  # the padding lane 4 is cut
        assert Greedy()(row, 0, 0) == 4
        assert Greedy(vocab=4)(row, 0, 0) == int(jax.numpy.argmax(row[:4]))


class TestLifecycle:
    def test_streaming_callback_sees_every_token_in_order(self, olmo):
        cfg = olmo[0]
        _, tm = _models(olmo)
        engine = _port(olmo, tm, 2)
        streams = {}
        handles = [engine.submit(p, 3, on_token=streams.setdefault(i, []).append)
                   for i, p in enumerate(_prompts(cfg, 3, lengths=(SEQ,), seed=6))]
        assert all(h.status is RequestStatus.QUEUED for h in handles)
        engine.run_until_idle(max_steps=100)
        for i, h in enumerate(handles):
            assert streams[i] == h.tokens and len(h.tokens) == 3

    def test_cancel_queued_and_resident(self, olmo):
        cfg = olmo[0]
        jeng, teng = _engines(olmo, 1)
        prompts = _prompts(cfg, 3, lengths=(SEQ,), seed=8)

        def schedule(engine):
            handles = [engine.submit(p, 4) for p in prompts]
            engine.step()  # request 0 resident, 1 and 2 queued
            # (either package's RequestStatus: compared by value)
            assert handles[0].status.value in ("prefilling", "decoding")
            handles[1].cancel()  # queued -> never scheduled
            assert handles[1].status.value == "evicted"
            handles[0].cancel()  # resident -> slot freed for request 2
            engine.run_until_idle(max_steps=100)
            handles[1].cancel()  # idempotent on finished handles
            return handles

        handles = _run_both(jeng, teng, schedule)
        assert [h.finish_reason for h in handles] == ["cancelled", "cancelled", "length"]
        assert handles[1].tokens == [] and len(handles[2].tokens) == 4
        assert (teng.stats.requests_evicted, teng.stats.requests_completed) == (2, 1)

    def test_cancel_from_streaming_callback(self, olmo):
        """A streaming callback may cancel requests mid-step — its own or a
        neighbour's — without crashing the consume loop."""
        cfg = olmo[0]
        jeng, teng = _engines(olmo, 2)
        prompts = _prompts(cfg, 2, lengths=(SEQ + 1,), seed=12)

        def schedule(engine):
            handles = []

            def cancel_both(tok):
                handles[1].cancel()  # neighbour slot, not yet consumed this step
                handles[0].cancel()  # the very request being consumed

            handles.append(engine.submit(prompts[0], 4, on_token=cancel_both))
            handles.append(engine.submit(prompts[1], 4))
            engine.run_until_idle(max_steps=50)
            return handles

        handles = _run_both(jeng, teng, schedule)
        assert [h.finish_reason for h in handles] == ["cancelled", "cancelled"]
        assert len(handles[0].tokens) == 1 and handles[1].tokens == []
        assert (teng.stats.requests_evicted, teng.stats.requests_completed) == (2, 0)

    def test_engine_guards(self, olmo):
        cfg, tcfg = olmo[:2]
        enc = t_api.compile(t_reduced(t_get_config("mobilebert")), use_cache=False)
        with pytest.raises(ValueError, match="decoder"):
            Engine(enc, 2, device="cpu")
        _, model = _models(olmo)
        with pytest.raises(ValueError, match="max_batch"):
            Engine(model, 0, device="cpu")
        session = model.session(2, qp=olmo[3], device="cpu")
        with pytest.raises(ValueError, match="batch_size"):
            Engine(session, 3)
        adopted = Engine(session)  # adopting a fresh session infers max_batch
        assert adopted.max_batch == 2 and adopted.session is session
        assert adopted.run_until_idle() is adopted.stats  # an idle engine no-ops
        for kw in (dict(qp=olmo[3]), dict(device="cpu"), dict(seed=1)):
            with pytest.raises(ValueError, match="bound weights"):
                Engine(session, **kw)
        used = model.session(2, qp=olmo[3], device="cpu")
        used.prefill(np.asarray(_prompts(cfg, 2, lengths=(SEQ,)), np.int32))
        with pytest.raises(ValueError, match="live KV state"):
            Engine(used)

    def test_engine_defaults_to_the_card(self, olmo, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        _, model = _models(olmo)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(model, 1, qp=olmo[3])

    def test_decode_hot_path_stays_on_host(self, olmo, monkeypatch):
        """Sampling sees host ``np.ndarray`` rows, the session's depths are
        numpy, and each dispatch makes exactly one device-to-host fetch —
        while the streams stay the reference engine's."""
        cfg = olmo[0]
        jeng, teng = _engines(olmo, 2)
        seen_types, fetches = [], []
        orig = teng.sampling

        class Spy:
            vocab = cfg.vocab

            def __call__(self, row, rid, index):
                seen_types.append(type(row))
                return orig(row, rid, index)

        teng.sampling = Spy()
        host_rows = engine_mod._host_rows

        def counted(logits):
            fetches.append(tuple(logits.shape))
            return host_rows(logits)

        monkeypatch.setattr(engine_mod, "_host_rows", counted)
        prompts = _prompts(cfg, 3, lengths=(SEQ, SEQ + 2), seed=21)

        def schedule(engine):
            handles = [engine.submit(p, 3) for p in prompts]
            engine.run_until_idle(max_steps=100)
            return handles

        _run_both(jeng, teng, schedule)
        assert seen_types and all(t is np.ndarray for t in seen_types)
        assert isinstance(teng.session.pos, np.ndarray)
        s = teng.stats
        assert len(fetches) == s.prefill_dispatches + s.decode_dispatches

    def test_stats_split_prompt_vs_generated_throughput(self, olmo):
        cfg = olmo[0]
        _, tm = _models(olmo)
        engine = _port(olmo, tm, 2)
        handles = [engine.submit(p, 2) for p in _prompts(cfg, 2, lengths=(SEQ + 3,), seed=22)]
        engine.run_until_idle(max_steps=100)
        s = engine.stats
        assert all(h.status is RequestStatus.DONE for h in handles)
        assert s.prompt_tokens_forced == 2 * 3  # the tails
        assert s.prompt_tokens_prefilled == 2 * SEQ  # the static prefills
        total = s.prefill_time_s + s.decode_time_s
        assert s.tokens_per_s() == pytest.approx(s.tokens_generated / total)
        assert s.prompt_tokens_per_s() == pytest.approx(
            (s.prompt_tokens_prefilled + s.prompt_tokens_forced) / total)
        assert "gen tok/s" in s.summary() and "prompt tok/s" in s.summary()

    def test_failed_dispatch_time_is_accounted(self, olmo, monkeypatch):
        """The dispatch that dies on KVCapacityError still costs wall time."""
        import time as time_mod

        cfg = olmo[0]
        _, tm = _models(olmo, max_len=SEQ + 2)
        engine = _port(olmo, tm, 1)
        orig_decode = engine.session.decode
        calls = {"n": 0}

        def slow_decode(tokens, pos=None, **kw):
            calls["n"] += 1
            time_mod.sleep(0.01)  # make the failed dispatch's cost visible
            return orig_decode(tokens, pos, **kw)

        monkeypatch.setattr(engine.session, "decode", slow_decode)
        h = engine.submit(_prompts(cfg, 1, lengths=(SEQ,), seed=23)[0], 10)
        engine.run_until_idle(max_steps=100)
        assert h.finish_reason == "kv_capacity"
        assert engine.stats.decode_time_s >= 0.01 * calls["n"]

    def test_stats_record_shape(self, olmo):
        cfg = olmo[0]
        _, tm = _models(olmo)
        engine = _port(olmo, tm, 2)
        handles = [engine.submit(p, 2) for p in _prompts(cfg, 4, lengths=(SEQ,), seed=10)]
        stats = engine.run_until_idle(max_steps=100)
        assert stats.requests_completed == 4 and stats.peak_queue_depth >= 2
        assert stats.queue_depth == 0 and stats.slots_busy == 0
        assert 0.0 < stats.occupancy() <= 1.0 and stats.tokens_per_s() > 0
        assert stats.tokens_generated == sum(len(h.tokens) for h in handles)
        assert isinstance(Greedy()(np.zeros(4, np.float32), 0, 0), int)
        assert "slot occupancy" in stats.summary()
        # reset_stats clears the counters AND the slot-reuse bookkeeping
        fresh = engine.reset_stats()
        assert fresh is engine.stats and fresh.requests_completed == 0
        h = engine.submit(_prompts(cfg, 1, lengths=(SEQ,), seed=13)[0], 1)
        engine.run_until_idle(max_steps=20)
        assert h.status is RequestStatus.DONE and engine.stats.slots_recycled == 0


class TestStepLatencyStats:
    def test_percentile_accounting(self):
        """Nearest-rank percentiles over recorded step wall times."""
        s = EngineStats(max_batch=2)
        assert s.step_latency_p50() == 0.0 and s.step_latency_p99() == 0.0
        s.step_times_s.append(0.25)
        assert s.step_latency_p50() == 0.25 and s.step_latency_p99() == 0.25
        s.step_times_s[:] = [i / 1000.0 for i in range(100, 0, -1)]
        assert s.step_latency_p50() == pytest.approx(0.050)
        assert s.step_latency_p99() == pytest.approx(0.099)
        assert s.step_latency_s(100.0) == pytest.approx(0.100)
        s.ttft_s[:] = [0.3, 0.1, 0.2]
        s.tpot_s[:] = [0.02] * 99 + [0.5]
        assert (s.ttft(50), s.ttft(99)) == (0.2, 0.3)
        assert (s.tpot(50), s.tpot(99), s.tpot(100)) == (0.02, 0.02, 0.5)
        s.dispatches_per_step = 7
        assert "7 dispatches/step" in s.summary()

    def test_engine_records_steps_and_dispatches(self, olmo):
        cfg = olmo[0]
        _, tm = _models(olmo)
        engine = _port(olmo, tm, 2)
        assert engine.stats.dispatches_per_step == engine.session.decode_dispatch_count
        engine.submit(_prompts(cfg, 1, lengths=(SEQ,), seed=3)[0], 2)
        engine.run_until_idle(max_steps=50)
        assert len(engine.stats.step_times_s) > 0
        assert engine.stats.step_latency_p99() >= engine.stats.step_latency_p50() > 0
        fresh = engine.reset_stats()
        assert fresh.step_times_s == []
        assert fresh.dispatches_per_step == engine.session.decode_dispatch_count
