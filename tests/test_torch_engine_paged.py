"""The port's Engine over a paged, prefix-shared KV pool, against the JAX package's.

The engine halves of the reference's ``tests/test_paged.py``
(``TestEnginePagedBitExact``, ``test_chunk_dispatch_count`` and the engine
cases of ``TestPoolExhaustion``) and ``tests/test_prefix.py``
(``TestEnginePrefixBitExact``): the port's ``Engine`` (on the CPU) and the
reference's run the same schedule on the same ints, and the per-request
streams, finish reasons, the scheduler's and the prefix cache's counters
and the pool's free blocks are compared with ``==``.  Where the prefix
cache is on, ``audit_sharing()`` is clean after every step.  The sharing
audit itself (rules KV006 and KV007) is held against the reference's on
the same states.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config, reduced
from repro.deploy import api as j_api
from repro.deploy import verify as j_verify
from repro.deploy.engine import Engine as JEngine
from repro.models import transformer as JT
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import from_jax_quantized
from repro_torch.deploy import api as t_api
from repro_torch.deploy import verify as t_verify
from repro_torch.deploy.engine import Engine, RequestStatus

SEQ = 8
MAX_LEN = 40
BLOCK = 4

#: counters both engines must agree on after one schedule
COUNTERS = ("requests_submitted", "requests_completed", "requests_evicted",
            "slots_recycled", "prefill_dispatches", "decode_dispatches",
            "tokens_generated", "prompt_tokens_forced", "prompt_tokens_prefilled",
            "slot_steps_busy", "peak_queue_depth", "prefix_lookups", "prefix_hits",
            "prefix_hit_blocks", "full_prefix_hits", "blocks_shared", "cow_copies",
            "prefix_reclaimed_blocks")


@pytest.fixture(scope="module")
def olmo():
    cfg, tcfg = reduced(get_config("olmo-1b")), t_reduced(t_get_config("olmo-1b"))
    params = JT.init_params(cfg, jax.random.PRNGKey(7))
    qp = JT.quantize_params(cfg, params)
    return cfg, tcfg, params, from_jax_quantized(jax.tree.map(np.asarray, qp))


def _engines(olmo, max_batch, backend="w8a8", *, kv_blocks=14, prefix_cache=False,
             max_len=MAX_LEN):
    cfg, tcfg, params, tqp = olmo
    opts = dict(backend=backend, seq_len=SEQ, max_len=max_len, kv_block_size=BLOCK,
                kv_blocks=kv_blocks, prefix_cache=prefix_cache, use_cache=False)
    jm, tm = j_api.compile(cfg, verify=False, **opts), t_api.compile(tcfg, **opts)
    assert tm.fingerprint == jm.fingerprint
    return (JEngine(jm, max_batch, params=params),
            Engine(tm, max_batch, qp=tqp, device="cpu"))


def _tokens(cfg, n, seed=0):
    return [int(t) for t in np.random.default_rng(seed).integers(0, cfg.vocab, n)]


def _run_both(jeng, teng, schedule, *, audit=False):
    """``schedule(engine, step) -> handles`` on both engines; ``step`` runs
    one engine step (and, with ``audit``, the sharing audit after it).
    Streams, reasons, statuses, counters and free blocks must agree."""
    def stepper(engine):
        def step():
            worked = engine.step()
            if audit:
                assert engine.audit_sharing() == []
            return worked
        return step

    jh, th = schedule(jeng, stepper(jeng)), schedule(teng, stepper(teng))
    assert [(h.tokens, h.finish_reason, h.status.value) for h in th] == \
        [(h.tokens, h.finish_reason, h.status.value) for h in jh]
    for name in COUNTERS:
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    assert teng.session.blocks_free == jeng.session.blocks_free
    return th


def _drain(step, engine, max_steps):
    for _ in range(max_steps):
        if engine.idle:
            return
        assert step(), "no progress with work pending"
    raise AssertionError(f"not idle after {max_steps} steps")


class TestEnginePagedBitExact:
    @pytest.mark.parametrize("backend,n,gens", [
        ("w8a8", 5, (2, 4, 1, 3)),
        ("ita", 3, (2, 1, 2)),
    ], ids=["w8a8", "ita"])
    def test_scheduled_streams_match_reference(self, olmo, backend, n, gens):
        """Staggered submits, long chunked prompts and recycling: every
        stream equals the reference engine's."""
        cfg = olmo[0]
        jeng, teng = _engines(olmo, 2, backend)
        lengths = (SEQ, 2 * SEQ + 3, SEQ + 2)
        prompts = [_tokens(cfg, lengths[i % 3], seed=20 + i) for i in range(n)]
        budgets = [gens[i % len(gens)] for i in range(n)]

        def schedule(engine, step):
            handles = [engine.submit(prompts[i], budgets[i]) for i in range(n // 2)]
            step()
            handles += [engine.submit(prompts[i], budgets[i]) for i in range(n // 2, n)]
            _drain(step, engine, 500)
            return handles

        handles = _run_both(jeng, teng, schedule)
        assert all(h.status is RequestStatus.DONE for h in handles)
        assert teng.stats.prompt_tokens_forced == 0  # chunks, not forcing

    @pytest.mark.parametrize("long_len", [4 * SEQ, 2 * SEQ + 3])
    def test_chunk_dispatch_count(self, olmo, long_len):
        """<= ceil(len / seq_len) prefill dispatches, no teacher forcing,
        and the overlapping pinned-tail chunk counted once."""
        cfg = olmo[0]
        jeng, teng = _engines(olmo, 2)
        prompt = _tokens(cfg, long_len, seed=3)

        def schedule(engine, step):
            h = engine.submit(prompt, 2)
            _drain(step, engine, 100)
            return [h]

        [h] = _run_both(jeng, teng, schedule)
        assert h.finish_reason == "length"
        assert teng.stats.prefill_dispatches <= -(-long_len // SEQ)
        assert teng.stats.prompt_tokens_forced == 0
        assert teng.stats.prompt_tokens_prefilled == long_len


class TestPoolExhaustion:
    def test_engine_evicts_overflowing_and_survivors_advance(self, olmo):
        cfg = olmo[0]
        jeng, teng = _engines(olmo, 2, kv_blocks=5)
        prompts = [_tokens(cfg, SEQ, seed=30 + i) for i in range(2)]

        def schedule(engine, step):
            handles = [engine.submit(p, 12) for p in prompts]
            _drain(step, engine, 200)
            return handles

        handles = _run_both(jeng, teng, schedule)
        assert all(h.status is RequestStatus.DONE for h in handles)
        assert "kv_capacity" in {h.finish_reason for h in handles}
        assert max(len(h.tokens) for h in handles) >= 1

    def test_admission_waits_for_pool_capacity(self, olmo):
        """A queued long prompt is not admitted into blocks it cannot
        have; it waits for completions instead of dying mid-chunk."""
        cfg = olmo[0]
        jeng, teng = _engines(olmo, 2, kv_blocks=10)
        long_p = _tokens(cfg, 4 * SEQ, seed=40)
        busy = []

        def schedule(engine, step):
            hs = [engine.submit(long_p, 2) for _ in range(3)]
            step()
            busy.append(engine.slots_busy)
            _drain(step, engine, 500)
            return hs

        handles = _run_both(jeng, teng, schedule)
        assert busy[0] == busy[1] < 3  # 8 blocks pledged for the first
        assert [h.finish_reason for h in handles] == ["length"] * 3
        assert teng.stats.slots_recycled >= 1

    def test_submit_rejects_prompt_bigger_than_pool(self, olmo):
        jeng, teng = _engines(olmo, 1, kv_blocks=5)
        with pytest.raises(ValueError, match="kv_blocks") as want:
            jeng.submit([1] * (4 * SEQ), 2)  # needs 8 blocks, the pool has 5
        with pytest.raises(t_api.KVCapacityError, match="kv_blocks") as got:
            teng.submit([1] * (4 * SEQ), 2)
        assert str(got.value) == str(want.value) and got.value.reason == "pool"
        assert teng.idle and teng.stats.requests_submitted == 0


class TestEnginePrefixBitExact:
    @pytest.mark.parametrize("backend", ["w8a8", "ita"])
    def test_shared_prompt_trajectories_bit_exact(self, olmo, backend):
        """Re-submissions of a shared prompt: the repeat is a zero-prefill
        full hit, the extended prompt a partial hit that prefills only its
        suffix; every stream and counter equals the reference engine's,
        and the sharing audit is clean after every step."""
        cfg = olmo[0]
        jeng, teng = _engines(olmo, 2, backend, kv_blocks=30, prefix_cache=True)
        base = _tokens(cfg, 2 * SEQ + 2, seed=21)  # 18 rows: 4 blocks + tail
        longer = base + _tokens(cfg, 6, seed=22)

        def schedule(engine, step):
            h0 = engine.submit(base, 3)
            _drain(step, engine, 200)
            h1 = engine.submit(base, 3)
            h2 = engine.submit(longer, 2)
            _drain(step, engine, 200)
            return [h0, h1, h2]

        handles = _run_both(jeng, teng, schedule, audit=True)
        assert all(h.status is RequestStatus.DONE for h in handles)
        assert handles[1].tokens == handles[0].tokens
        s = teng.stats
        assert (s.prefix_lookups, s.prefix_hits, s.full_prefix_hits) == (3, 2, 1)
        assert s.prefix_hit_blocks >= 5 + 4 and s.cow_copies >= 1
        assert s.prefix_hit_rate() == pytest.approx(2 / 3)
        assert s.audit_findings == 0

    def test_concurrent_identical_prompts_defer_then_hit(self, olmo):
        """All-at-once identical submissions: the head prefills once,
        admission defers the rest until the prefix lands, and they admit
        as zero-prefill full hits."""
        cfg = olmo[0]
        jeng, teng = _engines(olmo, 2, kv_blocks=30, prefix_cache=True)
        prompt = _tokens(cfg, 4 * SEQ, seed=31)

        def schedule(engine, step):
            handles = [engine.submit(prompt, 2) for _ in range(3)]
            _drain(step, engine, 300)
            return handles

        handles = _run_both(jeng, teng, schedule, audit=True)
        assert len({tuple(h.tokens) for h in handles}) == 1
        assert teng.stats.full_prefix_hits == 2
        assert teng.stats.prompt_tokens_prefilled == 4 * SEQ

    def test_eviction_under_pressure_never_corrupts_siblings(self, olmo):
        """Undersized pool + shared prefixes: some requests finish with
        kv_capacity, and every token any request emits is the reference
        engine's, with the audit clean at every step."""
        cfg = olmo[0]
        jeng, teng = _engines(olmo, 2, kv_blocks=9, prefix_cache=True)
        base = _tokens(cfg, 2 * SEQ, seed=41)
        prompts = [base + _tokens(cfg, 4, seed=s) for s in (42, 43, 44)]
        budgets = [2, 6, 6]

        def schedule(engine, step):
            handles = [engine.submit(p, n) for p, n in zip(prompts, budgets)]
            _drain(step, engine, 400)
            return handles

        handles = _run_both(jeng, teng, schedule, audit=True)
        assert {h.finish_reason for h in handles} <= {"length", "kv_capacity"}
        assert handles[0].finish_reason == "length"

    def test_cancel_resident_sharer_keeps_siblings_exact(self, olmo):
        """A request attached to a shared prefix is cancelled while
        resident: its blocks lose one reference, the siblings' streams and
        the pool's counts stay the reference engine's."""
        cfg = olmo[0]
        jeng, teng = _engines(olmo, 3, kv_blocks=30, prefix_cache=True)
        base = _tokens(cfg, 2 * SEQ + 1, seed=51)
        prompts = [base, base + _tokens(cfg, 3, seed=52), base + _tokens(cfg, 5, seed=53)]

        def schedule(engine, step):
            handles = []

            def cancel_on_2nd(tok):
                if len(handles[1].tokens) == 2:
                    handles[1].cancel()

            handles.append(engine.submit(prompts[0], 4))
            _drain(step, engine, 100)
            handles.append(engine.submit(prompts[1], 5, on_token=cancel_on_2nd))
            handles.append(engine.submit(prompts[2], 5))
            _drain(step, engine, 200)
            return handles

        handles = _run_both(jeng, teng, schedule, audit=True)
        assert [h.finish_reason for h in handles] == ["length", "cancelled", "length"]
        assert len(handles[1].tokens) == 2 and teng.stats.prefix_hits == 2

    def test_engine_without_prefix_cache_has_no_index(self, olmo):
        cfg = olmo[0]
        jeng, teng = _engines(olmo, 1, kv_blocks=30)
        assert teng.prefix_index is None
        prompt = _tokens(cfg, SEQ, seed=51)

        def schedule(engine, step):
            h = engine.submit(prompt, 2)
            _drain(step, engine, 100)
            return [h]

        [h] = _run_both(jeng, teng, schedule, audit=True)
        assert h.status is RequestStatus.DONE and teng.stats.prefix_lookups == 0

    def test_audit_sharing_needs_a_paged_engine(self, olmo):
        cfg, tcfg = olmo[:2]
        model = t_api.compile(tcfg, seq_len=SEQ, max_len=MAX_LEN, use_cache=False)
        engine = Engine(model, 1, qp=olmo[3], device="cpu")
        with pytest.raises(RuntimeError, match="paged"):
            engine.audit_sharing()

    def test_audit_sharing_counts_and_raises_findings(self, olmo, monkeypatch):
        """A corrupted snapshot (a refcount leak) raises
        PlanVerificationError naming KV006 and counts its findings."""
        cfg = olmo[0]
        _, teng = _engines(olmo, 1, kv_blocks=30, prefix_cache=True)
        teng.submit(_tokens(cfg, SEQ + 2, seed=61), 2)
        teng.run_until_idle(max_steps=50)
        real = teng.session.sharing_state

        def leaky(index_blocks=()):
            st = real(index_blocks)
            b = next(iter(st.refcounts))
            return dataclasses.replace(st, refcounts={**st.refcounts, b: st.refcounts[b] + 1})

        monkeypatch.setattr(teng.session, "sharing_state", leaky)
        with pytest.raises(t_verify.PlanVerificationError, match="KV006") as ei:
            teng.audit_sharing()
        assert teng.stats.audit_findings == len(ei.value.diagnostics) == 1
        assert ei.value.diagnostics[0].source == "audit"


#: sharing states and the rule each breaks (the reference's TestSharingAudit)
STATES = [
    (dict(n_blocks=8, refcounts={1: 2, 2: 2, 3: 1}, tables={0: (1, 2, 3)},
          index_blocks=(1, 2)), None),
    (dict(n_blocks=8, refcounts={}, tables={0: (3,)}), "KV006"),
    (dict(n_blocks=8, refcounts={1: 1}, tables={0: (1,)}, index_blocks=(0,)), "KV006"),
    (dict(n_blocks=8, refcounts={1: 1}, tables={0: (1, 9)}), "KV006"),
    (dict(n_blocks=8, refcounts={1: 2}, tables={0: (1,)}), "KV006"),
    (dict(n_blocks=8, refcounts={1: 1}, tables={0: (1,), 1: (1,)}), "KV006"),
    (dict(n_blocks=8, refcounts={1: 1, 2: 1}, tables={0: (1,), 1: (2,)},
          writes=((0, 2, False),)), "KV007"),
    (dict(n_blocks=8, refcounts={1: 2}, tables={0: (1,), 1: (1,)},
          writes=((0, 1, False),)), "KV007"),
    (dict(n_blocks=8, refcounts={1: 2}, tables={0: (1,), 1: (1,)},
          writes=((0, 1, True),)), "KV007"),
    (dict(n_blocks=8, refcounts={1: 2, 4: 1}, tables={0: (4,), 1: (1,)}, index_blocks=(1,),
          writes=((0, 4, True),)), None),
]


@pytest.mark.parametrize("state,rule", STATES, ids=[
    "clean", "dead-block", "scratch-ref", "out-of-range", "refcount-leak",
    "refcount-underflow", "foreign-write", "shared-write-no-cow", "cow-still-shared",
    "cowed-exclusive-write"])
def test_sharing_audit_equals_reference(state, rule):
    """The same state in both packages: the same diagnostics, and
    ``check_sharing`` raises (or passes) alike."""
    def build(mod):
        kw = dict(state, writes=tuple(mod.KVWrite(*w) for w in state.get("writes", ())))
        return mod.KVSharingState(**kw)

    want = j_verify.verify_sharing(build(j_verify))
    got = t_verify.verify_sharing(build(t_verify))
    assert [dataclasses.asdict(d) for d in got] == [dataclasses.asdict(d) for d in want]
    assert [d.format() for d in got] == [d.format() for d in want]
    if rule is None:
        assert got == [] and t_verify.check_sharing(build(t_verify), strict=True) == []
        return
    assert got and all(d.rule == rule and d.severity == "error" for d in got)
    with pytest.raises(t_verify.PlanVerificationError) as ei:
        t_verify.check_sharing(build(t_verify), context="mutation")
    with pytest.raises(j_verify.PlanVerificationError) as ej:
        j_verify.check_sharing(build(j_verify), context="mutation")
    assert str(ei.value) == str(ej.value) and rule in str(ei.value)
