"""The engine's, the session's and the executor's spans and counters
(``repro_torch.deploy.spans``), on a reduced OLMo on the CPU.

Always on: the engine's host phases by name (self time) and calls, each
dispatch split into its enqueue and its fetch, the lanes the chunk
dispatches carried and the queue wait, in ``EngineStats``.  Only while the
switch is on: ``torch.profiler`` marks, one ``executor/<kind>`` a plan node
inside its dispatch's ``engine/…`` span, which names the lanes' request
ids.  ``serve --profile`` reads them.
"""

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config, reduced
from repro_torch.deploy import api, spans
from repro_torch.deploy.engine import Engine, EngineStats
from repro_torch.launch import serve

SEQ, MAX_LEN, BLOCK = 8, 40, 4
PHASES = ("engine/preempt", "engine/admit", "engine/prefix_match", "engine/chunk_build",
          "engine/prefix_insert", "engine/sample", "engine/finish")


@pytest.fixture(scope="module")
def models():
    cfg = reduced(get_config("olmo-1b"))
    opts = dict(backend="w8a8", seq_len=SEQ, max_len=MAX_LEN, use_cache=False)
    return {"paged": api.compile(cfg, kv_block_size=BLOCK, kv_blocks=40, prefix_cache=True,
                                 **opts),
            "dense": api.compile(cfg, **opts)}


def _engine(models, kind="paged", max_batch=3, **kw):
    return Engine(models[kind], max_batch, device="cpu", **kw)


def _prompts(engine, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, engine.cfg.vocab, n).tolist() for n in lengths]


def _serve(engine, lengths=(8, 17, 23, 8, 30), gen=3):
    handles = [engine.submit(p, gen) for p in _prompts(engine, lengths)]
    engine.run_until_idle(max_steps=200)
    return handles


def _program_events(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events() if spans.is_program(e.name)]


# -- the mechanism ----------------------------------------------------------


def test_phases_record_self_time_and_leave_out_the_callers_own(monkeypatch):
    now = [0.0]
    monkeypatch.setattr(spans.time, "perf_counter", lambda: now[0])
    ph = spans.Phases()
    with ph.span("engine/admit"):
        now[0] += 1.0
        with ph.span("engine/prefix_match"):
            now[0] += 2.0
        with ph.span("engine/prefill_dispatch", phase=False) as enq:
            now[0] += 4.0
        now[0] += 8.0
    with ph.span("engine/prefix_match"):
        now[0] += 16.0
    assert enq.seconds == 4.0
    assert ph.seconds == {"engine/prefix_match": 18.0, "engine/admit": 9.0}
    assert ph.calls == {"engine/prefix_match": 2, "engine/admit": 1}
    assert not spans.enabled()


def test_the_switch_is_off_by_default_and_restored():
    assert not spans.enabled()
    with spans.recording():
        assert spans.enabled()
        with spans.recording():
            assert spans.enabled()
        assert spans.enabled()
    assert not spans.enabled()
    assert spans.base("executor/gemm[l0_wq]") == "executor/gemm"


# -- the always-on counters ---------------------------------------------------


def test_phases_and_dispatch_counters_accumulate_and_reset(models):
    engine = _engine(models)
    _serve(engine)
    st = engine.stats
    assert set(st.host_s) == set(st.host_calls) == set(PHASES)
    assert all(st.host_s[p] > 0 and st.host_calls[p] > 0 for p in PHASES)
    assert st.host_calls["engine/admit"] == len(st.step_times_s)
    assert st.host_calls["engine/prefix_match"] == st.prefix_lookups == 5
    assert st.host_calls["engine/finish"] == st.requests_completed == 5
    assert st.host_calls["engine/sample"] == st.tokens_generated + st.prompt_tokens_forced
    for kind in ("prefill", "decode"):
        assert getattr(st, f"{kind}_enqueue_s") > 0 and getattr(st, f"{kind}_fetch_s") > 0
    assert st.prefill_lanes > 0 and len(st.queue_wait_s) == 5
    # the phases and the dispatches cover the steps' wall time
    covered = sum(st.host_s.values()) + st.prefill_time_s + st.decode_time_s
    assert 0.9 * sum(st.step_times_s) < covered <= sum(st.step_times_s)
    fresh = engine.reset_stats()
    assert fresh.host_s == fresh.host_calls == {} and fresh.queue_wait_s == []
    assert (fresh.prefill_enqueue_s, fresh.prefill_fetch_s, fresh.decode_enqueue_s,
            fresh.decode_fetch_s, fresh.prefill_lanes) == (0.0, 0.0, 0.0, 0.0, 0)
    _serve(engine, lengths=(12,))
    assert engine.stats.host_calls["engine/finish"] == 1
    assert len(engine.stats.queue_wait_s) == 1


def test_snapshot_does_not_alias_the_live_record(models):
    engine = _engine(models)
    engine.submit(_prompts(engine, (17,))[0], 3)
    engine.step()
    snap = engine.stats_snapshot()
    frozen = (dict(snap.host_s), dict(snap.host_calls), list(snap.queue_wait_s))
    for field in ("host_s", "host_calls", "queue_wait_s"):
        assert getattr(snap, field) is not getattr(engine.stats, field)
    _serve(engine, lengths=(8, 23))
    assert (snap.host_s, snap.host_calls, snap.queue_wait_s) == frozen
    assert engine.stats.host_calls != snap.host_calls
    assert len(engine.stats.queue_wait_s) == 3


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_enqueue_plus_fetch_is_the_dispatch_time(models, kind):
    engine = _engine(models, kind)
    _serve(engine, lengths=(8, 9, 11, 8) if kind == "dense" else (8, 17, 23, 8, 30))
    st = engine.stats
    assert st.prefill_dispatches > 0 and st.decode_dispatches > 0
    assert st.prefill_enqueue_s + st.prefill_fetch_s == pytest.approx(st.prefill_time_s,
                                                                      rel=1e-12, abs=1e-15)
    assert st.decode_enqueue_s + st.decode_fetch_s == pytest.approx(st.decode_time_s,
                                                                    rel=1e-12, abs=1e-15)


def test_prefill_lanes_count_the_lanes_named(models):
    engine = _engine(models)
    named = []
    chunks = engine.session.prefill_chunks

    def counted(todo):
        out = chunks(todo)
        named.append(len(todo))
        return out

    engine.session.prefill_chunks = counted
    _serve(engine)
    st = engine.stats
    assert st.prefill_dispatches == len(named) and st.prefill_lanes == sum(named)
    assert st.chunk_lane_use() == sum(named) / (len(named) * engine.max_batch)
    assert max(named) > 1  # a dispatch carried several lanes


def test_queue_wait_is_admission_less_arrival_on_the_engine_clock(models):
    now = [0.0]
    engine = _engine(models, max_batch=2, clock=lambda: now[0])
    handles = [engine.submit(p, 2) for p in _prompts(engine, (8, 8, 8))]
    now[0] = 1.5
    engine.step()
    now[0] = 4.0
    engine.run_until_idle(max_steps=50)
    assert [h.admit_t for h in handles] == [1.5, 1.5, 4.0]
    assert engine.stats.queue_wait_s == [h.admit_t - h.arrival_t for h in handles]
    assert engine.stats.queue_wait(50) == 1.5 and engine.stats.queue_wait(99) == 4.0


# -- the profiler spans -------------------------------------------------------


def test_switch_off_marks_nothing(models):
    engine = _engine(models)
    for p in _prompts(engine, (17, 8)):
        engine.submit(p, 3)
    assert _program_events(lambda: [engine.step() for _ in range(3)]) == []
    assert engine.stats.host_calls["engine/admit"] == 3  # the counters still count


def _dispatch_of(event):
    e = event.cpu_parent
    while e is not None and not spans.base(e.name).endswith("_dispatch"):
        e = e.cpu_parent
    return e


def test_switch_on_marks_every_plan_node_inside_its_dispatch(models):
    engine = _engine(models)
    for p in _prompts(engine, (17, 8, 12)):  # rids 0, 1, 2: 3, 1 and 2 chunks
        engine.submit(p, 3)
    engine.step()  # the first chunks; rid 1 decodes from now on
    with spans.recording():
        events = _program_events(engine.step)  # rids 0, 2 chunk; rids 1, 2 decode
    pair = engine.session.model.artifact
    dispatches = {spans.base(e.name): e for e in events
                  if spans.base(e.name).endswith("_dispatch")}
    assert dispatches["engine/prefill_dispatch"].name == "engine/prefill_dispatch[rid=0,2]"
    assert dispatches["engine/decode_dispatch"].name == "engine/decode_dispatch[rid=1,2]"
    for kind, plan in (("prefill", pair.prefill), ("decode", pair.decode)):
        d = dispatches[f"engine/{kind}_dispatch"]
        inside = [e for e in events if _dispatch_of(e) is not None
                  and _dispatch_of(e).id == d.id]
        want = sorted([f"executor/{n.kind}" if not n.fused else "executor/region"
                       for n in plan.nodes]
                      + [f"executor/{b.kind}" for n in plan.nodes for b in n.body])
        assert sorted(spans.base(e.name) for e in inside
                      if e.name.startswith("executor/")) == want
        for e in inside:  # a top node and the session's staging sit in the dispatch,
            # a body node in its region
            assert e.cpu_parent.id == d.id or spans.base(e.cpu_parent.name) == "executor/region"
        assert [spans.base(e.name) for e in inside].count("session/prepare") == 1
    assert not spans.enabled()


def test_innermost_pieces_and_ms_by_span():
    nested = [(0.0, 10.0, "engine/prefill_dispatch[rid=1]"), (1.0, 4.0, "executor/region"),
              (2.0, 3.0, "executor/gemm[l0]"), (6.0, 7.0, "executor/lmhead")]
    pieces = serve.innermost(nested, -1.0, 12.0)
    assert [(s, e, n and spans.base(n)) for s, e, n in pieces] == [
        (-1.0, 0.0, None), (0.0, 1.0, "engine/prefill_dispatch"),
        (1.0, 2.0, "executor/region"), (2.0, 3.0, "executor/gemm"),
        (3.0, 4.0, "executor/region"), (4.0, 6.0, "engine/prefill_dispatch"),
        (6.0, 7.0, "executor/lmhead"), (7.0, 10.0, "engine/prefill_dispatch"),
        (10.0, 12.0, None)]
    busy = serve.union([(2.5, 6.5), (0.5, 1.0), (6.2, 6.4)])
    assert busy == [(0.5, 1.0), (2.5, 6.5)]
    assert serve.ms_by_span(busy, pieces) == {
        "engine/prefill_dispatch": 2.5, "executor/region": 1.0, "executor/gemm": 0.5,
        "executor/lmhead": 0.5}


def test_serve_profile_reads_the_spans_on_the_cpu(capsys, tmp_path):
    serve.main(["--arch", "olmo-1b", "--reduced", "--batch", "2", "--requests", "2",
                "--gen", "2", "--prompt-len", "8", "--kv-block-size", "4",
                "--device", "cpu", "--plan-cache", str(tmp_path), "--profile"])
    out = capsys.readouterr().out
    assert out.count("device busy 0.000 ms") == 2  # no device kernels on the CPU
    assert out.count("profile: busy 0.0%, idle 100.0% of the traced window") == 2
    host = [ln for ln in out.splitlines() if ln.startswith("profile: host self ms")]
    assert len(host) == 2 and all("executor/" in ln and "engine/" in ln for ln in host)
    idle = [ln for ln in out.splitlines() if ln.startswith("profile: idle ms")]
    assert len(idle) == 2 and all("executor/" in ln for ln in idle)
    assert not spans.enabled()


def test_the_operator_views_of_the_counters():
    s = EngineStats(max_batch=4, prefill_dispatches=2, decode_dispatches=4,
                    prefill_enqueue_s=0.5, prefill_fetch_s=1.5, decode_enqueue_s=0.2,
                    decode_fetch_s=0.6, prefill_lanes=3)
    s.step_times_s[:] = [1.0, 1.0]
    s.host_s.update({"engine/admit": 0.1, "engine/sample": 0.3})
    s.host_calls.update({"engine/admit": 2, "engine/sample": 8})
    s.queue_wait_s[:] = [0.01, 0.03, 0.02]
    assert s.host_per_step() == {"engine/admit": {"ms": pytest.approx(50.0), "calls": 1.0},
                                 "engine/sample": {"ms": pytest.approx(150.0), "calls": 4.0}}
    assert s.chunk_lane_use() == 3 / 8
    assert (s.queue_wait(50), s.queue_wait(99)) == (0.02, 0.03)
