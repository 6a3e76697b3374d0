"""The port's concurrency & KV-lifetime sanitizer against the JAX package's.

Every class of the reference's ``tests/test_sanitize.py``, on reduced
OLMo-1B with ``device="cpu"``: the static lock-order and affinity lints
run clean on ``src/repro_torch/deploy`` itself, every rule id (LOCK001-006,
AFF001, BLK001-005, SCHED001) is shown by a mutation, the bounded
interleaving checks verify the clean protocols and catch each seeded bug,
and the serving stack (session, engine, ``AsyncEngine`` under thread
stress, the HTTP stats) runs with ``REPRO_SANITIZE=1`` with zero findings.

Parity with the JAX package: the same seeded-defect sources linted by both
packages give equal diagnostic lists, element by element; the same
``ShadowPool`` operation sequences give equal findings and snapshots; the
interleaving checks give equal results; a skipped copy-on-write at the
same step raises BLK003 with the same message in both sessions (the
port's pool unchanged); sanitized greedy engine streams equal the JAX
package's sanitized engine and the port's unsanitized one; and the
``/v1/stats`` ``sanitize`` sections are equal.  The CI twins
``ci/torch_smoke_*.py`` run plain and sanitized.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config, reduced
from repro.deploy import api as j_api
from repro.deploy import sanitize as JS
from repro.deploy.engine import Engine as JEngine
from repro.deploy.paging import BlockAllocator as JAlloc
from repro.models import transformer as JT
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import from_jax_quantized
from repro_torch.deploy import api as t_api
from repro_torch.deploy import sanitize as S
from repro_torch.deploy.engine import Engine
from repro_torch.deploy.paging import BlockAllocator
from repro_torch.deploy.sanitize import (
    SanitizerDiagnostic,
    SanitizerError,
    affinity_report,
    check_block_interleavings,
    check_interleavings,
    check_scheduler_interleavings,
    lint_affinity,
    lint_lock_order,
)

ROOT = Path(__file__).resolve().parents[1]
SEQ = 8
MAX_LEN = 24


@pytest.fixture(autouse=True)
def _clean_lockdep():
    """Each test starts with an empty observed-order graph and no findings,
    in both packages."""
    S.reset_runtime()
    JS.reset_runtime()
    yield
    S.reset_runtime()
    JS.reset_runtime()


@pytest.fixture
def sanitize_on(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")


@pytest.fixture(scope="module")
def olmo():
    cfg, tcfg = reduced(get_config("olmo-1b")), t_reduced(t_get_config("olmo-1b"))
    params = JT.init_params(cfg, jax.random.PRNGKey(7))
    qp = JT.quantize_params(cfg, params)
    return cfg, tcfg, params, from_jax_quantized(jax.tree.map(np.asarray, qp))


def _opts(**kw):
    return dict(backend="w8a8", seq_len=SEQ, max_len=MAX_LEN, use_cache=False,
                kv_block_size=4, kv_blocks=14, **kw)


@pytest.fixture(scope="module")
def paged_model(olmo):
    return t_api.compile(olmo[1], **_opts())


@pytest.fixture(scope="module")
def j_paged_model(olmo):
    return j_api.compile(olmo[0], verify=False, **_opts())


def _engine(model, olmo, max_batch=2):
    return Engine(model, max_batch, qp=olmo[3], device="cpu")


def _session(model, olmo, batch=2):
    return model.session(batch, qp=olmo[3], device="cpu")


def _prompts(cfg, n, *, lengths=(SEQ, SEQ + 2), seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, cfg.vocab, lengths[i % len(lengths)])]
            for i in range(n)]


def _asdicts(diags) -> list:
    return [dataclasses.asdict(d) for d in diags]


# ---------------------------------------------------------------------------
# static lock-order lint
# ---------------------------------------------------------------------------

#: seeded-defect sources, linted by both packages (the lint reads the AST
#: only, so the import line names neither package's module)
SOURCES = {
    "cycle": (
        "import threading\n"
        "class Duo:\n"
        "    def __init__(self):\n"
        "        self.a = threading.Lock()\n"
        "        self.b = threading.Lock()\n"
        "    def ab(self):\n"
        "        with self.a:\n"
        "            with self.b:\n"
        "                pass\n"
        "    def ba(self):\n"
        "        with self.b:\n"
        "            with self.a:\n"
        "                pass\n"),
    "selfdead": (
        "import threading\n"
        "class SelfDeadlock:\n"
        "    def __init__(self):\n"
        "        self.m = threading.Lock()\n"
        "    def outer(self):\n"
        "        with self.m:\n"
        "            self.inner()\n"
        "    def inner(self):\n"
        "        with self.m:\n"
        "            pass\n"),
    "reentrant": (
        "import threading\n"
        "class Fine:\n"
        "    def __init__(self):\n"
        "        self.m = threading.RLock()\n"
        "    def outer(self):\n"
        "        with self.m:\n"
        "            self.inner()\n"
        "    def inner(self):\n"
        "        with self.m:\n"
        "            pass\n"),
    "lattice": (
        "from sanitize import make_condition, make_lock\n"
        "class Inverted:\n"
        "    def __init__(self):\n"
        "        self.lock = make_lock('engine.lock', reentrant=True)\n"
        "        self.cv = make_condition('serving.cv')\n"
        "    def bad(self):\n"
        "        with self.lock:\n"
        "            with self.cv:\n"
        "                pass\n"),
    "waithold": (
        "from sanitize import make_condition, make_lock\n"
        "class WaitsWhileHolding:\n"
        "    def __init__(self):\n"
        "        self.cv = make_condition('serving.cv')\n"
        "        self.lock = make_lock('engine.lock', reentrant=True)\n"
        "    def bad(self):\n"
        "        with self.cv:\n"
        "            with self.lock:\n"
        "                self.cv.wait()\n"),
    "undeclared": (
        "from sanitize import make_lock\n"
        "class Unranked:\n"
        "    def __init__(self):\n"
        "        self.lock = make_lock('engine.lock', reentrant=True)\n"
        "        self.side = make_lock('side.lock')\n"
        "    def nest(self):\n"
        "        with self.lock:\n"
        "            with self.side:\n"
        "                pass\n"),
    "property_and_alias": (
        "import threading\n"
        "class Props:\n"
        "    def __init__(self):\n"
        "        self.a = threading.Lock()\n"
        "        self.b = threading.Lock()\n"
        "    @property\n"
        "    def busy(self):\n"
        "        with self.a:\n"
        "            return 1\n"
        "    def f(self):\n"
        "        held = self.b\n"
        "        with held:\n"
        "            return self.busy\n"
        "    def g(self):\n"
        "        with self.a:\n"
        "            self.b.acquire()\n"),
}


def _lint_both(tmp_path, name: str) -> list:
    """Lint one seeded source with both packages: equal lists, element by
    element; returns the port's."""
    f = tmp_path / f"{name}.py"
    f.write_text(SOURCES[name])
    got, want = lint_lock_order([str(f)]), JS.lint_lock_order([str(f)])
    assert _asdicts(got) == _asdicts(want)
    assert [d.format() for d in got] == [d.format() for d in want]
    return got


class TestStaticLockLint:
    def test_repo_lints_clean(self):
        assert lint_lock_order() == []
        port_deploy = str(ROOT / "src" / "repro_torch" / "deploy")
        assert S._default_paths() == [port_deploy]
        # the reference's lint over the port's package agrees
        assert JS.lint_lock_order([port_deploy]) == []

    def test_lock001_two_lock_cycle(self, tmp_path):
        diags = _lint_both(tmp_path, "cycle")
        assert {d.rule for d in diags} == {"LOCK001"}

    def test_lock001_self_deadlock_through_call_graph(self, tmp_path):
        diags = _lint_both(tmp_path, "selfdead")
        assert any(d.rule == "LOCK001" for d in diags)

    def test_lock001_not_raised_for_reentrant_self_edge(self, tmp_path):
        assert _lint_both(tmp_path, "reentrant") == []

    def test_lock002_lattice_inversion(self, tmp_path):
        diags = _lint_both(tmp_path, "lattice")
        assert any(d.rule == "LOCK002" and d.severity == "error" for d in diags)

    def test_lock002_warning_on_an_unranked_nesting(self, tmp_path):
        diags = _lint_both(tmp_path, "undeclared")
        assert [(d.rule, d.severity, d.obj) for d in diags] == [
            ("LOCK002", "warning", "side.lock")]

    def test_lock004_static_wait_while_holding(self, tmp_path):
        diags = _lint_both(tmp_path, "waithold")
        assert any(d.rule == "LOCK004" for d in diags)

    def test_properties_aliases_and_acquire_calls_are_seen(self, tmp_path):
        diags = _lint_both(tmp_path, "property_and_alias")
        assert {d.rule for d in diags} == {"LOCK001"}
        assert "Props.b -> Props.a" in diags[0].message \
            or "Props.a -> Props.b" in diags[0].message

    def test_diagnostics_are_structured(self, tmp_path):
        (d,) = _lint_both(tmp_path, "selfdead")[:1]
        assert isinstance(d, SanitizerDiagnostic)
        assert d.severity == "error" and d.source == "static-lint"
        assert "LOCK001" in d.format()

    def test_whole_lint_of_both_deploy_packages_agrees(self):
        """The port's lint over the JAX package's ``deploy/`` equals the
        reference's lint over it."""
        ref_deploy = str(ROOT / "src" / "repro" / "deploy")
        assert _asdicts(lint_lock_order([ref_deploy])) == \
            _asdicts(JS.lint_lock_order([ref_deploy])) == []


# ---------------------------------------------------------------------------
# thread-affinity lint
# ---------------------------------------------------------------------------


class TestAffinityLint:
    def test_session_lints_clean(self):
        assert lint_affinity() == []

    def test_every_known_mutator_is_classified_and_guarded(self):
        rep = affinity_report()
        need = {"prefill", "prefill_slot", "prefill_chunk", "prefill_chunks",
                "free_slot", "attach_prefix", "decode"}
        for m in need:
            assert rep[m]["mutating"], f"{m} not classified as mutating"
            assert rep[m]["guarded"], f"{m} does not call _affine"
        # the reference's report over the port's session class agrees
        port_api = str(ROOT / "src" / "repro_torch" / "deploy" / "api.py")
        assert rep == JS.affinity_report(port_api)

    @pytest.mark.parametrize("src,obj", [
        ("class InferenceSession:\n"
         "    def _affine(self, method):\n"
         "        pass\n"
         "    def guarded(self, x):\n"
         "        self._affine('guarded')\n"
         "        self._pos = x\n"
         "    def unguarded(self, x):\n"
         "        self._pos = x\n"
         "    def reader(self):\n"
         "        return self._pos\n", "unguarded"),
        ("class InferenceSession:\n"
         "    def _affine(self, method):\n"
         "        pass\n"
         "    def _helper(self):\n"
         "        self._tables.fill(0)\n"
         "    def public(self):\n"
         "        self._helper()\n", "public"),
    ], ids=["unguarded_mutator", "transitive_through_private_helper"])
    def test_aff001(self, tmp_path, src, obj):
        f = tmp_path / "session.py"
        f.write_text(src)
        diags = lint_affinity(path=str(f))
        assert [d.rule for d in diags] == ["AFF001"]
        assert diags[0].obj == obj
        assert _asdicts(diags) == _asdicts(JS.lint_affinity(path=str(f)))

    def test_missing_class_raises(self, tmp_path):
        f = tmp_path / "empty.py"
        f.write_text("x = 1\n")
        with pytest.raises(ValueError, match="no class 'InferenceSession'"):
            affinity_report(str(f))


# ---------------------------------------------------------------------------
# lockdep runtime checker
# ---------------------------------------------------------------------------


def _lock003_observed(mod):
    a, b = mod.make_lock("A"), mod.make_lock("B")
    with a:
        with b:
            pass
    with b:
        with a:
            pass


def _lock003_lattice(mod):
    eng = mod.make_lock("engine.lock", reentrant=True)
    cv = mod.make_condition("serving.cv")
    with eng:
        with cv:
            pass


def _lock004(mod):
    eng = mod.make_lock("engine.lock", reentrant=True)
    cv = mod.make_condition("serving.cv")
    with cv:
        with eng:
            cv.wait(timeout=0.01)


def _lock005(mod):
    m = mod.make_lock("m")
    with m:
        with m:
            pass


def _lock006(mod):
    mod.require_held(mod.make_lock("g"), "scheduler.FIFO")


RUNTIME_CASES = {"LOCK003-observed": _lock003_observed, "LOCK003-lattice": _lock003_lattice,
                 "LOCK004": _lock004, "LOCK005": _lock005, "LOCK006": _lock006}


def _runtime_outcome(mod, case) -> tuple:
    mod.reset_runtime()
    with pytest.raises(mod.SanitizerError) as ei:
        RUNTIME_CASES[case](mod)
    return str(ei.value), _asdicts(ei.value.diagnostics), _asdicts(mod.runtime_findings())


class TestLockdepRuntime:
    def test_disabled_returns_plain_primitives(self, monkeypatch):
        monkeypatch.delenv("REPRO_SANITIZE", raising=False)
        assert not S.enabled()
        assert not isinstance(S.make_lock("x"), S._TrackedLock)
        assert isinstance(S.make_condition("cv"), threading.Condition)

    @pytest.mark.parametrize("case", list(RUNTIME_CASES))
    def test_runtime_rule_equals_reference(self, sanitize_on, case):
        got = _runtime_outcome(S, case)
        assert got == _runtime_outcome(JS, case)
        msg, diags, findings = got
        assert diags[0]["rule"] == case.split("-")[0] and diags[0]["source"] == "lockdep"
        assert findings == diags and "lockdep runtime checker" in msg

    def test_legal_lattice_nesting_is_quiet(self, sanitize_on):
        eng = S.make_lock("engine.lock", reentrant=True)
        cv = S.make_condition("serving.cv")
        hl = S.make_lock("frontend.hlock")
        with cv:
            with eng:
                pass
        with eng:
            with eng:  # reentrant self-nesting
                pass
        with hl:
            pass
        assert S.runtime_findings() == ()

    def test_condition_wait_and_notify_across_threads(self, sanitize_on):
        cv = S.make_condition("serving.cv")
        box = []

        def waiter():
            with cv:
                box.append(cv.wait_for(lambda: len(box) == 1, timeout=5))

        t = threading.Thread(target=waiter)
        with cv:
            t.start()
            box.append("go")
            cv.notify_all()
        t.join(timeout=10)
        assert box == ["go", True] and S.runtime_findings() == ()

    def test_lock006_quiet_when_held(self, sanitize_on):
        g = S.make_lock("g")
        with g:
            S.require_held(g, "scheduler.FIFO")  # held: quiet
        assert S.runtime_findings() == ()

    def test_require_held_is_noop_on_plain_locks(self):
        S.require_held(threading.Lock(), "anywhere")

    def test_scheduler_guard_fires_without_engine_lock(self, sanitize_on):
        from repro_torch.deploy.serving.scheduler import FIFO

        sched = FIFO()
        sched.guard_lock = S.make_lock("engine.lock", reentrant=True)

        class H:
            rid, priority, arrival_t = 0, 0, 0.0
            ttft_slo_ms = deadline_ms = deadline_t = admit_deadline_t = None

        with pytest.raises(SanitizerError) as ei:
            sched.add(H(), 0.0)
        assert ei.value.diagnostics[0].rule == "LOCK006"
        assert ei.value.diagnostics[0].obj == "scheduler.FIFO"
        with sched.guard_lock:
            sched.add(H(), 0.0)  # under the lock: quiet

    def test_reset_runtime_clears_order_and_findings(self, sanitize_on):
        a, b = S.make_lock("A2"), S.make_lock("B2")
        with a:
            with b:
                pass
        S.reset_runtime()
        # the A2->B2 edge is gone: acquiring in reverse is legal again
        with b:
            with a:
                pass
        S.reset_runtime()
        assert S.runtime_findings() == ()


# ---------------------------------------------------------------------------
# shadow block-lifecycle sanitizer (BLK001..BLK005)
# ---------------------------------------------------------------------------


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except (JS.SanitizerError, SanitizerError) as e:
        return ("SanitizerError", str(e), _asdicts(e.diagnostics))
    except Exception as e:  # noqa: BLE001 - the type and text are compared
        return (type(e).__name__, str(e))


def _shadow_trace(alloc_cls, seed: int, n_ops: int = 60) -> list:
    """A seeded random sequence of allocator transitions, shadow writes,
    out-of-band tampering and audits on one package's allocator; each
    step's outcome, the shadow's snapshot and its findings recorded."""
    rng = np.random.default_rng(seed)
    a = alloc_cls(6)
    trace = []
    for _ in range(n_ops):
        op = rng.choice(["allocate", "allocate", "fork", "cow", "free", "free", "write",
                         "write", "shadow_free", "shadow_fork", "tamper", "audit"])
        b = int(rng.integers(0, 7))
        if op == "allocate":
            out = _outcome(lambda n: a.allocate(n, owner=0), int(rng.integers(0, 3)))
        elif op == "fork":
            out = _outcome(a.fork, [b])
        elif op == "cow":
            out = _outcome(lambda blk: a.cow(blk, owner=1), b)
        elif op == "free":
            out = _outcome(a.free, [b])
        elif op == "write":
            out = _outcome(a.shadow.write, int(rng.integers(0, 2)), b, a)
        elif op == "shadow_free":
            out = _outcome(a.shadow.free, [b], a)
        elif op == "shadow_fork":
            out = _outcome(a.shadow.fork, [b], a)
        elif op == "tamper":
            if b in a._ref:
                a._ref[b] += 1
            out = ("tampered", b)
        else:
            out = ("audit", _asdicts(a.shadow.audit(a)))
        trace.append((str(op), out, a.shadow.snapshot(), _asdicts(a.shadow.findings),
                      a.n_free, sorted(a._ref.items())))
    return trace


def _blk_use_after_free_write(A):
    a = A(4)
    (b,) = a.allocate(1)
    a.free([b])
    return _outcome(a.shadow.write, 0, b, a)


def _blk_fork_of_free(A):
    a = A(4)
    return _outcome(a.fork, [2]), _outcome(a.shadow.fork, [2], a)


def _blk_cow_of_free(A):
    a = A(4)
    return _outcome(a.cow, 3), _outcome(a.shadow.pre_cow, 3, a)


def _blk_double_free(A):
    a = A(4)
    (b,) = a.allocate(1)
    a.free([b])
    return _outcome(a.free, [b]), _outcome(a.shadow.free, [b], a)


def _blk_shared_write(A):
    a = A(4)
    blks = a.allocate(2, owner=0)
    a.fork([blks[0]])
    return _outcome(a.shadow.write, 0, blks[0], a), _outcome(a.shadow.write, 0, blks[1], a)


def _blk_drift(A):
    a = A(4)
    (b,) = a.allocate(1)
    a._ref[b] = 3  # out-of-band tamper, bypassing fork()
    return _outcome(a.free, [b]), _outcome(a.fork, [b]), _outcome(a.cow, b)


def _blk_leak(A):
    a = A(4)
    a.allocate(2)
    del a._ref[1]  # leaked: neither free-listed nor refcounted
    return _asdicts(a.shadow.audit(a)), a.shadow.snapshot()


#: one seeded defect per shadow rule, run on both packages' allocators
BLK_CASES = {"BLK001-write": _blk_use_after_free_write, "BLK001-fork": _blk_fork_of_free,
             "BLK001-cow": _blk_cow_of_free, "BLK002": _blk_double_free,
             "BLK003": _blk_shared_write, "BLK004": _blk_drift, "BLK005": _blk_leak}


class TestShadowPool:
    @pytest.mark.parametrize("case", list(BLK_CASES))
    def test_seeded_defect_equals_reference(self, sanitize_on, case):
        got = BLK_CASES[case](BlockAllocator)
        assert got == BLK_CASES[case](JAlloc)
        rule = case.split("-")[0]
        assert rule in json.dumps(got)
        assert all(f'"{r}"' not in json.dumps(got)
                   for r in {"BLK001", "BLK002", "BLK003"} - {rule})

    def test_clean_lifecycle_is_quiet(self, sanitize_on):
        a = BlockAllocator(4)
        assert a.shadow is not None and a.shadow.n_blocks == 4
        blks = a.allocate(2, owner=0)
        a.fork([blks[0]])
        fresh, copied = a.cow(blks[0], owner=1)
        assert copied and fresh != blks[0]
        assert a.shadow.state_of(fresh) == S.COW_PENDING
        a.shadow.write(1, fresh, a)  # COW_PENDING -> EXCLUSIVE
        assert a.shadow.state_of(fresh) == S.EXCLUSIVE
        a.free([fresh])
        a.free(blks)
        assert a.shadow.findings == []
        assert a.shadow.audit(a) == []
        snap = a.shadow.snapshot()
        assert snap["free"] == 4 and snap["findings"] == 0

    def test_disabled_means_no_shadow(self, monkeypatch):
        monkeypatch.delenv("REPRO_SANITIZE", raising=False)
        assert BlockAllocator(4).shadow is None

    def test_blk001_use_after_free_write(self, sanitize_on):
        a = BlockAllocator(4)
        (b,) = a.allocate(1)
        a.free([b])
        with pytest.raises(SanitizerError) as ei:
            a.shadow.write(0, b, a)
        assert ei.value.diagnostics[0].rule == "BLK001"

    def test_blk001_fork_of_free_block(self, sanitize_on):
        # plain API misuse keeps the allocator's documented ValueError ...
        a = BlockAllocator(4)
        with pytest.raises(ValueError, match="not allocated"):
            a.fork([2])
        # ... the shadow hook is for divergence the allocator misses
        with pytest.raises(SanitizerError) as ei:
            a.shadow.fork([2], a)
        assert ei.value.diagnostics[0].rule == "BLK001"

    def test_blk001_cow_of_free_block(self, sanitize_on):
        a = BlockAllocator(4)
        with pytest.raises(SanitizerError) as ei:
            a.shadow.pre_cow(3, a)
        assert ei.value.diagnostics[0].rule == "BLK001"

    def test_blk002_double_free(self, sanitize_on):
        a = BlockAllocator(4)
        (b,) = a.allocate(1)
        a.free([b])
        with pytest.raises(ValueError, match="double free"):
            a.free([b])  # caller misuse: allocator error, unchanged
        with pytest.raises(SanitizerError) as ei:
            a.shadow.free([b], a)  # divergence path: BLK002
        assert ei.value.diagnostics[0].rule == "BLK002"

    def test_blk003_write_into_shared_block(self, sanitize_on):
        a = BlockAllocator(4)
        blks = a.allocate(2, owner=0)
        a.fork([blks[0]])
        with pytest.raises(SanitizerError) as ei:
            a.shadow.write(0, blks[0], a)
        assert ei.value.diagnostics[0].rule == "BLK003"
        a.shadow.findings.clear()
        a.shadow.write(0, blks[1], a)  # exclusive block: quiet
        assert a.shadow.findings == []

    def test_blk004_refcount_drift(self, sanitize_on):
        a = BlockAllocator(4)
        (b,) = a.allocate(1)
        a._ref[b] = 3  # out-of-band tamper, bypassing fork()
        with pytest.raises(SanitizerError) as ei:
            a.free([b])
        assert ei.value.diagnostics[0].rule == "BLK004"

    def test_blk005_conservation_leak_via_audit(self, sanitize_on):
        a = BlockAllocator(4)
        a.allocate(2)
        assert a.shadow.audit(a) == []
        del a._ref[1]  # leaked: neither free-listed nor refcounted
        diags = a.shadow.audit(a)
        assert any(d.rule == "BLK005" for d in diags)
        assert any(d.rule == "BLK004" for d in diags)
        assert all(d.source == "shadow" for d in diags)
        assert a.shadow.findings  # audit findings are recorded

    def test_failed_allocate_leaves_shadow_consistent(self, sanitize_on):
        from repro_torch.deploy.paging import PoolExhausted

        a = BlockAllocator(2)
        a.allocate(2)
        with pytest.raises(PoolExhausted):
            a.allocate(1)
        assert a.shadow.audit(a) == []

    def test_scratch_block_writes_are_ignored(self, sanitize_on):
        a = BlockAllocator(2)
        a.shadow.write(0, 0, a)  # parked lanes scatter into scratch
        assert a.shadow.findings == []

    @pytest.mark.parametrize("seed", range(6))
    def test_operation_sequences_equal_reference(self, sanitize_on, seed):
        got = _shadow_trace(BlockAllocator, seed)
        assert got == _shadow_trace(JAlloc, seed)
        assert {d["rule"] for step in got for d in step[3]}  # failure paths are reached


# ---------------------------------------------------------------------------
# session integration: the _note_writes hook
# ---------------------------------------------------------------------------


def _both_sessions(olmo, j_paged_model, paged_model):
    return (j_paged_model.session(2, params=olmo[2]), _session(paged_model, olmo))


def _skip_cow_outcome(sess, step: str) -> tuple:
    """Seed a skipped copy-on-write and run the slot's next write
    (``decode`` or a tail ``chunk``); returns the error, its diagnostics and
    the slot, and checks that the pool did not change."""
    prompt = np.arange(10, dtype=np.int32)[None] % 50
    sess.prefill_slot(0, prompt)  # pos=10: mid-block (size 4)
    if step == "decode":
        tail = sess.block_chain(0)[-1]
        sess.allocator.fork([tail])  # now shared with a phantom sibling
        slot, run = 0, lambda: sess.decode(np.zeros((2,), np.int32), active=[True, False])
    else:
        sess.attach_prefix(1, sess.block_chain(0), 10)  # every block shared
        chunk = (np.arange(8, dtype=np.int32)[None] + 3) % 50
        slot, run = 1, lambda: sess.prefill_chunk(1, chunk, 8)
    sess._cow_range = lambda *a, **k: None  # seeded: COW skipped
    before = {part: np.array(t) for part, t in sess.kv_pool.items()}
    with pytest.raises((SanitizerError, JS.SanitizerError)) as ei:
        run()
    del sess._cow_range
    for part, t in sess.kv_pool.items():  # refused before the dispatch
        assert np.array_equal(np.asarray(t), before[part]), part
    return str(ei.value), _asdicts(ei.value.diagnostics), slot


class TestSessionShadowIntegration:
    @pytest.mark.parametrize("step", ["decode", "chunk"])
    def test_skipped_cow_caught_before_dispatch(self, olmo, j_paged_model, paged_model,
                                                sanitize_on, step):
        js, ts = _both_sessions(olmo, j_paged_model, paged_model)
        got = _skip_cow_outcome(ts, step)
        assert got == _skip_cow_outcome(js, step)
        assert got[1][0]["rule"] == "BLK003" and f"slot {got[2]} writes into shared" \
            in got[1][0]["message"]
        assert _asdicts(ts.allocator.shadow.findings) == got[1]

    def test_cow_path_keeps_decode_quiet(self, olmo, paged_model, sanitize_on):
        sess = _session(paged_model, olmo)
        prompt = np.arange(10, dtype=np.int32)[None] % 50
        sess.prefill_slot(0, prompt)
        tail = sess.block_chain(0)[-1]
        sess.allocator.fork([tail])
        sess.decode(np.zeros((2,), np.int32), active=[True, False])
        assert sess.allocator.shadow.findings == []
        assert tail not in sess.block_chain(0)  # COW replaced it
        sess.allocator.free([tail])  # drop the phantom sibling's ref
        assert sess.allocator.shadow.audit(sess.allocator) == []

    def test_whole_session_prefill_notes_every_slot(self, olmo, paged_model, sanitize_on):
        sess = _session(paged_model, olmo)
        shadow = sess.allocator.shadow
        noted, write = [], shadow.write
        shadow.write = lambda slot, blk, alloc: (noted.append((slot, blk)),
                                                 write(slot, blk, alloc))
        sess.prefill(np.arange(2 * SEQ, dtype=np.int32).reshape(2, SEQ) % 50)
        assert noted == [(b, blk) for b in range(2) for blk in sess.block_chain(b)]
        snap = shadow.snapshot()
        assert snap["exclusive"] == sess.allocator.n_used == 4 and snap["findings"] == 0

    @pytest.mark.parametrize("prefix_cache", [False, True], ids=["no_prefix", "prefix"])
    def test_engine_streams_equal_reference_and_unsanitized(self, olmo, monkeypatch,
                                                           prefix_cache):
        """Greedy streams of the port's sanitized engine equal the JAX
        package's sanitized engine and the port's unsanitized one, with
        zero findings; with the prefix cache, shared prompts fork, attach
        and copy on write under the shadow pool."""
        opts = _opts(prefix_cache=prefix_cache)
        prompts = _prompts(olmo[0], 4)
        if prefix_cache:
            prompts += [list(prompts[0]), prompts[1][:SEQ] + prompts[2][:2]]

        def run(engine):
            handles = [engine.submit(p, 3) for p in prompts]
            while not engine.idle:
                engine.step()
            return [(list(h.tokens), h.finish_reason) for h in handles]

        monkeypatch.delenv("REPRO_SANITIZE", raising=False)
        plain_eng = _engine(t_api.compile(olmo[1], **opts), olmo)
        assert plain_eng.session.allocator.shadow is None
        plain = run(plain_eng)
        monkeypatch.setenv("REPRO_SANITIZE", "1")
        eng = _engine(t_api.compile(olmo[1], **opts), olmo)
        jeng = JEngine(j_api.compile(olmo[0], verify=False, **opts), 2, params=olmo[2])
        assert isinstance(eng._lock, S._TrackedLock)
        assert run(eng) == run(jeng) == plain
        assert S.runtime_findings() == () and JS.runtime_findings() == ()
        alloc = eng.session.allocator
        assert alloc.shadow.findings == [] and alloc.shadow.audit(alloc) == []
        assert alloc.shadow.snapshot() == jeng.session.allocator.shadow.snapshot()
        assert eng.audit_sharing(source="sanitizer") == []
        if prefix_cache:
            assert eng.stats.prefix_hits > 0


# ---------------------------------------------------------------------------
# bounded interleaving model checks
# ---------------------------------------------------------------------------


class TestInterleavings:
    def test_clean_protocols_verify(self):
        assert check_interleavings() == [] == JS.check_interleavings()

    @pytest.mark.parametrize("bug", ["skip_cow", "double_free", "drop_ref"])
    def test_seeded_block_protocol_bugs_caught(self, bug):
        diags = check_block_interleavings(bug=bug)
        assert diags and all(d.rule == "SCHED001" for d in diags)
        assert all("schedule" in d.hint for d in diags)  # trace attached
        assert _asdicts(diags) == _asdicts(JS.check_block_interleavings(bug=bug))

    @pytest.mark.parametrize("bug", ["cancel_direct", "admit_keeps_queued"])
    def test_seeded_scheduler_protocol_bugs_caught(self, bug):
        diags = check_scheduler_interleavings(bug=bug)
        assert diags and all(d.rule == "SCHED001" for d in diags)
        assert _asdicts(diags) == _asdicts(JS.check_scheduler_interleavings(bug=bug))

    def test_state_bound_truncates_with_a_warning(self):
        diags = S.model_check(0, [[("inc", lambda s: s + 1)] * 3] * 2,
                              lambda s: None, name="tiny", max_states=2)
        assert [(d.rule, d.severity) for d in diags] == [("SCHED001", "warning")]
        assert _asdicts(diags) == _asdicts(JS.model_check(
            0, [[("inc", lambda s: s + 1)] * 3] * 2, lambda s: None, name="tiny",
            max_states=2))


# ---------------------------------------------------------------------------
# stats snapshot + /v1/stats sanitize section
# ---------------------------------------------------------------------------


class TestStatsSnapshot:
    def test_snapshot_is_independent_copy(self, paged_model, olmo):
        eng = _engine(paged_model, olmo)
        eng.submit(_prompts(olmo[0], 1)[0], 2)
        while not eng.idle:
            eng.step()
        snap = eng.stats_snapshot()
        n = len(snap.step_times_s)
        eng.submit(_prompts(olmo[0], 1, seed=1)[0], 2)
        while not eng.idle:
            eng.step()
        assert len(snap.step_times_s) == n  # later steps don't leak in
        assert len(eng.stats.step_times_s) > n

    def test_stats_payload_sanitize_section_equals_reference(self, paged_model,
                                                             j_paged_model, olmo,
                                                             sanitize_on):
        from repro.deploy.serving.async_engine import AsyncEngine as JAsyncEngine
        from repro.deploy.serving.frontend import _stats_payload as j_payload
        from repro_torch.deploy.serving.async_engine import AsyncEngine
        from repro_torch.deploy.serving.frontend import _stats_payload

        prompt = _prompts(olmo[0], 1)[0]
        with AsyncEngine(paged_model, 2, qp=olmo[3], device="cpu") as eng:
            eng.submit(prompt, 2).result(timeout=300)
            payload = _stats_payload(eng)
        with JAsyncEngine(j_paged_model, 2, params=olmo[2]) as jeng:
            jeng.submit(prompt, 2).result(timeout=300)
            want = j_payload(jeng)
        sz = payload["sanitize"]
        assert sz == want["sanitize"] == {"enabled": True, "lockdep_findings": 0,
                                          "shadow_findings": 0, "audit_findings": 0}

    def test_stats_payload_counts_the_shadow_pools_own_findings(self, paged_model, olmo,
                                                                sanitize_on):
        from repro_torch.deploy.serving.async_engine import AsyncEngine
        from repro_torch.deploy.serving.frontend import _stats_payload

        with AsyncEngine(paged_model, 2, qp=olmo[3], device="cpu") as eng:
            eng.submit(_prompts(olmo[0], 1)[0], 2).result(timeout=300)
            alloc = eng.engine.session.allocator
            alloc._ref[1] = 7  # tamper: the audit records a BLK004 finding
            diags = alloc.shadow.audit(alloc)
            del alloc._ref[1]
            assert _stats_payload(eng)["sanitize"]["shadow_findings"] == len(diags) > 0

    def test_engine_audit_sharing_carries_the_source(self, paged_model, olmo):
        from repro_torch.deploy.verify import PlanVerificationError

        eng = _engine(paged_model, olmo)
        eng.submit(_prompts(olmo[0], 1)[0], 8)
        eng.step()  # admitted and decoding: its blocks are live
        alloc = eng.session.allocator
        blk = min(alloc._ref)
        alloc._ref[blk] += 1  # drift the audit must see
        with pytest.raises(PlanVerificationError) as ei:
            eng.audit_sharing(source="sanitizer")
        alloc._ref[blk] -= 1
        assert ei.value.diagnostics and all(d.source == "sanitizer"
                                            for d in ei.value.diagnostics)
        assert "engine.audit_sharing[sanitizer]" in str(ei.value)
        assert eng.stats.audit_findings == len(ei.value.diagnostics)

    def test_audit_source_tag(self, paged_model, olmo, sanitize_on):
        from repro_torch.deploy.verify import verify_sharing

        sess = _session(paged_model, olmo)
        sess.prefill_slot(0, np.arange(SEQ, dtype=np.int32)[None] % 50)
        assert verify_sharing(sess.sharing_state()) == []
        state = sess.sharing_state(index_blocks=(99,))  # out-of-range pin
        diags = verify_sharing(state, source="sanitizer")
        assert diags and all(d.source == "sanitizer" for d in diags)
        assert "[source=sanitizer]" in diags[0].format()
        assert all(d.source == "audit"
                   for d in verify_sharing(state))  # the default tag


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.deploy.sanitize
# ---------------------------------------------------------------------------


class TestCLI:
    def test_repo_default_run_is_clean(self, capsys):
        assert S.main(["--strict", "--interleavings"]) == 0
        assert "OK — 0 error(s), 0 warning(s)" in capsys.readouterr().out

    @pytest.mark.parametrize("name,rc", [("cycle", 1), ("undeclared", 0)])
    def test_rc_and_output_equal_reference(self, tmp_path, capsys, name, rc):
        f = tmp_path / f"{name}.py"
        f.write_text(SOURCES[name])
        assert S.main([str(f)]) == rc
        got = capsys.readouterr().out
        assert JS.main([str(f)]) == rc
        assert got == capsys.readouterr().out
        if name == "undeclared":  # a warning fails only under --strict
            assert S.main([str(f), "--strict"]) == 1

    def test_rc2_on_unparseable_file(self, tmp_path, capsys):
        f = tmp_path / "broken.py"
        f.write_text("def broken(:\n")
        assert S.main([str(f)]) == 2
        assert "cannot analyze" in capsys.readouterr().err

    def test_module_entry_point_imports_no_jax(self):
        code = ("import runpy, sys, json\n"
                "sys.argv = ['sanitize', '--interleavings']\n"
                "try:\n"
                "    runpy.run_module('repro_torch.deploy.sanitize', run_name='__main__')\n"
                "except SystemExit as e:\n"
                "    rc = e.code\n"
                "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
                "       or m == 'repro' or m.startswith('repro.')]\n"
                "print(json.dumps([rc, bad]))\n")
        res = subprocess.run([sys.executable, "-W", "ignore", "-c", code],
                             capture_output=True, text=True, timeout=120,
                             env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
        assert res.returncode == 0, res.stderr
        lines = res.stdout.strip().splitlines()
        assert lines[-2].endswith("OK — 0 error(s), 0 warning(s)")
        assert json.loads(lines[-1]) == [0, []]


# ---------------------------------------------------------------------------
# AsyncEngine thread stress under the sanitizer
# ---------------------------------------------------------------------------


class TestAsyncStress:
    def test_submit_cancel_drain_stress(self, paged_model, olmo, sanitize_on):
        from repro_torch.deploy.serving.async_engine import AsyncEngine

        prompts = _prompts(olmo[0], 6)
        with AsyncEngine(paged_model, 2, qp=olmo[3], device="cpu") as eng:
            assert isinstance(eng._cv, S._TrackedCondition)
            handles, errs = [], []

            def client(lo, hi, cancel_every):
                try:
                    for i in range(lo, hi):
                        h = eng.submit(prompts[i], 4)
                        handles.append(h)
                        if i % cancel_every == 0:
                            h.cancel()
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    errs.append(e)

            ts = [threading.Thread(target=client, args=(0, 3, 2)),
                  threading.Thread(target=client, args=(3, 6, 3))]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            assert not errs, errs
            eng.drain(timeout=600)
            for h in handles:
                assert h.done
        assert S.runtime_findings() == ()
        alloc = eng.engine.session.allocator
        assert alloc.shadow.findings == []
        assert alloc.shadow.audit(alloc) == []

    def test_hypothesis_interleaving_stress(self, paged_model, olmo):
        pytest.importorskip("hypothesis", reason="property stress needs hypothesis")
        from hypothesis import given, settings
        from hypothesis import strategies as st

        from repro_torch.deploy.serving.async_engine import AsyncEngine

        prompts = _prompts(olmo[0], 4)

        @settings(max_examples=3, deadline=60_000)
        @given(cancels=st.lists(st.booleans(), min_size=4, max_size=4),
               gens=st.lists(st.integers(1, 4), min_size=4, max_size=4))
        def run(cancels, gens):
            os.environ["REPRO_SANITIZE"] = "1"
            try:
                S.reset_runtime()
                with AsyncEngine(paged_model, 2, qp=olmo[3], device="cpu") as eng:
                    hs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
                    for h, c in zip(hs, cancels):
                        if c:
                            h.cancel()
                    eng.drain(timeout=600)
                assert S.runtime_findings() == ()
                alloc = eng.engine.session.allocator
                assert alloc.shadow.findings == []
            finally:
                os.environ.pop("REPRO_SANITIZE", None)

        run()


# ---------------------------------------------------------------------------
# the CI twins, plain and sanitized
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sanitized", [False, True], ids=["plain", "sanitized"])
@pytest.mark.parametrize("script", ["torch_smoke_async_serving.py",
                                    "torch_smoke_prefix_cache.py"])
def test_ci_twin_runs(script, sanitized):
    env = {k: v for k, v in os.environ.items() if k != "REPRO_SANITIZE"}
    env["PYTHONPATH"] = str(ROOT / "src")
    if sanitized:
        env["REPRO_SANITIZE"] = "1"
    res = subprocess.run([sys.executable, str(ROOT / "ci" / script), "--device", "cpu"],
                         capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr
    tag = " [REPRO_SANITIZE=1] on cpu" if sanitized else " on cpu"
    assert tag in res.stdout, res.stdout


# ---------------------------------------------------------------------------
# --sanitize on the entry points
# ---------------------------------------------------------------------------


def test_sanitize_flag_helpers(monkeypatch):
    import argparse

    from repro_torch.launch import cli

    monkeypatch.setenv("REPRO_SANITIZE", "0")  # restored after the test
    ap = argparse.ArgumentParser()
    cli.add_sanitize_args(ap)
    cli.apply_sanitize_args(ap.parse_args([]))
    assert not S.enabled()
    cli.apply_sanitize_args(ap.parse_args(["--sanitize"]))
    assert os.environ["REPRO_SANITIZE"] == "1" and S.enabled()


def test_serve_sanitize_streams_the_unsanitized_tokens(monkeypatch, capsys):
    """``serve --sanitize`` turns the switch on before the engine exists
    and streams what the unsanitized run streams, with no finding."""
    from repro_torch.launch import serve

    monkeypatch.setenv("REPRO_SANITIZE", "0")  # restored after the test
    argv = ["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--no-plan-cache",
            "--prompt-len", "8", "--gen", "3", "--batch", "2", "--backend", "w8a8",
            "--requests", "4", "--kv-block-size", "4"]
    plain = serve.main(argv)
    sanitized = serve.main(argv + ["--sanitize"])
    assert os.environ["REPRO_SANITIZE"] == "1"
    assert sanitized["tokens"] == plain["tokens"] and S.runtime_findings() == ()
    assert sanitized["blocks_free"] == plain["blocks_free"]


def test_serving_main_sanitize_reports_in_stats():
    """``python -m repro_torch.deploy.serving --sanitize``: ``/v1/stats``
    reports the sanitizer on, with no lockdep and no shadow finding."""
    from repro_torch.launch.cli import http_generate, http_get_json, synthesize_prompts

    env = {k: v for k, v in os.environ.items() if k != "REPRO_SANITIZE"}
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.deploy.serving", "--reduced", "--device",
         "cpu", "--no-plan-cache", "--port", "0", "--batch", "2", "--prompt-len", "8",
         "--backend", "w8a8", "--kv-block-size", "4", "--sanitize"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        line = ""
        while "http://" not in line:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, "the server exited"
        host, port = line.split("http://")[1].split()[0].split(":")
        prompt = synthesize_prompts(512, n=1, prompt_len=8)[0]
        events = list(http_generate(host, int(port), prompt, 3, timeout=120))
        assert events[-1]["done"] and len(events[-1]["tokens"]) == 3
        stats = http_get_json(host, int(port), "/v1/stats")
        assert stats["sanitize"] == {"enabled": True, "lockdep_findings": 0,
                                     "shadow_findings": 0, "audit_findings": 0}
    finally:
        proc.send_signal(2)  # SIGINT: drain and exit
        try:
            proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0
