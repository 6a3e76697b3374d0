"""Prefix sharing and copy-on-write paged KV in the port, against the JAX package.

Cases of the reference's ``tests/test_prefix.py`` (``TestAllocatorSharing``,
``TestPrefixIndex`` and ``TestSessionSharing``): the port's allocator and
radix index run the same operations as the reference's and must end in
the same state, and the port's session attaches, copies on write and
frees exactly as the reference's session does — logits, pools, block
chains and ``sharing_state()`` equal at every step.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config, reduced
from repro.deploy import api as j_api
from repro.deploy.paging import BlockAllocator as JAlloc
from repro.deploy.paging import PoolExhausted as JPoolExhausted
from repro.deploy.prefix import PrefixIndex as JIndex
from repro.deploy.verify import verify_sharing
from repro.models import transformer as JT
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import from_jax_quantized
from repro_torch.deploy import api as t_api
from repro_torch.deploy.paging import BlockAllocator, PoolExhausted, blocks_for_rows
from repro_torch.deploy.prefix import PrefixIndex, PrefixMatch
from repro_torch.deploy.verify import KVSharingState

ROOT = Path(__file__).resolve().parents[1]
SEQ = 8
MAX_LEN = 40
BLOCK = 4


@pytest.fixture(scope="module")
def olmo():
    cfg, tcfg = reduced(get_config("olmo-1b")), t_reduced(t_get_config("olmo-1b"))
    params = JT.init_params(cfg, jax.random.PRNGKey(7))
    qp = JT.quantize_params(cfg, params)
    return cfg, tcfg, params, from_jax_quantized(jax.tree.map(np.asarray, qp))


def _sessions(olmo, batch=2, kv_blocks=30, backend="w8a8"):
    cfg, tcfg, params, tqp = olmo
    opts = dict(backend=backend, seq_len=SEQ, max_len=MAX_LEN, kv_block_size=BLOCK,
                kv_blocks=kv_blocks, prefix_cache=True, use_cache=False)
    jm = j_api.compile(cfg, verify=False, **opts)
    tm = t_api.compile(tcfg, **opts)
    assert tm.fingerprint == jm.fingerprint and tm.options == jm.options
    return jm.session(batch, params=params), tm.session(batch, qp=tqp, device="cpu")


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (1, n)).astype(np.int32)


def _state(st) -> dict:
    return dataclasses.asdict(st)


def _same(js, ts, jl, tl, what):
    assert np.array_equal(tl.numpy(), np.asarray(jl)), f"logits, {what}"
    for part in ("k", "v"):
        assert np.array_equal(ts.kv_pool[part].numpy(), np.asarray(js.kv_pool[part])), \
            f"{part} pool, {what}"
    assert list(ts.pos) == list(js.pos), what
    assert _state(ts.sharing_state()) == _state(js.sharing_state()), what
    assert (ts.blocks_free, ts.cow_copies, ts.allocator.n_shared) == \
        (js.blocks_free, js.cow_copies, js.allocator.n_shared), what
    # the reference's KV-sharing audit passes on the port's snapshot
    assert verify_sharing(ts.sharing_state()) == []


def _alloc_state(a) -> tuple:
    return (a.n_free, a.n_used, a.n_shared,
            tuple(a.refcount(b) for b in range(1, a.n_blocks + 1)))


# ---------------------------------------------------------------------------
# TestAllocatorSharing: the same operations on both allocators
# ---------------------------------------------------------------------------


def _both(n):
    return JAlloc(n), BlockAllocator(n)


def _run(allocs, op, *args, **kw):
    """``op`` on both allocators: equal results, or the same error type."""
    outs = []
    for a in allocs:
        try:
            outs.append(("ok", getattr(a, op)(*args, **kw)))
        except (PoolExhausted, JPoolExhausted, ValueError) as e:
            outs.append(("err", type(e).__name__, str(e)))
    assert outs[0] == outs[1], (op, outs)
    assert _alloc_state(allocs[0]) == _alloc_state(allocs[1]), op
    return outs[1]


class TestAllocatorSharing:
    def test_fork_shares_and_free_decrements(self):
        allocs = _both(6)
        _, blocks = _run(allocs, "allocate", 3)
        assert [allocs[1].refcount(b) for b in blocks] == [1, 1, 1]
        assert _run(allocs, "fork", blocks[:2])[1] == blocks[:2]
        assert allocs[1].n_shared == 2 and allocs[1].n_free == 3
        _run(allocs, "free", blocks[:2])
        assert allocs[1].n_free == 3
        _run(allocs, "free", blocks)
        assert allocs[1].n_free == 6 and allocs[1].n_shared == 0
        assert _run(allocs, "allocate", 3)[1] == blocks  # deterministic reissue

    def test_fork_dead_block_is_loud_and_atomic(self):
        allocs = _both(4)
        (b,) = _run(allocs, "allocate", 1)[1]
        assert _run(allocs, "fork", [b, 99])[0] == "err"
        assert allocs[1].refcount(b) == 1

    def test_cow_exclusive_in_place_and_shared_copies(self):
        allocs = _both(4)
        (b,) = _run(allocs, "allocate", 1)[1]
        assert _run(allocs, "cow", b)[1] == (b, False)
        _run(allocs, "fork", [b])
        fresh, copied = _run(allocs, "cow", b)[1]
        assert copied and fresh != b and allocs[1].n_shared == 0 and allocs[1].n_free == 2

    def test_cow_exhausted_pool_is_loud_without_mutation(self):
        allocs = _both(1)
        (b,) = _run(allocs, "allocate", 1)[1]
        _run(allocs, "fork", [b])
        assert _run(allocs, "cow", b)[:2] == ("err", "PoolExhausted")
        assert allocs[1].refcount(b) == 2

    def test_double_free_still_loud(self):
        allocs = _both(2)
        (b,) = _run(allocs, "allocate", 1)[1]
        _run(allocs, "free", [b])
        out = _run(allocs, "free", [b])
        assert out[0] == "err" and "double free" in out[2]


# ---------------------------------------------------------------------------
# TestPrefixIndex: the same operations on both indexes
# ---------------------------------------------------------------------------


def _indexes(n_blocks=12):
    return JIndex(JAlloc(n_blocks), BLOCK), PrefixIndex(BlockAllocator(n_blocks), BLOCK)


def _match(idx, toks):
    m = idx.match(toks)
    return m.blocks, m.rows, m.full, None if m.logits is None else m.logits.tolist()


def _idx_same(jx, tx, probes=()):
    assert _alloc_state(jx._alloc) == _alloc_state(tx._alloc)
    assert jx.pinned_blocks() == tx.pinned_blocks() and jx.n_blocks == tx.n_blocks
    assert jx.reclaimable() == tx.reclaimable()
    for p in probes:
        assert _match(jx, p) == _match(tx, p), p


class TestPrefixIndex:
    def test_empty_index_misses(self):
        jx, tx = _indexes()
        m = tx.match(list(range(10)))
        assert m == PrefixMatch((), 0) and not m.hit
        assert _match(jx, list(range(10))) == _match(tx, list(range(10)))

    def test_insert_then_full_and_partial_match(self):
        jx, tx = _indexes()
        toks = list(range(10))  # 2 full blocks + a 2-row tail
        logits = np.arange(8, dtype=np.float32)
        for x in (jx, tx):
            chain = x._alloc.allocate(blocks_for_rows(10, BLOCK))
            assert x.insert(toks, chain, logits) == 3
        assert [tx._alloc.refcount(b) for b in chain] == [2, 2, 2]
        full = tx.match(toks)
        assert full.full and full.rows == 10 and full.blocks == tuple(chain)
        part = tx.match(toks + [77, 78])
        assert not part.full and part.rows == 8 and part.blocks == tuple(chain[:2])
        assert not tx.match([99] * 10).hit
        _idx_same(jx, tx, [toks, toks + [77, 78], [99] * 10, toks[:8], toks[:5]])

    def test_insert_validates_chain_and_logits(self):
        tx = _indexes()[1]
        chain = tx._alloc.allocate(2)
        with pytest.raises(ValueError, match="chain"):
            tx.insert(list(range(10)), chain, np.zeros(4))
        with pytest.raises(ValueError, match="logits"):
            tx.insert(list(range(8)), chain, None)
        with pytest.raises(ValueError, match="empty"):
            tx.insert([], [], np.zeros(4))

    def test_duplicate_insert_keeps_incumbents(self):
        jx, tx = _indexes()
        toks = list(range(8))
        for x in (jx, tx):
            first = x._alloc.allocate(2)
            x.insert(toks, first, np.zeros(4))
            second = x._alloc.allocate(2)
            assert x.insert(toks, second, np.ones(4)) == 0
        assert tx.match(toks).blocks == tuple(first)
        _idx_same(jx, tx, [toks])

    def test_reclaim_is_lru_and_respects_refcounts(self):
        jx, tx = _indexes()
        cold, hot = list(range(8)), list(range(100, 108))
        for x in (jx, tx):
            cold_chain = x._alloc.allocate(2)
            x.insert(cold, cold_chain, np.zeros(4))
            hot_chain = x._alloc.allocate(2)
            x.insert(hot, hot_chain, np.zeros(4))
            x._alloc.free(cold_chain)
            x._alloc.free(hot_chain)
            x.match(hot)
        assert tx.reclaimable() == 4
        assert tx.reclaim(1) == jx.reclaim(1) >= 1
        assert not tx.match(cold).full and tx.match(hot).full
        _idx_same(jx, tx, [cold, hot])
        for x in (jx, tx):
            x._alloc.fork([x.match(hot).blocks[0]])
        assert tx.reclaim() == jx.reclaim() >= 1
        m = tx.match(hot)
        assert not m.full and m.rows == 4
        _idx_same(jx, tx, [cold, hot])

    def test_reclaim_protect_guard_and_drop_all(self):
        jx, tx = _indexes()
        for x in (jx, tx):
            chain = x._alloc.allocate(2)
            x.insert(list(range(8)), chain, np.zeros(4))
            x._alloc.free(chain)
        assert tx.reclaim(protect=chain) == jx.reclaim(protect=chain) == 0
        assert tx.reclaim() == jx.reclaim() == 2
        assert tx._alloc.n_free == tx._alloc.n_blocks
        for x in (jx, tx):
            chain = x._alloc.allocate(3)
            x.insert(list(range(10)), chain, np.zeros(4))
            x._alloc.free(chain)
        assert tx.drop_all() == jx.drop_all() == 3
        assert tx._alloc.n_free == tx._alloc.n_blocks and tx.n_blocks == 0
        _idx_same(jx, tx)


# ---------------------------------------------------------------------------
# TestSessionSharing: attach_prefix + copy-on-write before any shared write
# ---------------------------------------------------------------------------


class TestSessionSharing:
    @pytest.mark.parametrize("backend", ["w8a8", "ita"])
    def test_attach_cow_isolates_siblings_bit_exactly(self, olmo, backend):
        """Slot 1 attaches slot 0's chain over 10 rows (2 full blocks and a
        half-filled tail); both then decode: each write into the shared
        tail copies it first, and both sessions agree at every step."""
        cfg = olmo[0]
        js, ts = _sessions(olmo, kv_blocks=12, backend=backend)
        prompt = _tokens(cfg, SEQ + 2, seed=11)
        for c, start in ((prompt[:, :SEQ], 0), (prompt[:, 2:], 2)):
            jl, tl = js.prefill_chunk(0, jnp.asarray(c), start), ts.prefill_chunk(0, c, start)
            _same(js, ts, jl, tl, f"chunk at {start}")
        chain = ts.block_chain(0)
        assert chain == js.block_chain(0) and len(chain) == blocks_for_rows(SEQ + 2, BLOCK)
        js.attach_prefix(1, chain, SEQ + 2)
        ts.attach_prefix(1, chain, SEQ + 2)
        assert ts.block_chain(1) == chain and int(ts.pos[1]) == SEQ + 2
        assert ts.allocator.n_shared == len(chain)
        _same(js, ts, jl, tl, "attach")
        nxt = int(np.argmax(tl.numpy()[0, -1, : cfg.vocab]))
        step = np.asarray([[nxt], [nxt]], np.int32)
        before = ts.cow_copies
        jl2, tl2 = js.decode(jnp.asarray(step)), ts.decode(step)
        assert ts.cow_copies > before and ts.allocator.n_shared < len(chain)
        # both lanes read identical context: identical logits rows
        assert np.array_equal(tl2.numpy()[0], tl2.numpy()[1])
        _same(js, ts, jl2, tl2, "decode into the shared tail")
        held, free_before = ts.blocks_held(1), ts.blocks_free
        js.free_slot(1)
        ts.free_slot(1)
        assert ts.blocks_free < free_before + held  # the shared blocks stayed live
        _same(js, ts, jl2, tl2, "free of the sharer")
        # the donor's next step is untouched by its sibling's history
        tok = np.asarray([[int(np.argmax(tl2.numpy()[0, -1, : cfg.vocab]))], [0]], np.int32)
        act = np.array([True, False])
        jl3, tl3 = js.decode(jnp.asarray(tok), active=act), ts.decode(tok, active=act)
        _same(js, ts, jl3[:1], tl3[:1], "donor after the sibling left")

    def test_shared_tail_chunk_equals_unshared_prefill(self, olmo):
        """A prompt that shares 10 rows with a resident one attaches them and
        prefills only its tail chunk (which overlaps, and so copies, the
        shared blocks): its logits equal the same prompt prefilled unshared."""
        cfg = olmo[0]
        js, ts = _sessions(olmo, batch=3, kv_blocks=16)
        donor = _tokens(cfg, 2 * SEQ, seed=13)
        other = donor.copy()
        other[:, SEQ + 2:] = _tokens(cfg, SEQ - 2, seed=14)
        for sess, conv in ((js, jnp.asarray), (ts, lambda a: a)):
            sess.prefill_slot(0, conv(donor))
        unshared_j, unshared_t = js.prefill_slot(2, jnp.asarray(other)), ts.prefill_slot(2, other)
        js.attach_prefix(1, js.block_chain(0)[:3], SEQ + 2)
        ts.attach_prefix(1, ts.block_chain(0)[:3], SEQ + 2)
        jl = js.prefill_chunk(1, jnp.asarray(other[:, SEQ:]), SEQ)
        tl = ts.prefill_chunk(1, other[:, SEQ:], SEQ)
        assert np.array_equal(tl.numpy(), unshared_t.numpy())
        assert np.array_equal(np.asarray(unshared_j), unshared_t.numpy())
        _same(js, ts, jl, tl, "shared tail chunk")
        # rows SEQ..SEQ+2 of block 2 were shared: one copy on write
        assert ts.cow_copies == 1 and ts.block_chain(1)[:2] == ts.block_chain(0)[:2]

    def test_attach_validations(self, olmo):
        cfg = olmo[0]
        ts = _sessions(olmo, kv_blocks=8)[1]
        ts.prefill_chunk(0, _tokens(cfg, SEQ, seed=3), 0)
        chain = ts.block_chain(0)
        with pytest.raises(RuntimeError, match="live slot"):
            ts.attach_prefix(0, chain, SEQ)
        with pytest.raises(ValueError):
            ts.attach_prefix(1, chain, SEQ + 1)  # chain/rows mismatch
        with pytest.raises(ValueError, match="not allocated"):
            ts.attach_prefix(1, [7, 8], SEQ)
        dense = t_api.compile(olmo[1], seq_len=SEQ, use_cache=False).session(
            1, qp=olmo[3], device="cpu")
        with pytest.raises(RuntimeError, match="paged session"):
            dense.attach_prefix(0, chain, SEQ)
        with pytest.raises(RuntimeError, match="paged session"):
            dense.sharing_state()
        assert dense.blocks_free == 0 and dense.kv_pool is None and dense.allocator is None

    def test_evictable_excludes_all_shared_slots(self, olmo):
        cfg = olmo[0]
        js, ts = _sessions(olmo, batch=3, kv_blocks=4)
        prompt = _tokens(cfg, SEQ, seed=5)
        for sess, conv in ((js, jnp.asarray), (ts, lambda a: a)):
            sess.prefill_chunk(0, conv(prompt), 0)
            sess.attach_prefix(1, sess.block_chain(0), SEQ)  # an all-shared slot
            sess.prefill_chunk(2, conv(prompt), 0)
        assert ts.blocks_free == 0
        errs = []
        for sess, t in ((js, jnp.asarray([[1], [1], [1]], jnp.int32)),
                        (ts, np.asarray([[1], [1], [1]], np.int32))):
            with pytest.raises((j_api.KVCapacityError, t_api.KVCapacityError)) as ei:
                sess.decode(t, active=np.asarray([True, False, False]))
            errs.append(ei.value)
        je, te = errs
        assert te.reason == "pool" and te.slots == je.slots == (0,)
        assert te.evictable == je.evictable == (2,)  # slot 1 shares all it holds
        assert _state(ts.sharing_state()) == _state(js.sharing_state())


def test_compile_prefix_cache_options(olmo):
    cfg, tcfg = olmo[:2]
    kw = dict(seq_len=SEQ, max_len=MAX_LEN, kv_block_size=BLOCK, kv_blocks=30,
              use_cache=False)
    on = t_api.compile(tcfg, prefix_cache=True, **kw)
    off = t_api.compile(tcfg, **kw)
    assert on.fingerprint != off.fingerprint
    assert on.fingerprint == j_api.compile(cfg, prefix_cache=True, verify=False,
                                           **kw).fingerprint
    assert on.artifact.to_dict() == off.artifact.to_dict()  # no plan content changes
    with pytest.raises(ValueError, match="prefix_cache"):
        t_api.compile(tcfg, seq_len=SEQ, max_len=MAX_LEN, prefix_cache=True, use_cache=False)
    assert KVSharingState(n_blocks=1, refcounts={}, tables={}).writes == ()


def test_paging_modules_import_no_jax():
    """The new modules import nothing of JAX or of the JAX package."""
    code = (
        "import sys, json\n"
        "import repro_torch.deploy.paging, repro_torch.deploy.prefix\n"
        "import repro_torch.deploy.verify, repro_torch.deploy.api\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print(json.dumps(bad))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout) == []
