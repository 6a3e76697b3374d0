"""The port's paged KV region against the JAX package, bit for bit.

Cases of the reference's ``tests/test_paged.py`` (``TestPagedArtifact``,
``TestPagedBitExact``, the session half of ``TestPoolExhaustion`` and
``TestBlockAllocator``), each holding the port's session against the
reference's session step by step — logits, pools, depths and block
tables — plus the paged runners on tables with scratch and stale blocks
and at a pool width that ``block_k`` does not divide.

The same numpy ints go into both packages (the JAX side's quantized
params, carried by ``repro_torch.convert``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core.heterogeneous import DEFAULT_TABLE as J_TABLE
from repro.core.heterogeneous import Backend as JBackend
from repro.core.heterogeneous import Engine as JEngine
from repro.deploy import api as j_api
from repro.deploy.plan import DecoderPlanPair as JPair
from repro.models import transformer as JT
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import from_jax_quantized
from repro_torch.core.heterogeneous import DEFAULT_TABLE as T_TABLE
from repro_torch.core.heterogeneous import Backend as TBackend
from repro_torch.core.heterogeneous import Engine as TEngine
from repro_torch.deploy import api as t_api
from repro_torch.deploy.memory import kv_pool_bytes
from repro_torch.deploy.paging import (
    SCRATCH_BLOCK,
    BlockAllocator,
    PoolExhausted,
    blocks_for_rows,
    blocks_per_slot,
    chunk_starts,
    pool_rows,
)
from repro_torch.deploy.plan import DecoderPlanPair as TPair
from repro_torch.models import transformer as TT

SEQ = 8
MAX_LEN = 40
BLOCK = 4


@pytest.fixture(scope="module")
def olmo():
    cfg, tcfg = reduced(get_config("olmo-1b")), t_reduced(t_get_config("olmo-1b"))
    params = JT.init_params(cfg, jax.random.PRNGKey(7))
    qp = JT.quantize_params(cfg, params)
    return cfg, tcfg, params, qp, from_jax_quantized(jax.tree.map(np.asarray, qp))


def _opts(backend="w8a8", *, max_len=MAX_LEN, kv_blocks=14, kv_block_size=BLOCK, **kw):
    return dict(backend=backend, seq_len=SEQ, max_len=max_len, kv_block_size=kv_block_size,
                kv_blocks=kv_blocks, use_cache=False, **kw)


def _sessions(olmo, batch=2, **kw):
    """The reference's paged session and the port's, on the same ints."""
    cfg, tcfg, params, _, tqp = olmo
    opts = _opts(**kw)
    js = j_api.compile(cfg, verify=False, **opts).session(batch, params=params)
    ts = t_api.compile(tcfg, **opts).session(batch, qp=tqp, device="cpu")
    return js, ts


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _same(js, ts, j_logits, t_logits, what):
    """Logits, pools, depths and block tables of both sessions."""
    assert np.array_equal(t_logits.numpy(), np.asarray(j_logits)), f"logits, {what}"
    for part in ("k", "v"):
        assert np.array_equal(ts.kv_pool[part].numpy(), np.asarray(js.kv_pool[part])), \
            f"{part} pool, {what}"
    assert list(ts.pos) == list(js.pos), what
    assert [ts.block_chain(b) for b in range(ts.batch_size)] == \
        [js.block_chain(b) for b in range(js.batch_size)], what
    assert ts.blocks_free == js.blocks_free and ts.cow_copies == js.cow_copies, what


def _greedy(cfg, logits):
    return np.asarray(jnp.argmax(jnp.asarray(np.asarray(logits))[:, -1, : cfg.vocab],
                                 axis=-1)).astype(np.int32)


# ---------------------------------------------------------------------------
# TestPagedArtifact
# ---------------------------------------------------------------------------


class TestPagedArtifact:
    @pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
    @pytest.mark.parametrize("backend", ["w8a8", "ita"])
    def test_olmo_paged_pair_equals_reference(self, backend, fuse):
        """Full OLMo-1B, the chip's paged shape: the same pair, node for node."""
        kw = dict(backend=backend, seq_len=128, max_len=272, kv_block_size=16, kv_blocks=145,
                  fuse=fuse, use_cache=False)
        want = j_api.compile(get_config("olmo-1b"), verify=False, **kw)
        got = t_api.compile(t_get_config("olmo-1b"), **kw)
        assert got.artifact.to_dict() == want.artifact.to_dict()
        assert got.fingerprint == want.fingerprint and got.options == want.options
        assert JPair.from_json(got.artifact.to_json()).to_dict() == want.artifact.to_dict()
        pre = got.artifact.prefill
        assert sum(n.kind == "gemm" and n.engine == "ita" for n in pre.flat_nodes()) == 112
        assert all(n.engine == "cluster" for n in got.artifact.decode.flat_nodes())

    @pytest.mark.parametrize("backend", ["w8a8", "ita"])
    def test_pool_shapes_offsets_and_roundtrip(self, olmo, backend):
        cfg, tcfg = olmo[:2]
        want = j_api.compile(cfg, verify=False, **_opts(backend)).artifact
        pair = t_api.compile(tcfg, **_opts(backend)).artifact
        assert pair.to_dict() == want.to_dict()
        assert pair.paged and pair.kv_blocks == 14 and pair.kv_block_size == BLOCK
        # pool tensors: persistent inputs of both phases at one static offset
        for name in pair.kv_tensors:
            a, b = pair.prefill.tensors[name], pair.decode.tensors[name]
            assert a.shape == (15, cfg.n_kv_heads, BLOCK, cfg.head_dim)
            assert (a.offset, a.size) == (b.offset, b.size)
            assert name in pair.prefill.inputs and name in pair.decode.inputs
        assert pair.kv_tensors == want.kv_tensors
        rt = TPair.from_dict(pair.to_dict())
        assert rt.to_dict() == pair.to_dict()
        assert rt.paged and rt.kv_tensors == pair.kv_tensors
        assert kv_pool_bytes(14, BLOCK, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers) == \
            2 * cfg.n_layers * cfg.n_kv_heads * pool_rows(14, BLOCK) * cfg.head_dim

    def test_option_validation(self, olmo):
        cfg, tcfg = olmo[:2]
        with pytest.raises(ValueError, match="pair"):
            t_api.compile(tcfg, seq_len=SEQ, kv_blocks=4, use_cache=False)
        with pytest.raises(ValueError, match="positive"):
            t_api.compile(tcfg, seq_len=SEQ, kv_block_size=0, kv_blocks=4, use_cache=False)
        enc = t_reduced(t_get_config("mobilebert"))
        with pytest.raises(ValueError, match="decoder"):
            t_api.compile(enc, kv_block_size=4, kv_blocks=4, use_cache=False)
        # paged options are part of the fingerprint: dense != paged
        dense = t_api.compile(tcfg, seq_len=SEQ, max_len=MAX_LEN, use_cache=False)
        paged = t_api.compile(tcfg, **_opts())
        assert dense.fingerprint != paged.fingerprint
        assert paged.fingerprint == j_api.compile(cfg, verify=False, **_opts()).fingerprint

    def test_broken_pool_is_refused(self, olmo):
        pair = t_api.compile(olmo[1], **_opts()).artifact
        d = pair.to_dict()
        d["prefill"]["kv_blocks"] = d["decode"]["kv_blocks"] = d["kv_blocks"] = 15
        with pytest.raises(ValueError, match="rows"):
            TPair.from_dict(d)


# ---------------------------------------------------------------------------
# TestPagedBitExact
# ---------------------------------------------------------------------------


class TestPagedBitExact:
    @pytest.mark.parametrize("backend", ["w8a8", "ita"])
    def test_decode_matches_dense_mixed_depths(self, olmo, backend):
        """Paged vs dense in the port, and the port's paged session vs the
        reference's step by step: mixed depths, mid-flight re-admission."""
        cfg, tcfg, params, _, tqp = olmo
        steps = 2 if backend == "ita" else 4
        dense = t_api.compile(tcfg, backend=backend, seq_len=SEQ, max_len=MAX_LEN,
                              use_cache=False).session(2, qp=tqp, device="cpu")
        js, ts = _sessions(olmo, backend=backend)
        toks = _tokens(cfg, (2, SEQ), seed=1)
        ld, jl, tl = dense.prefill(toks), js.prefill(jnp.asarray(toks)), ts.prefill(toks)
        assert torch.equal(ld, tl)
        _same(js, ts, jl, tl, "prefill")
        for step in range(steps):
            tok = _greedy(cfg, tl)
            ld, jl, tl = dense.decode(tok), js.decode(jnp.asarray(tok)), ts.decode(tok)
            assert torch.equal(ld, tl), step
            _same(js, ts, jl, tl, f"step {step}")
        # re-admit slot 0 mid-flight; slot 1 keeps decoding at its depth
        fresh = _tokens(cfg, (1, SEQ), seed=9)
        ld0, jl0, tl0 = (dense.prefill_slot(0, fresh), js.prefill_slot(0, jnp.asarray(fresh)),
                         ts.prefill_slot(0, fresh))
        assert torch.equal(ld0, tl0)
        _same(js, ts, jl0, tl0, "prefill_slot")
        assert list(ts.pos) == list(dense.pos) and len(set(ts.pos.tolist())) == 2
        tl = torch.cat([tl0, tl[1:]])
        for step in range(2):
            tok = _greedy(cfg, tl)
            ld, jl, tl = dense.decode(tok), js.decode(jnp.asarray(tok)), ts.decode(tok)
            assert torch.equal(ld, tl)
            _same(js, ts, jl, tl, f"after re-admission, step {step}")

    @pytest.mark.parametrize("long_len", [4 * SEQ, 4 * SEQ + 3])
    def test_chunked_prefill_bit_exact_vs_teacher_forcing(self, olmo, long_len):
        """A >= 4 x seq_len prompt through ``prefill_slot`` equals the model
        chain's prefill + teacher forcing and the reference session, chunk
        by chunk (the final chunk overlaps when the length is ragged)."""
        cfg, tcfg, _, _, tqp = olmo
        js, ts = _sessions(olmo)
        busy = _tokens(cfg, (2, SEQ), seed=2)
        _same(js, ts, js.prefill(jnp.asarray(busy)), ts.prefill(busy), "neighbours")
        long_toks = _tokens(cfg, (1, long_len), seed=5)
        rl, rc = TT.prefill_w8a8(tcfg, tqp, {"tokens": torch.from_numpy(long_toks[:, :SEQ])},
                                 MAX_LEN)
        for t in range(SEQ, long_len):
            rl, rc = TT.decode_step_w8a8(tcfg, tqp, rc, torch.from_numpy(long_toks[:, t: t + 1]))
        starts = chunk_starts(long_len, SEQ)
        assert len(starts) <= -(-long_len // SEQ)
        for start in starts:  # the chunks prefill_slot runs, one at a time
            chunk = long_toks[:, start: start + SEQ]
            jl = js.prefill_chunk(0, jnp.asarray(chunk), start)
            tl = ts.prefill_chunk(0, chunk, start)
            _same(js, ts, jl, tl, f"chunk at {start}")
        assert torch.equal(tl, rl) and int(ts.pos[0]) == long_len
        lg = ts.prefill_slot(0, long_toks)  # the same chunks again, from a release
        assert torch.equal(lg, rl)
        tok = _greedy(cfg, lg)
        tok2 = np.array([tok[0], 0], np.int32)
        jl2, tl2 = js.decode(jnp.asarray(tok2)), ts.decode(tok2)
        _same(js, ts, jl2, tl2, "decode after chunks")
        rl2, _ = TT.decode_step_w8a8(tcfg, tqp, rc, torch.from_numpy(tok[:1, None]))
        assert torch.equal(tl2[:1], rl2)

    def test_unfused_paged_pair_equals_fused(self, olmo):
        """The unfused paged plans run node by node and give the fused
        plans' ints (logits and pools)."""
        cfg, tcfg, _, _, tqp = olmo
        runs = []
        for fuse in (True, False):
            sess = t_api.compile(tcfg, **_opts(fuse=fuse)).session(2, qp=tqp, device="cpu")
            assert sess._pair.decode.fused == fuse
            out = [sess.prefill(_tokens(cfg, (2, SEQ), seed=3))]
            for _ in range(2):
                out.append(sess.decode(_greedy(cfg, out[-1])))
            runs.append(out + [sess.kv_pool["k"], sess.kv_pool["v"]])
        assert all(torch.equal(a, b) for a, b in zip(*runs))
        assert sess.decode_dispatch_count == len(sess._pair.decode.nodes)

    def test_batched_chunks_park_other_lanes(self, olmo):
        """``prefill_chunks``: one dispatch for two slots at different
        offsets, the third lane parked on scratch; equal to the reference."""
        cfg = olmo[0]
        js, ts = _sessions(olmo, batch=3, kv_blocks=20)
        prompts = _tokens(cfg, (3, 2 * SEQ), seed=6)
        first = {0: (prompts[0:1, :SEQ], 0), 2: (prompts[2:3, :SEQ], 0)}
        jl = js.prefill_chunks({k: (jnp.asarray(t), s) for k, (t, s) in first.items()})
        tl = ts.prefill_chunks(first)
        assert np.array_equal(tl.numpy()[[0, 2]], np.asarray(jl)[[0, 2]])
        _same(js, ts, jl[jnp.asarray([0, 2])], tl[[0, 2]], "first chunks")
        second = {0: (prompts[0:1, SEQ:], SEQ), 1: (prompts[1:2, :SEQ], 0)}
        jl = js.prefill_chunks({k: (jnp.asarray(t), s) for k, (t, s) in second.items()})
        tl = ts.prefill_chunks(second)
        _same(js, ts, jl[:2], tl[:2], "mixed offsets")
        assert list(ts.pos) == [2 * SEQ, SEQ, SEQ]
        tok = _greedy(cfg, tl)
        act = np.array([True, False, True])
        jl, tl = js.decode(jnp.asarray(tok), active=act), ts.decode(tok, active=act)
        _same(js, ts, jl[jnp.asarray([0, 2])], tl[[0, 2]], "decode with a parked lane")
        assert list(ts.pos) == [2 * SEQ + 1, SEQ, SEQ + 1]


# ---------------------------------------------------------------------------
# TestPoolExhaustion (the session half)
# ---------------------------------------------------------------------------


class TestPoolExhaustion:
    def test_session_error_names_growers_and_evictable(self, olmo):
        cfg = olmo[0]
        # 5 blocks: two slots prefill into 2 blocks each (SEQ 8, BLOCK 4),
        # leaving 1 free; both cross a block boundary on the same step
        js, ts = _sessions(olmo, kv_blocks=5)
        toks = _tokens(cfg, (2, SEQ), seed=4)
        jl, tl = js.prefill(jnp.asarray(toks)), ts.prefill(toks)
        tok = _greedy(cfg, tl)
        errs = []
        for sess, t in ((js, jnp.asarray(tok)), (ts, tok)):
            with pytest.raises((j_api.KVCapacityError, t_api.KVCapacityError)) as ei:
                sess.decode(t)
            errs.append(ei.value)
        je, te = errs
        assert isinstance(te, t_api.KVCapacityError)
        assert te.reason == je.reason == "pool"
        assert te.slots == je.slots == (1,)  # slot order: slot 0 got the block
        assert te.evictable == je.evictable == (0,)
        assert str(te) == str(je) and "evictable" in str(te)
        _same(js, ts, jl, tl, "after the refused decode")
        js.free_slot(0)
        ts.free_slot(0)
        assert ts.blocks_free == js.blocks_free == 3

    def test_failed_batched_prefill_leaves_state_intact(self, olmo):
        cfg, tcfg, _, _, tqp = olmo
        js, ts = _sessions(olmo, kv_blocks=3)
        toks = _tokens(cfg, (1, SEQ), seed=6)
        jl, tl = js.prefill_slot(0, jnp.asarray(toks)), ts.prefill_slot(0, toks)
        big = _tokens(cfg, (2, SEQ), seed=7)
        with pytest.raises(t_api.KVCapacityError, match="pool"):
            ts.prefill(big)
        with pytest.raises(j_api.KVCapacityError, match="pool"):
            js.prefill(jnp.asarray(big))
        assert int(ts.pos[0]) == SEQ and ts.blocks_held(0) == 2
        _same(js, ts, jl, tl, "after the refused prefill")
        rl, rc = TT.prefill_w8a8(tcfg, tqp, {"tokens": torch.from_numpy(toks)}, MAX_LEN)
        tok = _greedy(cfg, tl)
        step = np.array([tok[0], 0], np.int32)
        act = np.array([True, False])
        jl2, tl2 = js.decode(jnp.asarray(step), active=act), ts.decode(step, active=act)
        _same(js, ts, jl2[:1], tl2[:1], "decode of the survivor")
        rl2, _ = TT.decode_step_w8a8(tcfg, tqp, rc, torch.from_numpy(tok[:1, None]))
        assert torch.equal(tl2[:1], rl2)

    def test_max_len_and_chunk_checks(self, olmo):
        cfg = olmo[0]
        js, ts = _sessions(olmo, max_len=12, kv_blocks=8)
        toks = _tokens(cfg, (2, SEQ), seed=8)
        ts.prefill(toks)
        with pytest.raises(t_api.KVCapacityError, match="max_len") as ei:
            ts.decode(np.zeros(2, np.int32), pos=np.array([3, 12], np.int32))
        assert ei.value.slots == (1,) and ei.value.reason == "max_len"
        with pytest.raises(ValueError, match="gap"):
            ts.prefill_chunk(0, toks[:1], SEQ + 1)
        with pytest.raises(t_api.KVCapacityError):
            ts.prefill_chunk(0, toks[:1], SEQ)  # rows 8..16 pass max_len 12
        dense = t_api.compile(olmo[1], seq_len=SEQ, use_cache=False).session(
            2, qp=olmo[4], device="cpu")
        dense.prefill(toks)
        with pytest.raises(ValueError, match="active"):
            dense.decode(np.zeros(2, np.int32), active=[1, 1])
        with pytest.raises(RuntimeError, match="paged session"):
            dense.prefill_chunk(0, toks[:1], 0)


# ---------------------------------------------------------------------------
# TestBlockAllocator
# ---------------------------------------------------------------------------


class TestBlockAllocator:
    def test_deterministic_and_loud(self):
        a = BlockAllocator(4)
        got = a.allocate(2, owner=0)
        assert got == [1, 2] and a.n_free == 2  # 0 is scratch, never issued
        assert SCRATCH_BLOCK not in got
        with pytest.raises(PoolExhausted):
            a.allocate(3)
        assert a.n_free == 2  # a failed allocation mutates nothing
        a.free([1])
        assert a.allocate(1) == [1]  # lowest id first: reuse is deterministic
        with pytest.raises(ValueError, match="double free"):
            a.free([4, 4])
        with pytest.raises(ValueError):
            BlockAllocator(0)

    def test_chunk_starts_cover_and_bound(self):
        assert chunk_starts(8, 8) == [0]
        assert chunk_starts(32, 8) == [0, 8, 16, 24]
        assert chunk_starts(35, 8) == [0, 8, 16, 24, 27]  # overlapping tail
        for t in range(8, 64):
            starts = chunk_starts(t, 8)
            assert len(starts) <= -(-t // 8)
            assert starts[-1] == t - 8 and starts[0] == 0
            covered = set()
            for s in starts:
                covered.update(range(s, s + 8))
            assert covered == set(range(t))
        with pytest.raises(ValueError, match="shorter"):
            chunk_starts(4, 8)
        assert blocks_for_rows(9, 4) == 3
        assert blocks_per_slot(272, 16) == 17 and pool_rows(145, 16) == 146 * 16


# ---------------------------------------------------------------------------
# the paged runners: scratch and stale blocks, the block_k fallback
# ---------------------------------------------------------------------------


def _runners(kind):
    return (J_TABLE._lookup(kind, JEngine.CLUSTER, JBackend.W8A8),
            T_TABLE._lookup(kind, TEngine.CLUSTER, TBackend.W8A8))


#: (table, pos, block_k): slot tables with scratch entries (0) past the
#: valid rows and a stale block (7, rows from an earlier owner) inside the
#: gathered width; the last case's 3 x 4 rows are not a multiple of
#: block_k 8, so the runner falls back to one block of all 12 rows
RUNNER_CASES = [
    ([[3, 5, 0], [2, 7, 0]], [5, 2], 8),
    ([[3, 5, 0], [2, 7, 0]], [5, 2], 4),
    ([[3, 5, 6], [2, 7, 1]], [9, 3], 8),
    ([[4, 0, 0], [7, 0, 0]], [0, 3], 2048),
]


@pytest.mark.parametrize("table,pos,block_k", RUNNER_CASES,
                         ids=["scratch-stale-bk8", "scratch-stale-bk4", "fallback-bk8",
                              "decode-bk2048"])
@pytest.mark.parametrize("s", [1, 3])
def test_attn_paged_runner_equals_reference(table, pos, block_k, s):
    rng = np.random.default_rng(11)
    hkv, heads, d, bs = 2, 4, 8, 4
    k_pool = rng.integers(-128, 128, (8, hkv, bs, d)).astype(np.int8)
    v_pool = rng.integers(-128, 128, (8, hkv, bs, d)).astype(np.int8)
    q = rng.integers(-128, 128, (2, s, heads * d)).astype(np.int8)
    tab, p = np.asarray(table, np.int32), np.asarray(pos, np.int32)
    kw = dict(heads=heads, kv_heads=hkv, head_dim=d, s_act=0.05, s_out=0.05, block_k=block_k)
    j_fn, t_fn = _runners("attn_paged")
    want = j_fn(jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(p),
                jnp.asarray(tab), **kw)
    got = t_fn(torch.from_numpy(q), torch.from_numpy(k_pool), torch.from_numpy(v_pool), p,
               torch.from_numpy(tab), **kw)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # rows past each query's bound do not count: scribbling over them
    # (the scratch block, the stale block's tail) leaves the ints
    k2, v2 = k_pool.copy(), v_pool.copy()
    for b in range(2):
        for r in range(int(p[b]) + s, tab.shape[1] * bs):
            blk = tab[b, r // bs]
            if all(tab[o, (rr // bs)] != blk or rr >= int(p[o]) + s
                   for o in range(2) for rr in range(tab.shape[1] * bs)
                   if tab[o, rr // bs] == blk and (rr % bs) == (r % bs)):
                k2[blk, :, r % bs] = 99
                v2[blk, :, r % bs] = -99
    again = t_fn(torch.from_numpy(q), torch.from_numpy(k2), torch.from_numpy(v2), p,
                 torch.from_numpy(tab), **kw)
    assert torch.equal(again, got)


@pytest.mark.parametrize("active", [None, [True, False], [False, True]])
@pytest.mark.parametrize("s", [1, 5])
def test_cache_write_paged_runner_equals_reference(active, s):
    """One scatter through the table; an inactive lane writes the scratch
    block; a lane past its table (parked at any depth) does not fail."""
    rng = np.random.default_rng(12)
    hkv, d, bs = 2, 8, 4
    pool = rng.integers(-128, 128, (8, hkv, bs, d)).astype(np.int8)
    kv = rng.integers(-128, 128, (2, s, hkv * d)).astype(np.int8)
    tab = np.asarray([[3, 5, 6], [2, 7, 1]], np.int32)
    pos = np.asarray([2, 6], np.int32)
    kw = dict(kv_heads=hkv, head_dim=d, block_size=bs)
    j_fn, t_fn = _runners("cache_write_paged")
    act = None if active is None else np.asarray(active)
    want = np.asarray(j_fn(jnp.asarray(kv), jnp.asarray(pool), jnp.asarray(pos),
                           jnp.asarray(tab), None if act is None else jnp.asarray(act), **kw))
    t_pool = torch.from_numpy(pool.copy())
    got = t_fn(torch.from_numpy(kv), t_pool, pos, torch.from_numpy(tab), act, **kw)
    assert got.data_ptr() == t_pool.data_ptr()  # in place
    # the scratch block's rows are don't-care (repeated targets land there)
    assert np.array_equal(got.numpy()[1:], want[1:])
    if act is not None and not act.all():
        parked = torch.from_numpy(pool.copy())
        far = np.asarray([40, 40], np.int32)  # past the 3-block table
        t_fn(torch.from_numpy(kv), parked, far, torch.from_numpy(tab),
             np.zeros(2, bool), **kw)
        assert np.array_equal(parked.numpy()[1:], pool[1:])


@pytest.mark.parametrize("flags,blocks", [
    (["--kv-block-size", "4"], 2 * 5), (["--kv-block-size", "8", "--kv-blocks", "7"], 7),
], ids=["kv-block-size", "kv-blocks"])
def test_serve_paged_decoder_cli_on_cpu(capsys, flags, blocks):
    """The engine serves 2 requests of 16 tokens on 2 slots over the pool:
    one batched chunk for both, two decode steps, every block back in the
    pool at the end."""
    from repro_torch.launch import serve

    serve.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--no-plan-cache",
                "--prompt-len", "16", "--gen", "3", "--batch", "2", "--backend", "w8a8",
                "--requests", "2", "--extra-prompt", "0", *flags])
    out = capsys.readouterr().out
    size = int(flags[1])
    assert f"paged KV pool of {blocks} blocks of {size} rows" in out and "gen tok/s" in out
    # a slot's region is 16 + 3 + 1 rows; the default pool holds both slots'
    assert blocks >= 2 * blocks_for_rows(16 + 3 + 1, size)
    # both requests finished: the pool is whole again
    assert f"({blocks} free after the run)" in out and "2/2 requests done" in out
    assert "1 prefill dispatches" in out and "2 decode steps of 2 slots" in out


def test_serve_kv_blocks_needs_a_block_size():
    from repro_torch.launch import serve

    with pytest.raises(ValueError, match="pair"):
        serve.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--no-plan-cache",
                    "--prompt-len", "16", "--gen", "1", "--kv-blocks", "8"])
