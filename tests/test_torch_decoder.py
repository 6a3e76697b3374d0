"""The port's dense decoder flow against the JAX package, bit for bit.

* ``compile`` lowers OLMo-1B at full width to the same ``DecoderPlanPair``
  (JSON and fingerprint), on both backends, fused and unfused;
* on reduced OLMo (GQA 4/2, RoPE, SwiGLU, tied embeddings) the port's
  ``execute_prefill`` + chained ``execute_decode`` equal the JAX
  package's on ``w8a8`` and ``ita`` (Pallas in interpret mode), and the
  port's ``prefill_w8a8`` / ``decode_step_w8a8`` equal JAX's: logits, K
  and V caches and ``len`` at every step, tolerance zero;
* the session's [B] ``pos`` decode, ``prefill_slot`` and capacity check;
* the RoPE tables over every position below 32768;
* the padding of small products onto ``torch._int_mm``.

The same numpy ints go into both packages (the JAX side's quantized
params, carried by ``repro_torch.convert``).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.configs.base import ArchConfig
from repro.deploy import api as j_api
from repro.deploy.executor import execute_decode as j_decode
from repro.deploy.executor import execute_prefill as j_prefill
from repro.deploy.plan import DecoderPlanPair as JPair
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.convert import from_jax_quantized
from repro_torch.deploy import api as t_api
from repro_torch.deploy.executor import execute_decode as t_decode
from repro_torch.deploy.executor import execute_prefill as t_prefill
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.quant.qparams import int_mm_padded

SEQ, GEN = 16, 3
MAX_LEN = SEQ + GEN + 1


def _carry(qp):
    return from_jax_quantized(jax.tree.map(np.asarray, qp))


def _compile_both(cfg, tcfg, backend, seq_len, max_len, key=7):
    jm = j_api.compile(cfg, backend=backend, seq_len=seq_len, max_len=max_len,
                       use_cache=False, verify=False)
    weights, qp = jm.bind(key=jax.random.PRNGKey(key))
    tm = t_api.compile(tcfg, backend=backend, seq_len=seq_len, max_len=max_len,
                       use_cache=False)
    tqp = _carry(qp)
    tweights, _ = tm.bind(qp=tqp)
    return jm, weights, qp, tm, tweights, tqp


def _equal(got: torch.Tensor, want) -> bool:
    return np.array_equal(got.numpy(), np.asarray(want))


#: the JAX package's model chain, traced once per config and shape
_j_prefill_model = jax.jit(JT.prefill_w8a8, static_argnums=(0, 3))
_j_step_model = jax.jit(JT.decode_step_w8a8, static_argnums=0)


def _assert_chain(jm, weights, tm, tweights, tokens, backend, steps):
    """Plan prefill then ``steps`` chained decode steps in both packages:
    logits, K and V caches and ``len`` equal at every step."""
    pair = jm.artifact
    j_prefill_fn = jax.jit(lambda w, b: j_prefill(pair, w, b, backend=backend))
    j_decode_fn = jax.jit(lambda w, c, t: j_decode(pair, w, c, t, backend=backend))
    jl, jc = j_prefill_fn(weights, {"tokens": jnp.asarray(tokens)})
    tl, tc = t_prefill(tm.artifact, tweights, {"tokens": torch.from_numpy(tokens)},
                       backend=backend)
    for step in range(steps + 1):
        assert _equal(tl, jl), f"logits, step {step}"
        assert _equal(tc["k"], jc["k"]) and _equal(tc["v"], jc["v"]), f"cache, step {step}"
        assert int(tc["len"]) == int(jc["len"])
        if step == steps:
            break
        tok = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
        jl, jc = j_decode_fn(weights, jc, jnp.asarray(tok))
        # the port writes the cache it is given in place
        tl, tc = t_decode(tm.artifact, tweights, tc, torch.from_numpy(tok), backend=backend)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("backend", ["w8a8", "ita"])
def test_olmo_plan_pair_equals_reference(backend, fuse):
    """Full OLMo-1B (16 layers, d 2048): the same pair, node for node."""
    kw = dict(backend=backend, seq_len=128, max_len=160, fuse=fuse, use_cache=False)
    want = j_api.compile(get_config("olmo-1b"), verify=False, **kw)
    got = t_api.compile(t_get_config("olmo-1b"), **kw)
    assert got.kind == "decoder" and want.kind == "decoder"
    assert got.artifact.to_dict() == want.artifact.to_dict()
    assert got.fingerprint == want.fingerprint and got.options == want.options
    # the JSON schema is shared: the port's pair loads in the JAX package
    assert JPair.from_json(got.artifact.to_json()).to_dict() == want.artifact.to_dict()
    pre = got.artifact.prefill
    gemm_ita = sum(n.kind == "gemm" and n.engine == "ita" for n in pre.flat_nodes())
    assert gemm_ita == 112  # 7 GEMMs x 16 layers, at either granule
    assert all(n.engine == "cluster" for n in got.artifact.decode.flat_nodes())


def test_pair_save_load_and_plan_cache(tmp_path):
    cfg = t_reduced(t_get_config("olmo-1b"))
    kw = dict(seq_len=SEQ, max_len=MAX_LEN, cache_dir=str(tmp_path))
    first = t_api.compile(cfg, backend="ita", **kw)
    again = t_api.compile(cfg, backend="ita", **kw)
    assert not first.cache_hit and again.cache_hit
    assert again.artifact.to_dict() == first.artifact.to_dict()
    path = tmp_path / "pair.json"
    first.save(str(path))
    assert first.to_dict()["kind"] == "pair"
    loaded = t_api.CompiledModel.load(str(path), cfg)
    assert loaded.kind == "decoder"
    assert loaded.artifact.to_dict() == first.artifact.to_dict()


def test_compile_refuses_what_is_not_ported():
    cfg = t_reduced(t_get_config("olmo-1b"))
    # the paged region and prefix_cache are ported: what is left are the
    # reference's own option checks
    assert t_api.compile(cfg, kv_block_size=16, kv_blocks=8, use_cache=False).artifact.paged
    with pytest.raises(ValueError, match="prefix_cache needs a paged decoder"):
        t_api.compile(cfg, prefix_cache=True, use_cache=False)
    with pytest.raises(NotImplementedError, match="item 5"):
        t_api.compile(cfg, autotune=True, use_cache=False)
    with pytest.raises(ValueError, match="pair"):
        t_api.compile(cfg, kv_block_size=16, use_cache=False)
    moe = cfg.replace(name="dense-moe-probe", n_experts=4, top_k=2)
    with pytest.raises(t_api.UnsupportedFamilyError, match="n_experts=4"):
        t_api.compile(moe, use_cache=False)


# ---------------------------------------------------------------------------
# execution against the JAX package (reduced OLMo)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def olmo_w8a8():
    cfg, tcfg = reduced(get_config("olmo-1b")), t_reduced(t_get_config("olmo-1b"))
    return (cfg, tcfg) + _compile_both(cfg, tcfg, "w8a8", SEQ, MAX_LEN)


@pytest.mark.parametrize("backend", ["w8a8", "ita"])
def test_reduced_olmo_chain_equals_reference(backend, olmo_w8a8):
    """The fused plan pair: prefill + 3 chained decode steps."""
    cfg, tcfg = olmo_w8a8[:2]
    if backend == "w8a8":
        jm, weights, _, tm, tweights, _ = olmo_w8a8[2:]
    else:
        jm, weights, _, tm, tweights, _ = _compile_both(cfg, tcfg, "ita", SEQ, MAX_LEN, key=3)
    assert tm.artifact.to_dict() == jm.artifact.to_dict()
    tokens = np.random.default_rng(11).integers(0, cfg.vocab, (2, SEQ)).astype(np.int32)
    _assert_chain(jm, weights, tm, tweights, tokens, backend, GEN)


def test_model_chain_equals_reference(olmo_w8a8):
    """``prefill_w8a8`` / ``decode_step_w8a8`` of both packages, and the
    port's model chain leaves the cache it was given as it was."""
    cfg, tcfg, _, _, qp, _, _, tqp = olmo_w8a8
    tokens = np.random.default_rng(12).integers(0, cfg.vocab, (2, SEQ)).astype(np.int32)
    jl, jc = _j_prefill_model(cfg, qp, {"tokens": jnp.asarray(tokens)}, MAX_LEN)
    tl, tc = TT.prefill_w8a8(tcfg, tqp, {"tokens": torch.from_numpy(tokens)}, MAX_LEN)
    for step in range(GEN + 1):
        assert _equal(tl, jl) and _equal(tc["k"], jc["k"]) and _equal(tc["v"], jc["v"])
        assert int(tc["len"]) == int(jc["len"]) == SEQ + step
        if step == GEN:
            break
        tok = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
        before = tc["k"].clone()
        jl, jc = _j_step_model(cfg, qp, jc, jnp.asarray(tok))
        old = tc
        tl, tc = TT.decode_step_w8a8(tcfg, tqp, tc, torch.from_numpy(tok))
        assert torch.equal(old["k"], before) and int(old["len"]) == SEQ + step


def test_shape_only_qparams_bind_and_run():
    """``init_qparams`` (random int8 weights) binds onto the pair like
    quantized float params, and the plan equals the model chain on them."""
    tcfg = t_reduced(t_get_config("olmo-1b"))
    model = t_api.compile(tcfg, seq_len=SEQ, max_len=MAX_LEN, use_cache=False)
    qp = TT.init_qparams(tcfg, seed=3)
    weights, _ = model.bind(qp=qp)
    tokens = torch.randint(0, tcfg.vocab, (2, SEQ), generator=torch.Generator().manual_seed(4),
                           dtype=torch.int32)
    logits, cache = t_prefill(model.artifact, weights, {"tokens": tokens})
    want, want_cache = TT.prefill_w8a8(tcfg, qp, {"tokens": tokens}, MAX_LEN)
    assert torch.equal(logits, want) and torch.equal(cache["k"], want_cache["k"])
    assert logits.shape == (2, 1, tcfg.vocab_padded)


def test_unfused_pair_equals_fused(olmo_w8a8):
    cfg, tcfg, _, _, _, tm, tweights, _ = olmo_w8a8
    unfused = t_api.compile(tcfg, seq_len=SEQ, max_len=MAX_LEN, fuse=False, use_cache=False)
    assert tm.artifact.decode.fused and not unfused.artifact.decode.fused
    tokens = torch.from_numpy(
        np.random.default_rng(13).integers(0, cfg.vocab, (2, SEQ)).astype(np.int32))
    outs = []
    for model in (tm, unfused):
        logits, cache = t_prefill(model.artifact, tweights, {"tokens": tokens})
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        logits2, cache = t_decode(model.artifact, tweights, cache, tok)
        outs.append((logits, logits2, cache["k"].clone(), cache["v"].clone()))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("kw", [
    dict(qkv_bias=True, mlp="gelu", norm="layernorm", tie_embeddings=False),
    dict(mlp="swiglu", norm="rmsnorm", tie_embeddings=True, rope=False),
], ids=["qkv-bias-gelu-untied", "rmsnorm-norope-tied"])
def test_config_variants(kw):
    """Biased QKV slicing, the fused-GELU MLP, an untied LM head, no RoPE."""
    shape = dict(name="variant", family="dense", n_layers=2, d_model=128, n_heads=4,
                 n_kv_heads=2, head_dim=32, d_ff=256, vocab=512, max_seq=64, **kw)
    cfg, tcfg = ArchConfig(**shape), TArchConfig(**shape)
    jm, weights, qp, tm, tweights, tqp = _compile_both(cfg, tcfg, "w8a8", 12, 16, key=1)
    assert tm.artifact.to_dict() == jm.artifact.to_dict()
    if "bias" in str(kw):
        assert "lm_head" in tqp and "b_q" in tqp["layers"][0]["attn"]["wqkv"]
    tokens = np.random.default_rng(14).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    _assert_chain(jm, weights, tm, tweights, tokens, "w8a8", 2)


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------


def test_session_pos_vector_and_prefill_slot(olmo_w8a8):
    """Slots at different depths in one decode dispatch, each equal to its
    own lone trajectory in the JAX package; ``prefill_slot`` installs one
    slot and leaves the others' rows and depths untouched."""
    cfg, tcfg, _, _, qp, tm, _, tqp = olmo_w8a8
    rng = np.random.default_rng(15)
    session = tm.session(3, qp=tqp, device="cpu")
    prompts = rng.integers(0, cfg.vocab, (3, SEQ)).astype(np.int32)
    logits = session.prefill(torch.from_numpy(prompts))
    refs = [list(_j_prefill_model(cfg, qp, {"tokens": jnp.asarray(prompts[b : b + 1])},
                                 MAX_LEN)) for b in range(3)]
    for b in range(3):
        assert _equal(logits[b : b + 1], refs[b][0])
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    logits = session.decode(tok)
    for b in range(3):
        refs[b] = list(_j_step_model(cfg, qp, refs[b][1], jnp.asarray(tok[b : b + 1, None].numpy())))
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    k_before = session.kv_cache["k"].clone()
    new = rng.integers(0, cfg.vocab, (1, SEQ)).astype(np.int32)
    slot_logits = session.prefill_slot(2, torch.from_numpy(new))
    refs[2] = list(_j_prefill_model(cfg, qp, {"tokens": jnp.asarray(new)}, MAX_LEN))
    assert _equal(slot_logits, refs[2][0])
    assert torch.equal(session.kv_cache["k"][:, :2], k_before[:, :2])
    assert list(session.pos) == [SEQ + 1, SEQ + 1, SEQ]
    tok[2] = int(torch.argmax(slot_logits[0, -1]))

    for _ in range(2):
        pos = session.pos.copy()
        logits = session.decode(tok, pos)
        for b in range(3):
            refs[b] = list(_j_step_model(cfg, qp, refs[b][1],
                                         jnp.asarray(tok[b : b + 1, None].numpy())))
            assert _equal(logits[b : b + 1], refs[b][0])
            assert _equal(session.kv_cache["k"][:, b : b + 1], refs[b][1]["k"])
            assert _equal(session.kv_cache["v"][:, b : b + 1], refs[b][1]["v"])
        assert list(session.pos) == list(pos + 1)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def test_kv_capacity_error(olmo_w8a8):
    """The session bounds a write past ``max_len`` before it happens; a
    direct ``execute_decode`` past the region raises rather than clamping
    the write onto the last row as the reference's update does."""
    cfg, _, _, _, _, tm, tweights, tqp = olmo_w8a8
    session = tm.session(2, qp=tqp, device="cpu")
    logits = session.prefill(torch.zeros((2, SEQ), dtype=torch.int32))
    for _ in range(MAX_LEN - SEQ):  # fill the region exactly
        logits = session.decode(torch.argmax(logits[:, -1], dim=-1))
    full = session.kv_cache["k"].clone()
    with pytest.raises(t_api.KVCapacityError, match="KV region full") as err:
        session.decode(torch.zeros((2,), dtype=torch.int32))
    assert err.value.slots == (0, 1) and err.value.pos == (MAX_LEN, MAX_LEN)
    assert torch.equal(session.kv_cache["k"], full)
    with pytest.raises(t_api.KVCapacityError) as err:
        session.decode(torch.zeros((2,), dtype=torch.int32), pos=[3, MAX_LEN])
    assert err.value.slots == (1,)
    with pytest.raises((IndexError, RuntimeError)):
        t_decode(tm.artifact, tweights, {**session.kv_cache, "len": torch.tensor(MAX_LEN)},
                 torch.zeros((2, 1), dtype=torch.int32))


def test_session_guards_and_thread_affinity(olmo_w8a8):
    _, _, _, _, _, tm, _, tqp = olmo_w8a8
    session = tm.session(2, qp=tqp, device="cpu")
    with pytest.raises(RuntimeError, match="decode before prefill"):
        session.decode(torch.zeros((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="prefill tokens"):
        session.prefill(torch.zeros((2, SEQ + 1), dtype=torch.int32))
    with pytest.raises(RuntimeError, match="encoder method"):
        session.forward(torch.zeros((2, SEQ), dtype=torch.int32))
    with pytest.raises(IndexError):
        session.prefill_slot(5, torch.zeros((1, SEQ), dtype=torch.int32))
    assert session.seq_len == SEQ and session.max_len == MAX_LEN and session.kv_cache is None
    errors = []

    def other():
        try:
            session.prefill(torch.zeros((2, SEQ), dtype=torch.int32))
        except RuntimeError as e:
            errors.append(str(e))

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert errors and "bound to thread" in errors[0]
    session.rebind_thread()
    session.prefill(torch.zeros((2, SEQ), dtype=torch.int32))
    assert list(session.pos) == [SEQ, SEQ]


def test_decoder_session_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = t_api.compile(t_reduced(t_get_config("olmo-1b")), seq_len=SEQ, use_cache=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.session(2)


def test_serve_decoder_cli_on_cpu(capsys):
    """The engine serves 2 requests of 16 tokens on 2 slots: a prefill
    dispatch each, then one decode step of both for their second token."""
    serve.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--no-plan-cache",
                "--prompt-len", "16", "--gen", "2", "--batch", "2", "--backend", "w8a8",
                "--requests", "2", "--extra-prompt", "0"])
    out = capsys.readouterr().out
    assert "engine-serving [w8a8] olmo-1b on cpu" in out and "gen tok/s" in out
    assert "dense KV region of 19 rows a slot" in out  # 16 + 2 + 1
    assert "2/2 requests done" in out and "4 tokens in 1 decode dispatches" in out
    assert "2 prefill dispatches" in out and "1 decode steps of 2 slots" in out


# ---------------------------------------------------------------------------
# integer helpers
# ---------------------------------------------------------------------------

#: the one table entry where torch's float32 sin (on the CPU) and XLA's
#: round to different Q0.7 ints: position 27981, frequency 10000^(-0.625),
#: whose sin is 63.4999983 * 2^-7 (XLA gives 1 ulp below, rounding to 63)
ROPE_KNOWN = (27981, 0.625, "sin")


@pytest.mark.parametrize("head_dim", [32, 64, 128])
def test_rope_tables_sweep(head_dim):
    """Every position below 32768: equal to the JAX package's tables
    except the known entry."""
    pos = np.arange(32768)
    jc, js = (np.asarray(t) for t in JL.rope_tables_i8(jnp.asarray(pos), head_dim, 10000.0))
    tc, ts = (t.numpy() for t in TL.rope_tables_i8(pos, head_dim, 10000.0))
    assert np.array_equal(tc, jc)
    col = int(ROPE_KNOWN[1] * head_dim // 2)
    assert [tuple(d) for d in np.argwhere(ts != js)] == [(ROPE_KNOWN[0], col)]
    assert (js[ROPE_KNOWN[0], col], ts[ROPE_KNOWN[0], col]) == (63, 64)


def test_rope_and_isilu_equal_reference():
    rng = np.random.default_rng(16)
    x = rng.integers(-128, 128, (2, 4, 5, 32)).astype(np.int8)
    for positions in (np.arange(5), np.array([7]), np.array([[3], [9]])):
        jc, js = JL.rope_tables_i8(jnp.asarray(positions), 32, 10000.0)
        tc, ts = TL.rope_tables_i8(positions, 32, 10000.0)
        if positions.ndim == 2:
            jc, js, tc, ts = jc[:, None], js[:, None], tc[:, None], ts[:, None]
        want = JL.apply_rope_i8(jnp.asarray(x[:, :, :1] if positions.ndim == 2 else x), jc, js)
        got = TL.apply_rope_i8(torch.from_numpy(x[:, :, :1] if positions.ndim == 2 else x),
                               tc, ts)
        assert _equal(got, want)
    g = rng.integers(-128, 128, (64, 96)).astype(np.int8)
    for s_in in (0.05, 0.02, 0.3):
        assert _equal(TL.isilu_i8(torch.from_numpy(g), s_in, 0.05),
                      JL.isilu_i8(jnp.asarray(g), s_in, 0.05))


@pytest.mark.parametrize("m", [1, 8, 16, 17, 40])
def test_int_mm_padding_bookkeeping(m):
    """Fewer than 17 rows are padded to 32 for ``torch._int_mm`` and sliced
    back; a transposed weight (the tied head's ``table.T``) runs as the
    swapped product without a copy of the weight.  The product here is the
    CPU's int32 one, standing in for ``_int_mm``."""
    g = torch.Generator().manual_seed(m)
    a = torch.randint(-128, 128, (m, 64), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (64, 48), generator=g, dtype=torch.int8)
    table = torch.randint(-127, 128, (48, 64), generator=g, dtype=torch.int8)
    calls = []

    def mm(x, y):
        assert x.shape[0] > 16 and x.shape[1] % 8 == 0 and y.shape[1] % 8 == 0
        assert x.is_contiguous() and y.is_contiguous()
        calls.append((tuple(x.shape), tuple(y.shape), x.data_ptr()))
        return torch.matmul(x.int(), y.int())

    assert torch.equal(int_mm_padded(a, w, mm), torch.matmul(a.int(), w.int()))
    assert calls[-1][0] == (max(m, 32) if m <= 16 else m, 64)
    got = int_mm_padded(a, table.T, mm)
    assert got.is_contiguous() and torch.equal(got, torch.matmul(a.int(), table.T.int()))
    assert calls[-1][0] == (48, 64) and calls[-1][2] == table.data_ptr()
    assert calls[-1][1] == (64, max(8, -(-m // 8) * 8))
